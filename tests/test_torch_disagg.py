"""The port's phase-disaggregated serving against the JAX package, on the
CPU: twins of the in-process tests of tests/test_disagg.py (the JSON and
socket channels with a CRC tamper, router greedy parity on both layouts,
the empty phase fleet, a mid-transfer fault, the shared prefix index, and
tp=2 -> tp=1 with a JAX tp=2 prefill engine on the conftest's 8-device CPU
mesh as the source; and the port's own tp=2 engine, two gloo ranks, in the
four directions between tp=2 and tp=1), the scheduler's handoff queue, the
``/prefill`` and ``/resume`` routes beside the JAX front door's, and the
four metric families' counts beside JAX's after the same traffic.

GPT_TINY at 2 layers, parameters from ``jax.random.PRNGKey(0)`` carried
across by ``models/gpt.params_from_numpy``, float32, ``device="cpu"``.
Tolerances: none — tokens, pages, codes and counts are compared exactly.
"""
import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.serving import disagg as JD
from paddle_tpu.serving import kv_transfer as JKT
from paddle_tpu.serving import metrics as JM
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.serving import kv_transfer as kvt
from paddle_tpu_torch.serving import metrics as TM
from paddle_tpu_torch.serving.disagg import (DisaggRouter, LocalReplica,
                                             SharedPrefixIndex)

EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16))
PAGED = {"kv_layout": "paged", "page_size": 8}
LAYOUTS = [pytest.param({}, id="slab"), pytest.param(PAGED, id="paged")]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(0), cfg_j)
    tp = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg_j, jp, cfg_t, tp


def make_engine(tiny, **kw):
    _, _, cfg_t, tp = tiny
    return TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**{**EKW, **kw}),
                           device="cpu")


def make_jax_engine(tiny, **kw):
    cfg_j, jp, _, _ = tiny
    return JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(**{**EKW, **kw}))


@pytest.fixture(scope="module")
def jax_colo(tiny):
    """The JAX colocated engines whose greedy tokens the router must emit."""
    return {"slab": make_jax_engine(tiny),
            "paged": make_jax_engine(tiny, **PAGED)}


def _greedy(engine, prompt, n):
    slot, logits = engine.start_sequence(prompt)
    toks = [int(np.argmax(logits))]
    for _ in range(n - 1):
        out = engine.decode_step({slot: toks[-1]})
        toks.append(int(np.argmax(out[slot])))
    engine.free_sequence(slot)
    return toks


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a).astype(np.float32)


def _stop_all(replicas):
    for r in replicas:
        r.stop()


# ---------------------------------------------------------------------------
# handoff channels
# ---------------------------------------------------------------------------

def test_handoff_jsonable_roundtrip_and_crc_tamper(tiny):
    """A handoff survives the JSON (base64) channel bit for bit — the
    adopted slot continues the source's greedy stream exactly — and a
    flipped payload byte is caught by the frame CRC, nothing adopted."""
    src = make_engine(tiny, role="prefill")
    dst = make_engine(tiny, role="decode")
    prompt = [3, 1, 4, 1, 5, 9]
    slot, logits = src.start_sequence(prompt)
    tok = int(np.argmax(logits))
    handoff = src.export_request_kv(slot, tokens=prompt)
    wire = json.dumps(kvt.handoff_to_jsonable(handoff))
    dslot = dst.adopt_request_kv(kvt.handoff_from_jsonable(json.loads(wire)))
    a_tok = b_tok = tok
    for _ in range(4):
        a_tok = int(np.argmax(src.decode_step({slot: a_tok})[slot]))
        b_tok = int(np.argmax(dst.decode_step({dslot: b_tok})[dslot]))
        assert a_tok == b_tok, "greedy diverged across the JSON channel"
    dst.free_sequence(dslot)
    bad = src.export_request_kv(slot, tokens=prompt)
    frame = bad["chunks"][0]["shards"][0]
    frame["data"] = bytes([frame["data"][0] ^ 0xFF]) + frame["data"][1:]
    free_before = dst.cache.free_slot_count()
    with pytest.raises(ValueError, match="CRC"):
        dst.adopt_request_kv(bad)
    assert dst.cache.free_slot_count() == free_before
    assert dst.poisoned is None
    src.free_sequence(slot)


def test_kv_socket_channel_roundtrip(tiny):
    """The frame-stream socket channel delivers a committed handoff exactly
    once; the adopted KV decodes as the source does. A JAX sender's stream
    lands on the port's server too."""
    src = make_engine(tiny, role="prefill", **PAGED)
    dst = make_engine(tiny, role="decode", **PAGED)
    server = kvt.KVTransferServer().start()
    try:
        prompt = [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]
        slot, logits = src.start_sequence(prompt)
        tok = int(np.argmax(logits))
        handoff = src.export_request_kv(slot, tokens=prompt)
        kvt.send_handoff(server.host, server.port, handoff)
        landed = server.pop(handoff["transfer_id"], timeout_s=10.0)
        assert landed["committed"] is True
        dslot = dst.adopt_request_kv(landed)
        a_tok = b_tok = tok
        for _ in range(4):
            a_tok = int(np.argmax(src.decode_step({slot: a_tok})[slot]))
            b_tok = int(np.argmax(dst.decode_step({dslot: b_tok})[dslot]))
            assert a_tok == b_tok, "greedy diverged across the socket"
        with pytest.raises(TimeoutError):
            server.pop(handoff["transfer_id"], timeout_s=0.2)
        dst.free_sequence(dslot)
        # the reference's sender, the port's receiver: the same frames
        JKT.send_handoff(server.host, server.port,
                         dict(handoff, transfer_id="from-jax"))
        landed = server.pop("from-jax", timeout_s=10.0)
        assert kvt.handoff_to_jsonable(landed)["chunks"] == \
            kvt.handoff_to_jsonable(handoff)["chunks"]
        src.free_sequence(slot)
    finally:
        server.close()


# ---------------------------------------------------------------------------
# router parity and the fallback matrix (in-process replicas)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_disagg_router_greedy_parity(tiny, jax_colo, layout_kw):
    """The router (prefill replica -> KV migration -> decode replica) emits
    the JAX colocated engine's greedy tokens exactly, on both layouts, and
    leaves no slot behind on either replica."""
    colo = jax_colo["paged" if layout_kw else "slab"]
    reps = [LocalReplica(make_engine(tiny, role="prefill", **layout_kw)),
            LocalReplica(make_engine(tiny, role="decode", **layout_kw))]
    router = DisaggRouter(reps)
    rng = np.random.RandomState(17)
    try:
        for _ in range(3):
            plen = int(rng.randint(3, 12))
            prompt = rng.randint(0, tiny[0].vocab_size, size=plen).tolist()
            want = _greedy(colo, prompt, 6)
            got = router.generate(prompt, max_new_tokens=6, timeout_s=60.0)
            assert got.state == "done", got.error
            assert got.migrated and got.fallback_reason is None
            assert got.tokens == want, \
                f"disagg tokens {got.tokens} != JAX colocated {want}"
        assert router.migrated == 3 and router.fallbacks == 0
        assert reps[0].engine.cache.occupancy == 0.0
        assert reps[1].engine.cache.occupancy == 0.0
    finally:
        _stop_all(reps)


def test_disagg_router_empty_phase_fleet_degrades(tiny, jax_colo):
    """No prefill/decode fleet -> colocated dispatch, the JAX engine's
    tokens, the reason counted: degrade, never drop."""
    reps = [LocalReplica(make_engine(tiny))]
    router = DisaggRouter(reps)
    prompt = [5, 3, 8, 1]
    try:
        want = _greedy(jax_colo["slab"], prompt, 5)
        got = router.generate(prompt, max_new_tokens=5, timeout_s=60.0)
        assert got.state == "done" and got.tokens == want
        assert not got.migrated
        assert got.fallback_reason == "no_phase_fleet"
        assert router.fallbacks == 1 and router.migrated == 0
    finally:
        _stop_all(reps)


def test_disagg_router_mid_transfer_fault_degrades(tiny, jax_colo):
    """The decode replica's KV adoption dies mid-transfer: the request
    degrades to a whole colocated re-dispatch with the JAX colocated tokens
    — no loss, no duplicate, no leaked slot."""
    pre = LocalReplica(make_engine(tiny, role="prefill"))
    dec = LocalReplica(make_engine(tiny, role="decode"))
    reps = [pre, dec]

    def broken_adopt(handoff):
        raise RuntimeError("injected mid-transfer fault")

    dec.engine.adopt_request_kv = broken_adopt
    router = DisaggRouter(reps)
    prompt = [9, 2, 6, 5, 3]
    try:
        want = _greedy(jax_colo["slab"], prompt, 6)
        got = router.generate(prompt, max_new_tokens=6, timeout_s=60.0)
        assert got.state == "done", got.error
        assert got.fallback_reason == "decode_failed"
        assert not got.migrated
        assert got.tokens == want and len(got.tokens) == 6
        assert router.fallbacks == 1
        time.sleep(0.1)
        assert pre.engine.cache.occupancy == 0.0
        assert dec.engine.cache.occupancy == 0.0
    finally:
        _stop_all(reps)


def test_shared_prefix_index_cross_replica_hit(tiny, jax_colo):
    """A system prompt prefilled on the prefill replica is published to the
    gang-shared index; the next request's fetch hits it (per-phase counts
    move) and the tokens stay the JAX colocated engine's."""
    index = SharedPrefixIndex()
    reps = [LocalReplica(make_engine(tiny, role="prefill", **PAGED),
                         prefix_index=index),
            LocalReplica(make_engine(tiny, role="decode", **PAGED),
                         prefix_index=index)]
    router = DisaggRouter(reps, prefix_index=index)
    system_prompt = [7] * 10 + [3, 5]          # 12 tokens -> 1 full page
    try:
        want = _greedy(jax_colo["paged"], system_prompt, 4)
        first = router.generate(system_prompt, max_new_tokens=4,
                                timeout_s=60.0)
        assert first.state == "done" and first.tokens == want
        assert index.published >= 1 and index.misses >= 1
        hits_before = index.hits
        second = router.generate(system_prompt, max_new_tokens=4,
                                 timeout_s=60.0)
        assert second.state == "done" and second.tokens == want
        assert index.hits > hits_before
        assert router.fallbacks == 0
    finally:
        _stop_all(reps)


def test_tp2_to_tp1_handoff_page_exact_bounded_residency(tiny):
    """A JAX tp=2 prefill engine (the 8-device CPU mesh) hands off to the
    port's tp=1 decode engine: two frames a projection a chunk on the wire,
    the adopted pages bitwise the source's canonical pages, and the port's
    transient host footprint within the chunk budget, far below the
    cache."""
    src = make_jax_engine(tiny, kv_layout="paged", page_size=8,
                          sharding="tp", tp=2, role="prefill")
    dst = make_engine(tiny, kv_layout="paged", page_size=8, role="decode")
    prompt = list(range(2, 14))                # 12 tokens -> 2 pages
    slot, logits = src.start_sequence(prompt)
    n_pages = src.cache.pages_for(len(prompt))
    src_pages = [int(p) for p in src.cache.table_row(slot)[:n_pages]]
    k_src, v_src = src.cache.read_pages(src_pages)
    handoff = src.export_request_kv(slot, tokens=prompt)
    for ch in handoff["chunks"]:
        ks = [f for f in ch["shards"] if f["proj"] == "k"]
        assert sorted(f["shard"] for f in ks) == [0, 1]
        assert all(f["nshards"] == 2 for f in ch["shards"])
    dslot = dst.adopt_request_kv(handoff)
    adp = kvt.last_stats("adopt")
    assert adp.peak_bytes <= adp.budget_bytes < adp.full_cache_bytes, \
        (adp.peak_bytes, adp.budget_bytes, adp.full_cache_bytes)
    assert dst.cache.length(dslot) == len(prompt)
    dst_pages = [int(p) for p in dst.cache.table_row(dslot)[:n_pages]]
    k_dst, v_dst = dst.cache.read_pages(dst_pages)
    np.testing.assert_array_equal(_f32(k_dst), _f32(k_src))
    np.testing.assert_array_equal(_f32(v_dst), _f32(v_src))
    out = dst.decode_step({dslot: int(np.argmax(logits))})
    assert 0 <= int(np.argmax(out[dslot])) < tiny[0].vocab_size
    src.free_sequence(slot)
    dst.free_sequence(dslot)


# the four directions of a handoff between tp=2 and tp=1, either package:
# (source, destination), each "port" or "jax" and its tp
TP_HANDOFFS = [pytest.param(("port", 2), ("port", 1), id="port2-port1"),
               pytest.param(("port", 2), ("jax", 1), id="port2-jax1"),
               pytest.param(("jax", 2), ("port", 2), id="jax2-port2"),
               pytest.param(("port", 1), ("port", 2), id="port1-port2")]


@pytest.fixture(scope="module")
def port_tp2(tiny):
    """The port's tp=2 paged engine: two gloo ranks on the CPU."""
    _, _, cfg_t, tp = tiny
    eng = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(
        sharding="tp", tp=2, **{**EKW, **PAGED}), device="cpu")
    yield eng
    eng.close()


@pytest.mark.parametrize("src_kind,dst_kind", TP_HANDOFFS)
def test_tp_handoff_pages_bitwise_every_direction(tiny, port_tp2, src_kind,
                                                  dst_kind):
    """A paged handoff between tp=2 and tp=1 engines, the port's and the
    JAX package's: one frame a rank a projection a chunk (rank r's heads
    are shard r), the adopted pages bitwise the source's canonical
    pages, the adoption's host copies within the chunk budget, and the
    adopted slot decodes on as the source does."""
    def build(kind, tp):
        if kind == "port" and tp == 2:
            return port_tp2
        mk = make_engine if kind == "port" else make_jax_engine
        extra = {"sharding": "tp", "tp": 2} if tp == 2 else {}
        return mk(tiny, **PAGED, **extra)

    src, dst = build(*src_kind), build(*dst_kind)
    prompt = list(range(2, 15))                # 13 tokens -> 2 pages
    slot, logits = src.start_sequence(prompt)
    n_pages = src.cache.pages_for(len(prompt))
    k_src, v_src = src.cache.read_pages(
        [int(p) for p in src.cache.table_row(slot)[:n_pages]])
    handoff = src.export_request_kv(slot, tokens=prompt)
    nsh = src_kind[1]
    for ch in handoff["chunks"]:
        for proj in ("k", "v"):
            fr = [f for f in ch["shards"] if f["proj"] == proj]
            assert sorted(f["shard"] for f in fr) == list(range(nsh))
            assert all(f["nshards"] == nsh for f in fr)
    dslot = dst.adopt_request_kv(handoff)
    adp = (kvt if dst_kind[0] == "port" else JKT).last_stats("adopt")
    assert adp.peak_bytes <= adp.budget_bytes < adp.full_cache_bytes
    assert dst.cache.length(dslot) == len(prompt)
    k_dst, v_dst = dst.cache.read_pages(
        [int(p) for p in dst.cache.table_row(dslot)[:n_pages]])
    np.testing.assert_array_equal(_f32(k_dst), _f32(k_src))
    np.testing.assert_array_equal(_f32(v_dst), _f32(v_src))
    a = b = int(np.argmax(logits))
    for _ in range(4):
        a = int(np.argmax(src.decode_step({slot: a})[slot]))
        b = int(np.argmax(dst.decode_step({dslot: b})[dslot]))
        assert a == b
    src.free_sequence(slot)
    dst.free_sequence(dslot)


# ---------------------------------------------------------------------------
# the scheduler's handoff queue, beside the JAX scheduler's
# ---------------------------------------------------------------------------

def _drive_handoff_queue(sched, engine, handoff, first, mod):
    """The same handoff traffic on one scheduler; returns what happened."""
    log = []
    reqs = [sched.submit_handoff(handoff, first, max_new_tokens=4,
                                 timeout_s=600.0) for _ in range(2)]
    try:
        sched.submit_handoff(handoff, first, timeout_s=600.0)
    except mod.QueueFullError as e:
        log.append(("queue_full", str(e)))
    log.append(("pending", sched.pending()))
    log.append(("aborted", sched.abort_all("shutting down")))
    log.append([(r.state, r.error, r.tokens) for r in reqs])
    log.append(("pending", sched.pending()))
    # fresh scheduler state for the deadline: a zero timeout expires at
    # the next tick, before adoption
    late = sched.submit_handoff(handoff, first, timeout_s=0.0)
    time.sleep(0.01)
    sched.step()
    log.append((late.state, late.error, engine.cache.free_slot_count()))
    # no free slot: the handoff waits (retried every tick), then adopts
    held = [engine.cache.alloc(1) for _ in range(EKW["max_batch"])]
    req = sched.submit_handoff(handoff, first, max_new_tokens=4,
                               timeout_s=600.0)
    sched.step()
    sched.step()
    log.append((req.state, sched.pending()))
    for s in held:
        engine.cache.free(s)
    for _ in range(10):
        if not sched.pending():
            break
        sched.step()
    log.append((req.state, req.tokens, engine.cache.free_slot_count()))
    return log


@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_handoff_queue_cap_deadline_abort_match_jax(tiny, layout_kw):
    """One JAX-made handoff offered to a JAX and a port decode scheduler
    (max_queue 2): the queue cap's QueueFullError, ``pending``,
    ``abort_all`` draining the pending handoffs, expiry before adoption,
    the retry while no slot is free, and the tokens, all equal."""
    src = make_jax_engine(tiny, role="prefill", **layout_kw)
    prompt = [4, 8, 15, 16, 23, 42, 7, 1, 9, 3]
    slot, logits = src.start_sequence(prompt)
    handoff = src.export_request_kv(slot, tokens=prompt)
    src.free_sequence(slot)
    first = int(np.argmax(logits))
    jeng = make_jax_engine(tiny, role="decode", **layout_kw)
    teng = make_engine(tiny, role="decode", **layout_kw)
    jlog = _drive_handoff_queue(
        JS.Scheduler(jeng, JS.SchedulerConfig(max_queue=2)), jeng, handoff,
        first, JS)
    tlog = _drive_handoff_queue(
        TS.Scheduler(teng, TS.SchedulerConfig(max_queue=2), device="cpu"),
        teng, handoff, first, TS)
    assert tlog == jlog
    assert jlog[0][0] == "queue_full" and jlog[-1][0] == "done"


# ---------------------------------------------------------------------------
# /prefill and /resume, beside the JAX front door
# ---------------------------------------------------------------------------

def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _phase_traffic(pre_port, dec_port, kv_port, prompt):
    """One traffic over a prefill front and a decode front (with a transfer
    server on ``kv_port``); every answer with its timing fields dropped
    and the handoff reduced to its structure."""
    def shape(code, body):
        body = {k: v for k, v in body.items()
                if k not in ("ttft_ms", "tpot_ms", "transfer_id")}
        if "kv" in body:
            kv = body["kv"]
            body["kv"] = dict(
                {k: kv[k] for k in ("version", "fingerprint", "length",
                                    "tokens", "committed")},
                chunks=[(c["index"], c["n"], c.get("start"),
                         [(f["proj"], f["shard"], f["nshards"],
                           f["shape"], f["dtype"]) for f in c["shards"]])
                        for c in kv["chunks"]])
        if "error" in body:
            body["error"] = body["error"].split(":")[0]
        return code, body

    out = []
    code, inline = _post(pre_port, "/prefill",
                         {"prompt": prompt, "max_new_tokens": 5})
    out.append(shape(code, inline))
    out.append(shape(*_post(dec_port, "/resume", {
        "kv": inline["kv"], "first_token": inline["first_token"],
        "prompt": prompt, "max_new_tokens": 5})))
    target = {"host": "127.0.0.1", "port": kv_port, "transfer_id": "x-1"}
    out.append(shape(*_post(pre_port, "/prefill", {
        "prompt": prompt, "max_new_tokens": 5, "kv_target": target})))
    out.append(shape(*_post(dec_port, "/resume", {
        "transfer_id": "x-1", "first_token": inline["first_token"],
        "prompt": prompt, "max_new_tokens": 5})))
    # a dead target: 502 with the first token
    out.append(shape(*_post(pre_port, "/prefill", {
        "prompt": prompt, "kv_target": {"host": "127.0.0.1", "port": 9}})))
    out.append(shape(*_post(pre_port, "/prefill", {"prompt": []})))
    out.append(shape(*_post(dec_port, "/resume", {"kv": inline["kv"]})))
    out.append(shape(*_post(dec_port, "/resume", {"first_token": 1})))
    out.append(shape(*_post(dec_port, "/resume", {
        "transfer_id": "never", "first_token": 1, "timeout_s": 0.3})))
    out.append(shape(*_post(pre_port, "/resume", {
        "transfer_id": "x-2", "first_token": 1})))
    return out


@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_prefill_resume_routes_match_jax_front_door(tiny, layout_kw):
    """The same traffic to JAX's and the port's prefill and decode front
    doors: inline and socket handoffs, a dead KV target (502), and the
    malformed requests give equal codes, tokens and bodies (timing fields
    aside; the handoff compared by its structure, the error by its
    first clause)."""
    prompt = [11, 22, 33, 44, 55, 66, 77, 88, 99, 5]
    results = []
    for mod, mk in ((JS, make_jax_engine), (TS, make_engine)):
        server = (JKT if mod is JS else kvt).KVTransferServer().start()
        kw = {} if mod is JS else {"device": "cpu"}
        fronts = [mod.FrontDoor(mod.Scheduler(
            mk(tiny, role=role, **layout_kw), **kw),
            kv_server=server if role == "decode" else None).start()
            for role in ("prefill", "decode")]
        try:
            results.append(_phase_traffic(fronts[0].port, fronts[1].port,
                                          server.port, prompt))
        finally:
            for f in fronts:
                f.stop()
            server.close()
    jres, tres = results
    assert [c for c, _ in tres] == [200, 200, 200, 200, 502, 400, 400,
                                    400, 504, 400]
    assert tres == jres


# ---------------------------------------------------------------------------
# the four metric families, beside JAX's
# ---------------------------------------------------------------------------

def _family_counts(m):
    return {
        "bytes": {d: m.m_kv_transfer_bytes.labels(d).value
                  for d in ("out", "in")},
        "ms": m.m_kv_transfer_ms._unlabeled().count,
        "prefix": {(e, p): m.m_pool_prefix.labels(e, p).value
                   for e in ("publish", "hit", "miss")
                   for p in ("prefill", "decode", "colocated")},
        "fallback": {r: m.m_disagg_fallback.labels(r).value
                     for r in ("no_phase_fleet", "prefill_refused",
                               "prefill_failed", "handoff_refused",
                               "decode_failed")},
    }


def _delta(after, before):
    if isinstance(after, dict):
        return {k: _delta(after[k], before[k]) for k in after}
    return after - before


def _router_traffic(pkg, tiny, mk):
    """Migrations behind a shared prefix, then each fallback reason once;
    returns the token streams and states."""
    d = JD if pkg is JS else __import__(
        "paddle_tpu_torch.serving.disagg", fromlist=["x"])
    index = d.SharedPrefixIndex()
    reps = [d.LocalReplica(mk(tiny, role="prefill", **PAGED),
                           prefix_index=index),
            d.LocalReplica(mk(tiny, role="decode", **PAGED),
                           prefix_index=index)]
    router = d.DisaggRouter(reps, prefix_index=index)
    colo = [d.LocalReplica(mk(tiny, **PAGED))]
    out = []
    try:
        system = [7] * 8                       # one full page
        for tail in ([1, 2], [3], [4, 5, 6]):
            r = router.generate(system + tail, max_new_tokens=4,
                                timeout_s=60.0)
            out.append((r.state, r.tokens, r.migrated, r.fallback_reason))
        # no_phase_fleet
        r = d.DisaggRouter(colo).generate([1, 2, 3], max_new_tokens=3,
                                          timeout_s=60.0)
        out.append((r.state, r.tokens, r.fallback_reason))
        # prefill_refused: above the ladder, refused on every fleet
        r = router.generate(list(range(20)), max_new_tokens=3,
                            timeout_s=60.0)
        out.append((r.state, r.fallback_reason))
        # prefill_failed: the export dies
        pre = reps[0].engine
        real_export = pre.export_request_kv

        def broken_export(slot, tokens=None):
            raise RuntimeError("injected export fault")

        pre.export_request_kv = broken_export
        r = router.generate([9, 9, 9], max_new_tokens=3, timeout_s=60.0)
        out.append((r.state, r.tokens, r.fallback_reason))
        pre.export_request_kv = real_export
        # handoff_refused: the decode scheduler refuses the handoff (the
        # whole request then runs on the decode replica)
        dsched = reps[1].scheduler

        def refuse_handoff(*a, **kw):
            raise RuntimeError("injected handoff refusal")

        dsched.submit_handoff = refuse_handoff
        r = router.generate([8, 8, 8], max_new_tokens=3, timeout_s=60.0)
        out.append((r.state, r.tokens, r.fallback_reason))
        del dsched.submit_handoff
        # decode_failed: the adoption dies
        dec = reps[1].engine
        real_adopt = dec.adopt_request_kv

        def broken_adopt(handoff):
            raise RuntimeError("injected adopt fault")

        dec.adopt_request_kv = broken_adopt
        r = router.generate([6, 6, 6], max_new_tokens=3, timeout_s=60.0)
        out.append((r.state, r.tokens, r.fallback_reason))
        dec.adopt_request_kv = real_adopt
        out.append((router.migrated, router.fallbacks, index.published,
                    index.hits, index.misses))
    finally:
        _stop_all(reps + colo)
    return out


def test_metric_families_count_as_jax(tiny):
    """The same router traffic — three migrations behind a shared 8-token
    prefix, then each of the five fallback reasons once — on both packages:
    equal tokens and outcomes, and equal increments of
    ``paddle_kv_transfer_bytes_total{direction}``, the count of
    ``paddle_kv_transfer_ms``, ``paddle_serve_pool_prefix_cache_total
    {event,phase}`` and ``paddle_serve_disagg_fallback_total{reason}``."""
    outs, deltas = [], []
    for pkg, mk, m in ((JS, make_jax_engine, JM), (TS, make_engine, TM)):
        before = _family_counts(m)
        outs.append(_router_traffic(pkg, tiny, mk))
        deltas.append(_delta(_family_counts(m), before))
    assert outs[1] == outs[0]
    assert deltas[1] == deltas[0]
    fb = deltas[1]["fallback"]
    assert all(v == 1 for v in fb.values()), (fb, outs[1])
    # every export was adopted but the handoff_refused and decode_failed
    # ones: 3-token prompts, one page of K and V each
    cfg = tiny[2]
    page_bytes = 2 * cfg.num_layers * 8 * cfg.num_heads * cfg.head_dim * 4
    assert (deltas[1]["bytes"]["out"] - deltas[1]["bytes"]["in"]
            == 2 * page_bytes)
    assert [o[2] for o in outs[1][:3]] == [True] * 3      # migrated


def test_serve_bench_disagg_lane_on_cpu(capsys):
    """``tools/serve_bench.py --disagg --tiny --device cpu``: both
    topologies serve the mixed trace, the greedy tokens agree, every
    request migrates (the 4 parity requests, the 8 of the trace, the 3 of
    the prefix exercise), the handoff meter saw each export and adoption,
    and the prefix index hits twice on its shared 16-token prefix."""
    from paddle_tpu_torch.tools import serve_bench

    rc = serve_bench.main(["--disagg", "--tiny", "--device", "cpu",
                           "--disagg-requests", "8",
                           "--disagg-max-new", "8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lane = out["disagg"]
    assert rc == 0 and lane["greedy_tokens_match"]
    assert lane["colocated"]["failed"] == lane["disagg"]["failed"] == 0
    dis = lane["disagg"]
    assert (dis["migrated"], dis["fallbacks"]) == (15, 0)
    assert dis["handoff_stats"]["export"]["n"] == 15
    assert dis["handoff_stats"]["adopt"]["n"] == 15
    assert dis["pool_prefix"] == {"hits": 2, "misses": 1, "published": 1}
    assert out["device"] == {"type": "cpu", "kind": "cpu",
                             "nvidia_smi": None}
