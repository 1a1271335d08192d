"""The port's KV handoff (``paddle_tpu_torch/serving/kv_transfer.py``)
against the JAX package's, on the CPU.

- **Wire format.** The same K/V (numpy, from a seed) written into a JAX
  cache and into a port cache exports to the same frames: payload bytes,
  CRCs, shapes, dtype strings — the jsonable handoffs are equal but for
  ``transfer_id``. Slab and paged, float32 and bfloat16 (the port carries
  bf16 as its raw 2-byte words, which are the reference's ``ml_dtypes``
  bytes).
- **Both directions.** A JAX export, made jsonable, adopts into a port
  cache bitwise, and a port export into a JAX cache.
- **Refusals.** A fingerprint mismatch raises the reference's message,
  field for field.
- **Across the packages.** A JAX prefill engine's handoff, adopted by a
  port decode engine, continues with the JAX colocated engine's greedy
  tokens (exact), slab and paged.

Tolerances: none — every comparison here is exact (bytes, tokens).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.serving import kv_cache as JKC
from paddle_tpu.serving import kv_transfer as JKT
from paddle_tpu.serving import paged_kv as JPK
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.serving import kv_cache as TKC
from paddle_tpu_torch.serving import kv_transfer as TKT
from paddle_tpu_torch.serving import paged_kv as TPK

L, NH, HD, PAGE = 2, 2, 8, 4
GEOM = dict(num_layers=L, max_slots=3, max_seq=32, num_heads=NH,
            head_dim=HD)
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _caches(layout, dt):
    """(JAX cache, port cache) of one geometry."""
    jdt, tdt = _DT[dt]
    if layout == "paged":
        return (JPK.PagedKVCache(**GEOM, dtype=jdt, page_size=PAGE),
                TPK.PagedKVCache(**GEOM, dtype=tdt, page_size=PAGE,
                                 device="cpu"))
    return (JKC.KVCache(**GEOM, dtype=jdt),
            TKC.KVCache(**GEOM, dtype=tdt, device="cpu"))


def _as_torch(a: np.ndarray, tdt) -> torch.Tensor:
    """A JAX-side numpy array (``ml_dtypes`` bf16 included) as a torch
    tensor with the same bits."""
    if tdt == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _fill(jc, tc, layout, dt, length, seed):
    """Claim a slot of ``length`` in both caches and write the same seeded
    K/V into it (pages past the length included). Returns (jslot, tslot)."""
    jdt, tdt = _DT[dt]
    rng = np.random.default_rng(seed)
    jslot, tslot = jc.alloc(length), tc.alloc(length)
    if layout == "paged":
        n = jc.pages_for(length)
        shape = (L, n, PAGE, NH, HD)
        k, v = (np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
                for _ in range(2))
        jc.write_pages([int(p) for p in jc.table_row(jslot)[:n]], k, v)
        tc.write_pages([int(p) for p in tc.table_row(tslot)[:n]],
                       _as_torch(k, tdt), _as_torch(v, tdt))
    else:
        shape = (L, length, NH, HD)
        k, v = (np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
                for _ in range(2))
        jc.write_rows(jslot, 0, k, v)
        tc.write_rows(tslot, 0, _as_torch(k, tdt), _as_torch(v, tdt))
    return jslot, tslot


def _engine_of(cache):
    """What ``export_slot`` / ``adopt_into_engine`` read of an engine."""
    return types.SimpleNamespace(cache=cache, ecfg=None)


def _strip_id(h):
    return {k: v for k, v in h.items() if k != "transfer_id"}


def _contents(cache, slot, layout):
    """Float32 numpy K/V of ``slot``'s valid pages or rows."""
    n = cache.length(slot)
    if layout == "paged":
        pages = [int(p) for p in cache.table_row(slot)[:cache.pages_for(n)]]
        k, v = cache.read_pages(pages)
    else:
        k, v = cache.read_rows(slot, 0, n)
    to = (lambda a: a.float().numpy()) if isinstance(k, torch.Tensor) \
        else (lambda a: np.asarray(a).astype(np.float32))
    return to(k), to(v)


# paged, 21 tokens: 6 pages (the last partial), chunks of 4 + 2 pages;
# slab, 21 tokens: one chunk of the default 64 rows; slab, 30 tokens in
# chunks of 8 rows: 8 + 8 + 8 + 6
CASES = [(lay, dt, n, rows) for dt in ("f32", "bf16")
         for lay, n, rows in (("paged", 21, 64), ("slab", 21, 64),
                              ("slab", 30, 8))]


@pytest.mark.parametrize("layout,dt,length,rows", CASES,
                         ids=[f"{a}-{b}-{c}-{d}" for a, b, c, d in CASES])
def test_export_frames_equal_jax(layout, dt, length, rows):
    """The same K/V exports to byte-equal frames and an equal jsonable
    handoff (transfer_id aside) in both packages."""
    jc, tc = _caches(layout, dt)
    jslot, tslot = _fill(jc, tc, layout, dt, length, seed=length)
    toks = list(range(length))
    jh = JKT.export_slot(_engine_of(jc), jslot, tokens=toks,
                         chunk_rows=rows)
    th = TKT.export_slot(_engine_of(tc), tslot, tokens=toks,
                         chunk_rows=rows)
    assert len(th["chunks"]) == {21: 2 if layout == "paged" else 1,
                                 30: 4}[length]
    assert th["fingerprint"] == jh["fingerprint"]
    assert th["fingerprint"]["dtype"] == {"f32": "float32",
                                          "bf16": "bfloat16"}[dt]
    for jch, tch in zip(jh["chunks"], th["chunks"], strict=True):
        for jf, tf in zip(jch["shards"], tch["shards"], strict=True):
            assert tf["data"] == jf["data"]
            assert (tf["crc"], tf["shape"], tf["dtype"]) == \
                (jf["crc"], jf["shape"], jf["dtype"])
    assert _strip_id(TKT.handoff_to_jsonable(th)) == \
        _strip_id(JKT.handoff_to_jsonable(jh))
    # the residency meter's numbers are the reference's
    js, ts = JKT.last_stats("export"), TKT.last_stats("export")
    assert (ts.budget_bytes, ts.peak_bytes, ts.total_bytes, ts.chunks,
            ts.full_cache_bytes) == (js.budget_bytes, js.peak_bytes,
                                     js.total_bytes, js.chunks,
                                     js.full_cache_bytes)


@pytest.mark.parametrize("layout,dt", [(a, b) for a in ("slab", "paged")
                                       for b in ("f32", "bf16")])
def test_handoff_adopts_across_packages_bitwise(layout, dt):
    """A JAX export (jsonable, over JSON) adopts into a port cache bitwise,
    and a port export into a JAX cache; 21 tokens in chunks of 4 + 2 pages
    (paged) or of 8 + 8 + 5 rows (slab)."""
    import json

    length = 21
    jc, tc = _caches(layout, dt)
    jslot, tslot = _fill(jc, tc, layout, dt, length, seed=5)
    want = _contents(jc, jslot, layout)
    # JAX -> port
    jh = JKT.export_slot(_engine_of(jc), jslot, tokens=list(range(length)),
                         chunk_rows=8)
    wire = json.loads(json.dumps(JKT.handoff_to_jsonable(jh)))
    _, tc2 = _caches(layout, dt)
    s2 = TKT.adopt_into_engine(_engine_of(tc2),
                               TKT.handoff_from_jsonable(wire))
    assert tc2.length(s2) == length
    for got, exp in zip(_contents(tc2, s2, layout), want):
        np.testing.assert_array_equal(got, exp)
    # port -> JAX
    th = TKT.export_slot(_engine_of(tc), tslot, tokens=list(range(length)),
                         chunk_rows=8)
    wire = json.loads(json.dumps(TKT.handoff_to_jsonable(th)))
    jc2, _ = _caches(layout, dt)
    s3 = JKT.adopt_into_engine(_engine_of(jc2),
                               JKT.handoff_from_jsonable(wire))
    assert jc2.length(s3) == length
    for got, exp in zip(_contents(jc2, s3, layout), want):
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("other", [
    dict(page_size=8), dict(dtype="bf16"), dict(num_heads=4),
    dict(layout="slab")], ids=["page_size", "dtype", "num_heads", "layout"])
def test_fingerprint_mismatch_messages_equal_jax(other):
    """The receiver refuses a handoff of another geometry before it claims
    anything, with the reference's message (every differing field)."""
    def pair(page_size=PAGE, dtype="f32", num_heads=NH, layout="paged"):
        jdt, tdt = _DT[dtype]
        g = dict(GEOM, num_heads=num_heads)
        if layout == "slab":
            return (JKC.KVCache(**g, dtype=jdt),
                    TKC.KVCache(**g, dtype=tdt, device="cpu"))
        return (JPK.PagedKVCache(**g, dtype=jdt, page_size=page_size),
                TPK.PagedKVCache(**g, dtype=tdt, page_size=page_size,
                                 device="cpu"))

    jsrc, tsrc = pair(**other)
    jslot, tslot = jsrc.alloc(8), tsrc.alloc(8)
    jh = JKT.export_slot(_engine_of(jsrc), jslot)
    th = TKT.export_slot(_engine_of(tsrc), tslot)
    jdst, tdst = pair()
    assert TKT.fingerprint_mismatch(TKT.cache_fingerprint(tdst),
                                    th["fingerprint"]) == \
        JKT.fingerprint_mismatch(JKT.cache_fingerprint(jdst),
                                 jh["fingerprint"])
    with pytest.raises(JKT.CacheConfigMismatch) as je:
        JKT.adopt_into_engine(_engine_of(jdst), jh)
    with pytest.raises(TKT.CacheConfigMismatch) as te:
        TKT.adopt_into_engine(_engine_of(tdst), th)
    assert str(te.value) == str(je.value)
    assert tdst.free_slot_count() == GEOM["max_slots"]
    if hasattr(tdst, "free_page_count"):
        assert tdst.free_page_count() == tdst.num_pages - 1


def test_refusals_claim_nothing():
    """An uncommitted handoff, a flipped payload byte and a full slot table
    are refused; no slot or page stays claimed (the reference's order:
    fingerprint, commit flag, free slot, then CRC per chunk)."""
    jc, tc = _caches("paged", "f32")
    _, tslot = _fill(jc, tc, "paged", "f32", 21, seed=1)
    h = TKT.export_slot(_engine_of(tc), tslot)
    _, dst = _caches("paged", "f32")
    eng = _engine_of(dst)
    with pytest.raises(ValueError, match="never committed"):
        TKT.adopt_into_engine(eng, dict(h, committed=False))
    bad = TKT.handoff_from_jsonable(TKT.handoff_to_jsonable(h))
    f = bad["chunks"][1]["shards"][1]
    f["data"] = bytes([f["data"][0] ^ 0xFF]) + f["data"][1:]
    with pytest.raises(ValueError, match="CRC"):
        TKT.adopt_into_engine(eng, bad)
    assert dst.free_page_count() == dst.num_pages - 1
    for _ in range(GEOM["max_slots"]):
        dst.alloc(1)
    with pytest.raises(TS.CacheFullError):
        TKT.adopt_into_engine(eng, h)
    assert dst.free_page_count() == dst.num_pages - 1 - GEOM["max_slots"]


# ---------------------------------------------------------------------------
# engines: a JAX prefill hands off to a port decode engine
# ---------------------------------------------------------------------------
EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def tiny():
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(0), cfg_j)
    tp = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg_j, jp, cfg_t, tp


def _greedy_jax(engine, prompt, n):
    slot, logits = engine.start_sequence(prompt)
    toks = [int(np.argmax(logits))]
    for _ in range(n - 1):
        toks.append(int(np.argmax(engine.decode_step({slot: toks[-1]})[slot])))
    engine.free_sequence(slot)
    return toks


@pytest.mark.parametrize("layout_kw", [{}, {"kv_layout": "paged",
                                            "page_size": 8}],
                         ids=["slab", "paged"])
def test_jax_prefill_port_decode_greedy_parity(tiny, layout_kw):
    """A JAX prefill engine's handoff (through JSON) adopted by a port
    decode engine continues with the JAX colocated engine's greedy tokens,
    token for token."""
    import json

    cfg_j, jp, cfg_t, tp = tiny
    colo = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(**EKW, **layout_kw))
    pre = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(
        **EKW, role="prefill", **layout_kw))
    dec = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(
        **EKW, role="decode", **layout_kw), device="cpu")
    rng = np.random.RandomState(17)
    for plen in (5, 11, 16):
        prompt = rng.randint(0, cfg_j.vocab_size, size=plen).tolist()
        want = _greedy_jax(colo, prompt, 6)
        slot, logits = pre.start_sequence(prompt)
        h = pre.export_request_kv(slot, tokens=prompt)
        pre.free_sequence(slot)
        wire = json.loads(json.dumps(JKT.handoff_to_jsonable(h)))
        dslot = dec.adopt_request_kv(TKT.handoff_from_jsonable(wire))
        toks = [int(np.argmax(logits))]
        for _ in range(5):
            toks.append(int(np.argmax(dec.decode_step(
                {dslot: toks[-1]})[dslot])))
        dec.free_sequence(dslot)
        assert toks == want, (plen, toks, want)


def test_claim_adopt_and_prefix_adoption_step_for_step():
    """``claim_pages``, ``adopt_slot``, ``PrefixCache.adopt_nested`` and
    ``has`` against the JAX classes, op for op on one small pool: the
    pages handed out, the slots, the entries registered, the probes, and
    the free lists and refcounts after each op; ``free`` and a prefix
    reclaim give every page back."""
    kw = dict(num_layers=1, max_slots=2, max_seq=16, num_heads=1,
              head_dim=2, page_size=4, num_pages=9)
    pools = (JPK.PagedKVCache(**kw), TPK.PagedKVCache(**kw, device="cpu"))
    caches = (JPK.PrefixCache(pools[0]), TPK.PrefixCache(pools[1]))
    pools[0].reclaimer = caches[0].reclaim
    pools[1].reclaimer = caches[1]
    toks = list(range(100, 112))

    def drive(pool, cache, mod):
        log = []
        pages = pool.claim_pages(3)
        log.append(("claim", pages))
        log.append(("adopt_slot", pool.adopt_slot(10, pages),
                    pool.table_row(0).tolist()))
        with pytest.raises(ValueError):
            pool.adopt_slot(10, pages[:2])
        pre = pool.claim_pages(2)
        log.append(("has", cache.has(toks[:8])))
        log.append(("nested", cache.adopt_nested(toks[:8], pre)))
        log.append(("has", cache.has(toks[:8]), cache.has(toks[:4]),
                    cache.has(toks[:5])))
        log.append(("lookup", cache.lookup(toks[:9])))
        log.append(("nested again", cache.adopt_nested(toks[:8], pre)))
        with pytest.raises(mod.PagePoolFullError):
            pool.claim_pages(9)
        log.append(("state", pool.free_page_count(),
                    pool._ref.tolist()))
        pool.free(0)
        cache.clear()
        log.append(("after", pool.free_page_count(), pool._ref.tolist()))
        return log

    assert drive(pools[1], caches[1], TPK) == drive(pools[0], caches[0],
                                                   JPK)
    assert pools[1].free_page_count() == kw["num_pages"] - 1


def test_transfer_history_records_every_kind():
    """A handoff's export and adoption and a prefix record's export and
    adoption each leave their ``TransferStats`` in the history, in order
    and by kind, with the wire bytes they moved; ``summarize_stats`` counts
    them by kind; the handoff's bytes metric counts the handoff alone, as
    the reference's does (``m_pool_prefix`` counts the prefix records)."""
    from paddle_tpu_torch.serving import metrics as smetrics

    _, src = _caches("paged", "f32")
    _, dst = _caches("paged", "f32")
    tslot = _fill(_caches("paged", "f32")[0], src, "paged", "f32", 21,
                  seed=3)[1]
    out0 = smetrics.m_kv_transfer_bytes.labels("out").value
    in0 = smetrics.m_kv_transfer_bytes.labels("in").value
    TKT.transfer_history(clear=True)
    h = TKT.export_slot(_engine_of(src), tslot, tokens=list(range(21)))
    TKT.adopt_into_engine(_engine_of(dst), h)
    blob = TKT.export_prefix(src, list(range(21)), src.table_row(tslot))
    eng = types.SimpleNamespace(cache=dst, paged=True,
                                prefix=TPK.PrefixCache(dst))
    assert TKT.adopt_prefix(eng, blob) >= 1
    hist = TKT.transfer_history(clear=True)
    assert [s.kind for s in hist] == ["export", "adopt", "prefix_export",
                                      "prefix_adopt"]
    nbytes = 2 * 6 * L * PAGE * NH * HD * 4
    assert [s.total_bytes for s in hist] == [nbytes, nbytes,
                                             2 * 5 * L * PAGE * NH * HD * 4,
                                             2 * 5 * L * PAGE * NH * HD * 4]
    assert all(s.peak_bytes <= s.budget_bytes and s.elapsed_ms > 0
               for s in hist)
    assert TKT.transfer_history() == []
    summ = TKT.summarize_stats(hist)
    assert sorted(summ) == ["adopt", "export", "prefix_adopt",
                            "prefix_export"]
    assert all(v["n"] == 1 for v in summ.values())
    assert summ["export"]["bytes_mean"] == nbytes
    assert (smetrics.m_kv_transfer_bytes.labels("out").value - out0,
            smetrics.m_kv_transfer_bytes.labels("in").value - in0) == \
        (nbytes, nbytes)
