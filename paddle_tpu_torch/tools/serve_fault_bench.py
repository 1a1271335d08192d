"""Serving fault-injection harness — the port of
``tools/serve_fault_bench.py``: replicas are killed, hung and poisoned
UNDER LOAD, and the gang (``serving/gang.py``) must keep every client
whole — no lost and no doubled answer, a warm prefix cache across
restarts.

    python -m paddle_tpu_torch.tools.serve_fault_bench [--out PATH]
    python -m paddle_tpu_torch.tools.serve_fault_bench --smoke --device cpu \\
        [--out PATH] [--only a,b]

The card is the default (it raises without one): GPT_SMALL at full width
and depth, bf16 weights from seed 0, the paged engine of ``chip_smoke.py``
phase 4b (page 16, 513 pages, 8 slots, max_seq 1024, buckets 64-512), two
replica processes sharing the card, phase 4b's 16 prompts with 64 greedy
tokens each. ``--smoke --device cpu`` is the CPU lane: the reference's
tiny model and its starred pair. ``--only`` picks scenarios on either
lane; ``--smoke`` and ``--device cpu`` go together or not at all.

Scenarios:

  replica_sigkill  * a 2-replica gang under 16 concurrent requests through
                     the ``GangFrontDoor``; the busiest replica is
                     SIGKILLed mid-decode. Every request is answered 200 on
                     a sibling (the failover prefills again), an
                     idempotent retry returns the recorded answer under the
                     ORIGINAL trace id, the killed incarnation's spans
                     survive and stitch with no orphan, and the gang
                     recycles the replica with cause crash.
  engine_poisoned  * one replica poisons itself after 2 requests (a
                     stand-in for a call failing on the card after writing
                     its caches in place): its loop fails fast, it exits 44
                     and the gang recycles it with cause poisoned while the
                     sibling serves. No request is lost or doubled.
  engine_hang        one replica's engine loop wedges after 2 requests; its
                     watchdog (the PADDLE_HEALTH_* env the gang exports)
                     exits 43 within the deadline, the gang recycles with
                     cause hang, and the in-flight requests fail over.
  overload_storm     page-pool exhaustion and queue pressure on one
                     in-process engine: preemption, deadline-aware shedding
                     with Retry-After, no deadlock, completed requests
                     inside their deadline.
  warm_restart_prefix  one replica with a persistent prefix store: after a
                     SIGKILL and the gang's recycle it restores its records
                     and a repeated system prompt prefills its suffix only,
                     read off the replica's own
                     ``paddle_serve_prefill_tokens_total``.
  disagg_gang        a phased gang, 1 prefill + 1 decode replica: the 16
                     requests migrate at their first token over the decode
                     replica's KV socket, with no fallback, and the KV
                     bytes out of the prefill replica equal the bytes into
                     the decode replica and the pages' bytes.

Greedy tokens are held against one in-process engine with the same
weights (exactly on the CPU lane; on the card the agreement is reported:
bf16 and a prefill in another bucket shape can part). On the card each
surviving replica's heartbeat must show exactly fused_ln 2L, decode_paged
L and logits_head 1 launches a decode tick since its warmup; each
replica's start-up (import, weights, engine, restore, warmup, ready),
restart downtime, failover latency and TTFT / TPOT percentiles are
recorded. The harness writes its JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import signal
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

SMOKE = ("replica_sigkill", "engine_poisoned")

# the reference's tiny model (every replica and the in-process engine
# build the same weights from the seed) and its engine
TINY_MODEL = {"d_model": 32, "num_layers": 1, "num_heads": 2, "d_ff": 64,
              "vocab_size": 128, "max_seq_len": 64, "seed": 5,
              "dtype": "float32"}
TINY_ENGINE = {"max_batch": 4, "max_seq": 32, "prefill_buckets": [8, 16],
               "kv_layout": "paged", "page_size": 8, "weight_dtype": "f32"}
# GPT_SMALL at full width and depth, and phase 4b's paged engine
SMALL_MODEL = {"d_model": 768, "num_layers": 12, "num_heads": 12,
               "d_ff": 3072, "vocab_size": 50304, "max_seq_len": 1024,
               "seed": 0, "dtype": "bfloat16"}
SMALL_ENGINE = {"max_batch": 8, "max_seq": 1024,
                "prefill_buckets": [64, 128, 256, 512], "kv_layout": "paged",
                "page_size": 16, "weight_dtype": "bf16",
                "fused_decode": True}


def _log(msg):
    print(f"[serve_fault_bench] {msg}", file=sys.stderr, flush=True)


def paged_prompts(V: int):
    """Phase 4b's 16 prompts in their seeded order: 8 behind one 256-token
    system prompt (tails of 16-144 tokens), 8 unique (16-400 tokens)."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, V, size=256).tolist()
    shared = [system + rng.integers(0, V, size=int(n)).tolist()
              for n in rng.integers(16, 145, size=8)]
    unique = [rng.integers(0, V, size=int(n)).tolist()
              for n in rng.integers(16, 401, size=8)]
    return system, [(shared + unique)[i] for i in rng.permutation(16)]


class Lane:
    """What differs between the card and the CPU: the model, the engine,
    the traffic and the deadlines."""

    def __init__(self, device: str):
        from paddle_tpu_torch.device import resolve_device

        self.dev = resolve_device(device)
        self.cuda = self.dev.type == "cuda"
        self.device = str(self.dev) if self.cuda else "cpu"
        if self.cuda:
            self.model, self.engine = dict(SMALL_MODEL), dict(SMALL_ENGINE)
            # a replica's start-up is seconds of imports and warmup; the
            # watchdog's deadline sits well above a decode tick
            self.hang_deadline_s, self.ready_timeout_s = 10.0, 300.0
            self.max_new, self.workers = 64, 16
        else:
            self.model, self.engine = dict(TINY_MODEL), dict(TINY_ENGINE)
            self.hang_deadline_s, self.ready_timeout_s = 4.0, 300.0
            self.max_new, self.workers = 24, 4
        self.ref = None
        self._ref_tokens = {}

    def worker_config(self, **over):
        cfg = {"model": dict(self.model), "engine": dict(self.engine),
               "device": self.device,
               "scheduler": {"max_queue": 64, "default_timeout_s": 120.0},
               "request_timeout_s": 120.0}
        cfg.update(over)
        return cfg

    def gpt_config(self):
        import torch

        from paddle_tpu_torch.models import gpt

        m = self.model
        return gpt.GPTConfig(
            vocab_size=m["vocab_size"], max_seq_len=m["max_seq_len"],
            num_layers=m["num_layers"], num_heads=m["num_heads"],
            d_model=m["d_model"], d_ff=m["d_ff"],
            dtype=getattr(torch, m["dtype"]), remat=False)

    def reference_engine(self, **engine_over):
        """One in-process engine with the replicas' weights."""
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.models import gpt

        cfg = self.gpt_config()
        params = gpt.init_params(cfg, seed=self.model["seed"],
                                 device=self.dev)
        ekw = dict(self.engine, **engine_over)
        ekw["prefill_buckets"] = tuple(ekw["prefill_buckets"])
        engine = serving.DecodeEngine(params, cfg,
                                      serving.EngineConfig(**ekw),
                                      device=self.dev)
        del params
        engine.drop_reference_params()
        engine.warmup()
        return engine

    def reference_tokens(self, prompt, n):
        """The in-process engine's greedy tokens (each prompt once: the
        card's scenarios share phase 4b's prompts)."""
        key = (tuple(prompt), n)
        if key not in self._ref_tokens:
            if self.ref is None:
                self.ref = self.reference_engine()
            eng = self.ref
            slot, logits = eng.start_sequence(list(prompt))
            toks = [int(np.argmax(logits))]
            for _ in range(n - 1):
                out = eng.decode_step({slot: toks[-1]})
                toks.append(int(np.argmax(out[slot])))
            eng.free_sequence(slot)
            self._ref_tokens[key] = toks
        return list(self._ref_tokens[key])

    def prompts(self, seed, n, lo, hi):
        """The CPU lane's seeded prompts; the card serves phase 4b's."""
        if self.cuda:
            return paged_prompts(self.model["vocab_size"])[1]
        rng = np.random.RandomState(seed)
        return [rng.randint(0, self.model["vocab_size"],
                            size=int(rng.randint(lo, hi))).tolist()
                for _ in range(n)]

    def tick_want(self, ticks):
        """The launches ``ticks`` decode ticks imply (none on the CPU)."""
        from paddle_tpu_torch.ops import cuda_kernels as CK

        want = dict.fromkeys(CK.LAUNCHES, 0)
        if self.cuda:
            L = self.model["num_layers"]
            want.update({"fused_ln": 2 * L * ticks,
                         "decode_paged": L * ticks, "logits_head": ticks})
        return want


def _post(port, body, timeout=300.0, path="/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except ValueError:
            return e.code, {"error": f"HTTP {e.code}"}


def _replica_counter(handle, name, labels=None):
    """One counter off a replica's own /metrics (summed over its series, or
    the series whose label text contains ``labels``)."""
    total = 0.0
    for line in handle.get_text("/metrics").splitlines():
        m = re.match(rf"{name}(\{{[^}}]*\}})?\s+([0-9.eE+-]+)$", line)
        if m and (labels is None or labels in (m.group(1) or "")):
            total += float(m.group(2))
    return total


def _pct(vals, q):
    vals = [v for v in vals if v is not None]
    return float(np.percentile(vals, q)) if vals else None


def _gang(lane, work, name, n_replicas=2, per_replica=None,
          prefix_store=False, **cfg_over):
    from paddle_tpu_torch.serving.gang import GangConfig, ReplicaGang

    kw = dict(n_replicas=n_replicas, hang_deadline_s=lane.hang_deadline_s,
              probe_interval_s=0.25, ready_timeout_s=lane.ready_timeout_s,
              default_timeout_s=120.0)
    kw.update(cfg_over)
    return ReplicaGang(lane.worker_config(), os.path.join(work, name),
                       GangConfig(**kw), prefix_store=prefix_store,
                       per_replica=per_replica)


@contextlib.contextmanager
def _serving(gang):
    """``gang`` (started) once ready, behind its front door, with this
    process's span sink in its trace dir; stopped on the way out."""
    from paddle_tpu_torch.observability import spans
    from paddle_tpu_torch.serving.gang import GangFrontDoor

    front = None
    try:
        gang.wait_ready()
        spans.attach_process_sink(gang.trace_dir, "gang")
        front = GangFrontDoor(gang).start()
        yield front
    finally:
        if front is not None:
            front.stop()
        gang.stop()


def _stream(port, prompts, max_new, prefix, workers):
    """Fire ``prompts`` concurrently at the gang's front door; {request_id:
    (code, payload, wall time answered)}, one entry an id."""
    results = {}

    def one(i, prompt):
        rid = f"{prefix}-{i}"
        t0 = time.time()
        code, payload = _post(port, {
            "prompt": prompt, "max_new_tokens": max_new,
            "request_id": rid, "timeout_s": 120.0})
        return rid, code, payload, t0, time.time()

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for f in [ex.submit(one, i, p) for i, p in enumerate(prompts)]:
            rid, code, payload, t0, t1 = f.result()
            results[rid] = (code, payload, t0, t1)
    return results


def _check_stream(lane, results, expected, n_sent):
    """Zero lost, zero doubled, no non-200; tokens against the in-process
    engine (a gate on the CPU lane, reported on the card)."""
    lost = n_sent - len(results)
    bad_codes = {rid: r[0] for rid, r in results.items() if r[0] != 200}
    answered = [r[1] for r in results.values() if r[0] == 200]
    wrong = {rid: r[1].get("tokens") for rid, r in results.items()
             if r[0] == 200 and r[1].get("tokens") != expected.get(rid)}
    same_tok = sum(a == b for rid, r in results.items() if r[0] == 200
                   for a, b in zip(r[1]["tokens"], expected[rid]))
    ok = lost == 0 and not bad_codes and (lane.cuda or not wrong)
    return {"sent": n_sent, "answered": len(results),
            "lost_responses": lost,
            "duplicated_responses": sum(
                bool(p.get("deduplicated")) for p in answered),
            "non_200": bad_codes,
            "wrong_tokens": {} if lane.cuda else wrong,
            "streams_equal_reference": n_sent - len(wrong),
            "tokens_equal_reference": same_tok,
            "tokens_total": sum(len(t) for t in expected.values()),
            "ttft_ms_p50": _pct([p.get("ttft_ms") for p in answered], 50),
            "ttft_ms_p99": _pct([p.get("ttft_ms") for p in answered], 99),
            "tpot_ms_p50": _pct([p.get("tpot_ms") for p in answered], 50),
            "tpot_ms_p99": _pct([p.get("tpot_ms") for p in answered], 99),
            "ok": ok}


def _wait(cond, timeout_s, step=0.1):
    end = time.time() + timeout_s
    while time.time() < end:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _startup(r):
    """The incarnation's start-up split, in seconds: interpreter and
    imports, weights, engine, prefix-store restore, warmup, ready."""
    st = r.ready_record.get("startup") or {}
    if not st or r.spawned_at is None:
        return None
    marks = [("import", "t_import"), ("weights", "t_weights"),
             ("engine", "t_engine"), ("restore", "t_restore"),
             ("warmup", "t_warmup"), ("ready", "t_ready")]
    out, prev = {}, r.spawned_at
    for name, key in marks:
        out[name] = round(st[key] - prev, 3)
        prev = st[key]
    out["total"] = round(st["t_ready"] - r.spawned_at, 3)
    return out


def _survivors(lane, gang, t_end):
    """Each live incarnation's heartbeat after ``t_end`` (its launches and
    decode ticks since warmup), and whether the launches are exactly what
    its ticks imply."""
    out = []
    for r in gang.replicas:
        if not r.alive:
            continue
        _wait(lambda: (r.heartbeat() or {}).get("ts", 0) > t_end
              and "launches" in (r.heartbeat() or {}), 10.0, 0.05)
        hb = r.heartbeat() or {}
        ticks = int(hb.get("decode_ticks", 0))
        launches = hb.get("launches") or {}
        out.append({"index": r.index, "role": r.role,
                    "incarnation": r.incarnation, "decode_ticks": ticks,
                    "launches": launches,
                    "launches_exact": launches == lane.tick_want(ticks),
                    "prefix_publish_ms": hb.get("prefix_publish_ms", [])})
    return out


def _launch_sum(survivors):
    total = {}
    for s in survivors:
        for k, v in s["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

def scenario_replica_sigkill(lane, gang):
    from paddle_tpu_torch.tools import trace_assemble

    n_req, max_new = 16, lane.max_new
    prompts = lane.prompts(11, n_req, 3, 9)
    expected = {f"sk-{i}": lane.reference_tokens(p, max_new)
                for i, p in enumerate(prompts)}
    with _serving(gang) as front:
        startup = [_startup(r) for r in gang.replicas]
        killed = {}

        def killer():
            # SIGKILL a replica the moment it is seen mid-decode: a
            # request in its hands and a token generated, so its span file
            # holds flushed records that must survive the kill
            end = time.time() + 120
            while time.time() < end:
                busy = max(gang.replicas, key=lambda r: r.inflight)
                if busy.inflight >= 1 and busy.port is not None:
                    try:
                        toks = _replica_counter(busy,
                                                "paddle_serve_tokens_total")
                    except OSError:
                        toks = 0.0
                    if toks >= 1 and busy.inflight >= 1:
                        killed.update(index=busy.index, pid=busy.proc.pid,
                                      inflight=busy.inflight,
                                      t_kill=time.time())
                        _log(f"SIGKILL replica {busy.index} (pid "
                             f"{busy.proc.pid}) mid-decode, "
                             f"{busy.inflight} requests in its hands")
                        busy.kill(signal.SIGKILL)
                        return
                time.sleep(0.001)

        kt = threading.Thread(target=killer)
        kt.start()
        results = _stream(front.port, prompts, max_new, "sk", lane.workers)
        kt.join()
        acct = _check_stream(lane, results, expected, n_req)
        t_kill = killed.get("t_kill")
        over = [r[3] - t_kill for r in results.values()
                if r[1].get("failovers") and t_kill is not None]
        # an idempotent retry of an answered id gets the RECORDED answer
        rid = "sk-0"
        code, payload = _post(front.port, {
            "prompt": prompts[0], "max_new_tokens": max_new,
            "request_id": rid})
        retry_ok = (code == 200 and payload.get("deduplicated") is True
                    and payload["tokens"] == results[rid][1]["tokens"])
        retry_same_trace = (payload.get("trace_id") is not None
                            and payload.get("trace_id")
                            == results[rid][1].get("trace_id"))
        _wait(lambda: gang.health()["restarts"].get("crash", 0) >= 1
              and gang.health()["ready"] == 2, lane.ready_timeout_s, 0.05)
        t_back = time.time()
        h = gang.health()
        victim = gang.replicas[killed["index"]] if killed else None
        survivors = _survivors(lane, gang, time.time())
        # every span is flushed as it is recorded, so the killed
        # incarnation's file survives and stitches with the fleet's
        report = trace_assemble.assemble_dir(gang.trace_dir)
        killed_files = [f for f in report["files"]
                        if f.endswith(f"-{killed.get('pid')}.jsonl")]
        killed_spans = sum(report["files"][f] for f in killed_files)
        trace_ok = (bool(killed_files) and killed_spans >= 1
                    and report["n_orphans"] == 0
                    and report["n_duplicates"] == 0)
        s = {"startup": startup,
             "killed_replica": killed, **acct,
             "failovers": gang.failovers,
             "failed_over_requests": len(over),
             "failover_latency_s_max": max(over) if over else None,
             "failover_latency_s_p50": _pct(over, 50),
             "restarts": h["restarts"],
             "restart_downtime_s": (t_back - t_kill) if t_kill else None,
             "respawn_startup": _startup(victim) if victim else None,
             "tokens": [results[f"sk-{i}"][1].get("tokens")
                        for i in range(n_req)],
             "idempotent_retry_ok": retry_ok,
             "retry_same_trace": retry_same_trace,
             "gang_recovered": h["ready"] == 2,
             "killed_replica_span_files": killed_files,
             "killed_replica_spans": killed_spans,
             "trace_orphans": report["n_orphans"],
             "trace_duplicates": report["n_duplicates"],
             "killed_trace_stitchable": trace_ok,
             "survivors": survivors}
        s["pass"] = bool(acct["ok"] and gang.failovers >= 1
                         and h["restarts"].get("crash", 0) >= 1
                         and retry_ok and retry_same_trace
                         and s["gang_recovered"] and trace_ok
                         and all(x["launches_exact"] for x in survivors))
        return s


def scenario_engine_poisoned(lane, gang):
    n_req, max_new = (16, lane.max_new) if lane.cuda else (10, 8)
    prompts = lane.prompts(13, n_req, 3, 12)
    expected = {f"po-{i}": lane.reference_tokens(p, max_new)
                for i, p in enumerate(prompts)}
    # three clients at a time: replica 0 finishes its requests one after
    # another, so its loop steps again after the second (the inject)
    with _serving(gang) as front:
        results = _stream(front.port, prompts, max_new, "po", 3)
        acct = _check_stream(lane, results, expected, n_req)
        _wait(lambda: gang.health()["restarts"].get("poisoned", 0) >= 1,
              60.0)
        t_seen = time.time()
        _wait(lambda: gang.health()["ready"] == 2, lane.ready_timeout_s)
        t_back = time.time()
        h = gang.health()
        survivors = _survivors(lane, gang, time.time())
        s = {**acct, "restarts": h["restarts"],
             "restart_downtime_s": t_back - t_seen,
             "respawn_startup": _startup(gang.replicas[0]),
             "sibling_kept_serving": acct["ok"],
             "gang_recovered": h["ready"] == 2, "survivors": survivors}
        s["pass"] = bool(acct["ok"]
                         and h["restarts"].get("poisoned", 0) >= 1
                         and s["gang_recovered"]
                         and all(x["launches_exact"] for x in survivors))
        return s


def scenario_engine_hang(lane, gang):
    n_req, max_new = (16, lane.max_new) if lane.cuda else (8, 8)
    prompts = lane.prompts(17, n_req, 3, 12)
    expected = {f"hg-{i}": lane.reference_tokens(p, max_new)
                for i, p in enumerate(prompts)}
    # replica 0 wedges its loop after 2 requests (three clients at a time,
    # as for the poison); its watchdog must exit 43 inside the deadline
    # and the gang recycles with cause hang
    with _serving(gang) as front:
        results = _stream(front.port, prompts, max_new, "hg", 3)
        acct = _check_stream(lane, results, expected, n_req)
        _wait(lambda: gang.health()["restarts"].get("hang", 0) >= 1
              and gang.health()["ready"] == 2, lane.ready_timeout_s)
        h = gang.health()
        survivors = _survivors(lane, gang, time.time())
        s = {**acct, "restarts": h["restarts"],
             "deadline_s": lane.hang_deadline_s,
             "failovers": gang.failovers,
             "gang_recovered": h["ready"] == 2, "survivors": survivors}
        s["pass"] = bool(acct["ok"] and h["restarts"].get("hang", 0) >= 1
                         and s["gang_recovered"]
                         and all(x["launches_exact"] for x in survivors))
        return s


def scenario_overload_storm(lane, gang):
    """Page-pool exhaustion and queue pressure on one in-process engine:
    preemption and deadline-aware shedding keep it live and every client
    answered inside its deadline — no deadlock, no unbounded tail."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.observability import default_registry

    del gang

    def shed_by_reason():
        snap = default_registry().snapshot()
        return {tuple(s["labels"])[0]: s["value"] for s in
                snap.get("paddle_serve_shed_total", {}).get("series", [])}

    # a pool far below the worst case: 4 slots of up to 4 pages each
    # against 9 usable pages -> exhaustion mid-decode. The prefix cache is
    # off: its reclaim would absorb the exhaustion this scenario provokes
    ps = lane.engine["page_size"]
    b0 = ps if lane.cuda else 8
    engine = lane.reference_engine(
        max_batch=4, max_seq=4 * b0, prefill_buckets=(b0, 2 * b0),
        num_pages=10, prefix_cache=False)
    sched = serving.Scheduler(engine, serving.SchedulerConfig(
        max_queue=64, default_timeout_s=8.0), device=lane.dev)
    front = serving.FrontDoor(scheduler=sched,
                              request_timeout_s=8.0).start()
    rng = np.random.RandomState(23)
    shed0 = shed_by_reason()
    V = lane.model["vocab_size"]

    def one(timeout_s, gen):
        prompt = rng.randint(0, V, size=int(rng.randint(
            b0 + 1, 2 * b0 - 2))).tolist()
        t0 = time.time()
        body = {"prompt": prompt, "max_new_tokens": gen,
                "timeout_s": timeout_s}
        try:
            code, payload = _post(front.port, body, timeout=30.0)
        except OSError as e:         # a transport flake: one retry
            try:
                code, payload = _post(front.port, body, timeout=30.0)
            except OSError:
                code, payload = 599, {"error": f"{type(e).__name__}: {e}"}
        return code, payload, time.time() - t0

    gen_a, gen_b = 2 * b0, 2 * b0 + 2
    try:
        for _ in range(6):           # the drain-rate estimator's history
            one(8.0, b0)
        t_start = time.time()
        # A: every admitted request grows to ~4 pages against 9 -> the
        # pool runs dry mid-decode and MUST preempt, not deadlock
        with concurrent.futures.ThreadPoolExecutor(10) as ex:
            out = list(ex.map(lambda _i: one(6.0, gen_a), range(40)))
        preempt_a = sched.preemptions
        # B: a 32-wide burst piles the queue up, then 10 ms-deadline probes
        # whose drain ETA exceeds their deadline -> shed with Retry-After
        with concurrent.futures.ThreadPoolExecutor(32) as ex:
            futs = [ex.submit(one, 6.0, gen_b) for _ in range(80)]
            time.sleep(0.05)
            probes = [ex.submit(one, 0.01, gen_b) for _ in range(20)]
            out += [f.result() for f in futs + probes]
        wall = time.time() - t_start
    finally:
        front.stop()
    codes = {}
    for code, _p, _el in out:
        codes[code] = codes.get(code, 0) + 1
    lat = sorted(el for code, _p, el in out if code == 200)
    p99 = lat[int(0.99 * (len(lat) - 1))] if lat else None
    shed1 = shed_by_reason()
    shed_delta = {k: shed1.get(k, 0) - shed0.get(k, 0)
                  for k in set(shed0) | set(shed1)}
    with_retry = [p for code, p, _el in out
                  if code == 429 and "retry_after_s" in p]
    s = {"requests": len(out), "answered": len(out),
         "codes": {str(k): v for k, v in sorted(codes.items())},
         "completed": codes.get(200, 0),
         "preemptions_pool_phase": preempt_a,
         "shed_by_reason": {k: v for k, v in shed_delta.items() if v},
         "sheds_carry_retry_after": len(with_retry) == codes.get(429, 0),
         "preemptions": sched.preemptions,
         "p99_completed_latency_s": p99, "wall_s": wall,
         "engine_poisoned": engine.poisoned}
    s["pass"] = bool(
        codes.get(200, 0) >= 1 and codes.get(599, 0) == 0
        and shed_delta.get("deadline", 0) >= 1
        and s["sheds_carry_retry_after"] and preempt_a >= 1
        and (p99 is None or p99 <= 8.0 + 2.0)
        and engine.poisoned is None)
    return s


def scenario_warm_restart_prefix(lane, gang):
    """Kill -> restart -> the prefix cache survives: the restarted
    replica's OWN prefill-token counter moves by the suffix alone on a
    repeated system prompt."""

    ps = lane.engine["page_size"]
    if lane.cuda:
        system_prompt = paged_prompts(lane.model["vocab_size"])[0][:-8]
    else:
        system_prompt = [9] * 8 + [4, 2, 7, 1]   # 12 tokens: 1 full page
    n = len(system_prompt)
    suffix = n - (n // ps) * ps
    max_new = 4
    name = "paddle_serve_prefill_tokens_total"
    with _serving(gang) as front:
        r = gang.replicas[0]

        def ask(rid):
            c0 = _replica_counter(r, name)
            code, p = _post(front.port, {"prompt": system_prompt,
                                         "max_new_tokens": max_new,
                                         "request_id": rid})
            return code, p, _replica_counter(r, name) - c0

        # the first request publishes the page-aligned prefix (and
        # persists it): the counter moves by the whole prompt
        code1, p1, d1 = ask("wr-1")
        code2, p2, d2 = ask("wr-2")           # suffix-only, pre-kill
        first = r.incarnation
        _wait(lambda: bool((r.heartbeat() or {}).get("prefix_publish_ms")),
              30.0, 0.05)
        publish_ms = (r.heartbeat() or {}).get("prefix_publish_ms", [])
        # the async record commits before the kill
        store_dir = os.path.join(gang.run_dir, "prefix_store", "replica0")
        _wait(lambda: any(os.path.exists(os.path.join(store_dir, d, "COMMIT"))
                          for d in os.listdir(store_dir))
              if os.path.isdir(store_dir) else False, 30.0, 0.05)
        _log(f"SIGKILL warm-restart replica (pid {r.proc.pid})")
        t_kill = time.time()
        r.kill(signal.SIGKILL)
        _wait(lambda: r.incarnation > first and r.alive and r.check_ready(),
              lane.ready_timeout_s)
        t_back = time.time()
        restored = r.restored_prefix_records
        # a NEW process: its counter starts at 0, and a warm cache means
        # the repeated prompt adds only its suffix
        code3, p3, d3 = ask("wr-3")
        h = gang.health()
        survivors = _survivors(lane, gang, time.time())
        s = {"prompt_len": n, "page_size": ps, "suffix_len": suffix,
             "prefill_tokens_first": d1, "prefill_tokens_repeat": d2,
             "restarts": h["restarts"],
             "restored_prefix_records": restored,
             "restart_downtime_s": t_back - t_kill,
             "respawn_startup": _startup(r),
             "prefix_publish_ms": publish_ms,
             "prefill_tokens_post_restart": d3,
             "tokens_consistent": (code1 == code2 == code3 == 200
                                   and p1["tokens"] == p2["tokens"]
                                   == p3["tokens"]),
             "survivors": survivors}
        # bf16 on the card: a suffix-only prefill is another bucket shape,
        # so its tokens are reported, not gated
        s["pass"] = bool(d1 == n and d2 == suffix and d3 == suffix
                         and restored >= 1
                         and h["restarts"].get("crash", 0) >= 1
                         and code1 == code2 == code3 == 200
                         and (lane.cuda or s["tokens_consistent"])
                         and all(x["launches_exact"] for x in survivors))
        return s


def scenario_disagg_gang(lane, gang):
    """A phased gang: the requests cross the decode replica's KV socket."""
    n_req, max_new = 16, lane.max_new
    prompts = lane.prompts(19, n_req, 3, 9)
    expected = {f"dg-{i}": lane.reference_tokens(p, max_new)
                for i, p in enumerate(prompts)}
    with _serving(gang) as front:
        pre, dec = gang.replicas
        key = "paddle_kv_transfer_bytes_total"
        out0 = _replica_counter(pre, key, 'direction="out"')
        in0 = _replica_counter(dec, key, 'direction="in"')
        results = _stream(front.port, prompts, max_new, "dg", lane.workers)
        acct = _check_stream(lane, results, expected, n_req)
        moved = (_replica_counter(pre, key, 'direction="out"') - out0,
                 _replica_counter(dec, key, 'direction="in"') - in0)
        m, e = lane.model, lane.engine
        ps = e["page_size"]
        esz = 2 if m["dtype"] == "bfloat16" else 4
        page_bytes = (2 * m["num_layers"] * ps * m["d_model"] * esz)
        want_bytes = sum(-(-len(p) // ps) for p in prompts) * page_bytes
        survivors = _survivors(lane, gang, time.time())
        pre_ticks = [x["decode_ticks"] for x in survivors
                     if x["role"] == "prefill"]
        s = {**acct, "migrated": gang.disagg_requests,
             "fallbacks": gang.disagg_fallbacks,
             "kv_bytes_out": moved[0], "kv_bytes_in": moved[1],
             "kv_bytes_want": want_bytes,
             "prefill_decode_ticks": pre_ticks, "survivors": survivors}
        s["pass"] = bool(acct["ok"] and gang.disagg_requests == n_req
                         and gang.disagg_fallbacks == 0
                         and moved == (want_bytes, want_bytes)
                         and pre_ticks == [0]
                         and all(x["launches_exact"] for x in survivors))
        return s


# each scenario's gang: all of them spawn at once, before the first
# scenario, so their replicas' start-ups overlap
GANGS = {
    "replica_sigkill": lambda lane, work: _gang(lane, work, "sigkill"),
    # replica 0 poisons itself after 2 finished requests; replica 1 is clean
    "engine_poisoned": lambda lane, work: _gang(
        lane, work, "poisoned",
        per_replica={0: {"inject": {"poison_after": 2}}}),
    "engine_hang": lambda lane, work: _gang(
        lane, work, "hang", per_replica={0: {"inject": {"hang_after": 2}}}),
    "warm_restart_prefix": lambda lane, work: _gang(
        lane, work, "warm_restart", n_replicas=1, prefix_store=True),
    "disagg_gang": lambda lane, work: _gang(
        lane, work, "disagg", roles=("prefill", "decode")),
}

# the card lane runs them all, in this order
SCENARIOS = {
    "replica_sigkill": scenario_replica_sigkill,
    "engine_poisoned": scenario_engine_poisoned,
    "warm_restart_prefix": scenario_warm_restart_prefix,
    "disagg_gang": scenario_disagg_gang,
    "engine_hang": scenario_engine_hang,
    "overload_storm": scenario_overload_storm,
}


def harness(device, out_path, only=None):
    t0 = time.time()
    lane = Lane(device)
    names = only or (tuple(SCENARIOS) if lane.cuda else SMOKE)
    work = tempfile.mkdtemp(prefix="serve_fault_bench_")
    _log(f"workdir {work} ({'cuda' if lane.cuda else 'cpu'}: "
         f"{', '.join(names)})")
    if lane.cuda:
        # the kernels once, before any replica (each gang also checks)
        from paddle_tpu_torch.ops import _build

        info = _build.build()
        _log(f"kernels {info.path} (cached={info.cached}, "
             f"{info.seconds:.1f} s)")
    gangs = {n: GANGS[n](lane, work) for n in names if n in GANGS}
    scenarios = {}
    try:
        for g in gangs.values():
            g.start(wait_ready=False)
        t = time.time()
        lane.ref = lane.reference_engine()
        ref_s = time.time() - t
        for name in names:
            _log(f"scenario {name}...")
            t = time.time()
            s = SCENARIOS[name](lane, gangs.get(name))
            s["elapsed_s"] = time.time() - t
            scenarios[name] = s
            _log(f"{name}: pass={s['pass']} ({s['elapsed_s']:.1f} s)")
    finally:
        for g in gangs.values():
            g.stop()
    # the supervisor's counters over the gang scenarios
    from paddle_tpu_torch.observability import default_registry

    snap = default_registry().snapshot()
    restarts = {tuple(s["labels"])[0]: s["value"] for s in
                snap.get("paddle_serve_replica_restarts_total",
                         {}).get("series", [])}
    failovers = sum(s["value"] for s in
                    snap.get("paddle_serve_failover_requests_total",
                             {}).get("series", []))
    launches = {}
    for s in scenarios.values():
        for k, v in _launch_sum(s.get("survivors", [])).items():
            launches[k] = launches.get(k, 0) + v
    import torch

    ok = all(s["pass"] for s in scenarios.values())
    out = {"mode": "cuda" if lane.cuda else "smoke",
           "device": (torch.cuda.get_device_name(lane.dev) if lane.cuda
                      else "cpu"),
           "model": lane.model, "engine": lane.engine,
           "reference_engine_s": ref_s,
           "replica_restarts_total": restarts,
           "failover_requests_total": failovers,
           "launches": launches,
           "elapsed_s": time.time() - t0,
           "scenarios": scenarios, "pass": bool(ok)}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    _log(f"pass={ok} in {out['elapsed_s']:.1f} s")
    print(json.dumps({"serve_fault_bench": out_path, "pass": bool(ok),
                      "mode": out["mode"],
                      "elapsed_s": out["elapsed_s"]}))
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.serve_fault_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the CPU lane: the tiny model, replica_sigkill and "
                         "engine_poisoned (with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: GPT_SMALL replicas sharing the card; cpu "
                         "with --smoke")
    ap.add_argument("--out", default=None, help="where the JSON goes")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated scenarios of "
                         f"{', '.join(SCENARIOS)}")
    args = ap.parse_args(argv)
    if args.smoke != (args.device == "cpu"):
        ap.error("the CPU runs the smoke lane only: give --smoke with "
                 "--device cpu, neither for the card")
    only = args.only.split(",") if args.only else None
    if only and set(only) - set(SCENARIOS):
        ap.error(f"unknown scenarios {sorted(set(only) - set(SCENARIOS))}")
    return harness(args.device, args.out, only)


if __name__ == "__main__":
    sys.exit(main())
