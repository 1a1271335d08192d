"""The port's span tracer (``paddle_tpu_torch/observability/spans.py``)
against the JAX package's, on the CPU: the same sequence of span / record
calls under the same patched ``perf_counter_ns`` gives the same sink
records (span and trace ids mapped by first appearance: each package
keeps its own id counter), the wire context round-trips across the two
packages, and either package's trace assembler stitches the other's
files. Then the serving path: the port's and the JAX ``Scheduler`` over
the same GPT_TINY (2 layers, ``G.init_params`` carried across, float32)
and the same prompts record the same multiset of (span name, parent
name, bucket, prompt_len); tracing on or off leaves the tokens unchanged;
``DisaggRouter.generate(trace_ctx=)`` records one trace across the
prefill and the decode replica, and the front door's ``/generate`` joins
the caller's trace. Tolerances: none — records are compared exactly.
"""
import collections
import importlib.util
import io
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.observability import spans as JSP
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.observability import spans as TSP
from paddle_tpu_torch.serving.disagg import DisaggRouter, LocalReplica
from paddle_tpu_torch.tools import trace_assemble as TA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16))
PAGED = {"kv_layout": "paged", "page_size": 8}


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """A deterministic ``perf_counter_ns``: 1000 ns a call."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1000
        return self.t


def _script(mod, tracer):
    """One sequence of tracer calls: nested spans with attrs, a record
    under the open context, an explicit-trace record, a span adopting a
    context on another thread, a span that raises."""
    with tracer.span("outer", attrs={"k": 1}) as sp:
        sp.set_attr("late", "x")
        with tracer.span("inner"):
            tracer.record("timed", 5, 7, attrs={"n": 2})
        ctx = tracer.current_context()
    tracer.record("root", 1, 2, trace=ctx[0], parent=None, span_id=99)

    def worker():
        with tracer.context(ctx):
            with tracer.span("on_thread"):
                pass

    th = threading.Thread(target=worker, name="w")
    th.start()
    th.join()
    with pytest.raises(ValueError):
        with tracer.span("fails"):
            raise ValueError("boom")
    with tracer.span("fresh", trace=12345):
        pass


def _canon(records):
    """Records with trace/span/parent ids renamed by first appearance
    (99 and 12345 stay: they were given)."""
    names = {99: 99, 12345: 12345, None: None}

    def m(x):
        if x not in names:
            names[x] = f"id{len(names)}"
        return names[x]

    out = []
    for r in records:
        r = dict(r)
        for k in ("trace", "span", "parent"):
            r[k] = m(r[k])
        r.pop("tid")
        out.append(r)
    return out


def _run(mod, monkeypatch):
    monkeypatch.setattr(time, "perf_counter_ns", _Clock())
    sink = io.StringIO()
    tracer = mod.SpanTracer(sink=sink)
    _script(mod, tracer)
    lines = [json.loads(ln) for ln in sink.getvalue().splitlines()]
    assert lines == tracer.spans()
    return tracer, lines


def test_same_calls_give_the_same_records(monkeypatch):
    jt, jrec = _run(JSP, monkeypatch)
    tt, trec = _run(TSP, monkeypatch)
    assert _canon(trec) == _canon(jrec)
    assert len(trec) == 7
    assert [r["name"] for r in trec] == [
        "timed", "inner", "outer", "root", "on_thread", "fails", "fresh"]
    assert trec[5]["attrs"] == {"error": "ValueError"}
    assert tt.summary() == jt.summary()
    assert tt.trace_spans(12345)[0]["name"] == "fresh"


def test_disabled_tracer_records_nothing():
    for mod in (JSP, TSP):
        tracer = mod.SpanTracer()
        mod.set_tracing_enabled(False)
        try:
            with tracer.span("x") as sp:
                sp.set_attr("a", 1)
            assert tracer.record("y", 0, 1) is None
        finally:
            mod.set_tracing_enabled(True)
        assert tracer.spans() == []
        assert mod.tracing_enabled()


@pytest.mark.parametrize("obj", [
    {"trace": {"trace_id": 7, "parent_span": 9}},
    {"trace_id": "7", "parent_span": 9},
    {"trace": "garbled"}, {"trace": {"trace_id": 1}}, [1, 2], None,
    {"trace": {"trace_id": "x", "parent_span": 2}}])
def test_wire_context_round_trips_across_packages(obj):
    assert TSP.extract(obj) == JSP.extract(obj)
    ctx = (123456789, 42)
    assert TSP.inject(ctx) == JSP.inject(ctx)
    assert TSP.extract({TSP.WIRE_KEY: JSP.inject(ctx)}) == ctx
    assert JSP.extract({JSP.WIRE_KEY: TSP.inject(ctx)}) == ctx
    assert TSP.inject(None) is None and TSP.WIRE_KEY == JSP.WIRE_KEY


def test_gen_id_is_pid_salted():
    a, b = TSP.gen_id(), TSP.gen_id()
    assert b > a and a >> 40 == (os.getpid() & 0xFFFF)
    assert TSP.process_sink_path("/d", "r") == JSP.process_sink_path("/d",
                                                                       "r")


def test_assemblers_read_each_others_span_files(tmp_path, monkeypatch):
    """A port process sink and a JAX one in one trace dir, a request
    each (the route span's parent the client's own); both assemblers give
    the same report."""
    monkeypatch.setattr(time, "perf_counter_ns", _Clock())
    for mod, role, trace in ((TSP, "port", 77), (JSP, "jax", 78)):
        path = os.path.join(tmp_path, f"spans-{role}-1.jsonl")
        tracer = mod.SpanTracer(sink=path)
        tracer.record("serve/route", 0, 9, trace=trace, span_id=5,
                      parent=3, attrs={"remote_parent": True})
        with tracer.context((trace, 5)):
            with tracer.span("serve/request"):
                tracer.record("serve/prefill", 1, 2)
        tracer.set_sink(None)
    ref = _ref_tool("trace_assemble").assemble_dir(str(tmp_path))
    port = TA.assemble_dir(str(tmp_path))
    assert port == ref
    assert port["n_traces"] == 2 and port["n_spans"] == 6
    assert port["n_orphans"] == 0 and port["n_duplicates"] == 0
    assert [t["roles"] for t in port["traces"]] == [["port"], ["jax"]]


# ---------------------------------------------------------------------------
# The serving path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(0), cfg_j)
    tp = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg_j, jp, cfg_t, tp


PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12], [13] * 5,
           list(range(20, 31)), [7, 7]]


def _drive(sched, prompts, new=4):
    reqs = [sched.submit(p, max_new_tokens=new) for p in prompts]
    while sched.pending():
        sched.step()
    assert all(r.state == "done" for r in reqs)
    return reqs


def _shape(records, reqs):
    """(name, parent name, bucket, prompt_len) of every finished span of
    the requests' traces."""
    ids = {r.trace_id for r in reqs}
    mine = [s for s in records if s["trace"] in ids
            and not (s.get("attrs") or {}).get("open")]
    by_id = {s["span"]: s["name"] for s in mine}
    return collections.Counter(
        (s["name"], by_id.get(s["parent"]),
         (s.get("attrs") or {}).get("bucket"),
         (s.get("attrs") or {}).get("prompt_len")) for s in mine)


@pytest.mark.parametrize("layout", [{}, PAGED], ids=["slab", "paged"])
def test_scheduler_spans_match_jax(tiny, layout):
    cfg_j, jp, cfg_t, tp = tiny
    jeng = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(**EKW, **layout))
    teng = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**EKW, **layout),
                           device="cpu")
    jreqs = _drive(JS.Scheduler(jeng), PROMPTS)
    treqs = _drive(TS.Scheduler(teng, device="cpu"), PROMPTS)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    want = _shape(JSP.default_tracer().spans(), jreqs)
    got = _shape(TSP.default_tracer().spans(), treqs)
    assert got == want
    assert got[("serve/request", None, None, None)] == len(PROMPTS)
    assert got[("serve/evict", "serve/request", None, None)] == len(PROMPTS)
    ticks = [s for s in TSP.default_tracer().spans()
             if s["name"] == "serve/decode_tick"
             and s["trace"] in {r.trace_id for r in treqs}]
    # one span a rider a tick: each tick's spans share its start
    by_tick = collections.Counter(s["start_ns"] for s in ticks)
    assert all(by_tick[s["start_ns"]] == s["attrs"]["batch"]
               for s in ticks)


def test_tracing_off_keeps_the_tokens(tiny):
    _, _, cfg_t, tp = tiny
    out = {}
    for on in (True, False):
        TSP.set_tracing_enabled(on)
        try:
            eng = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**EKW, **PAGED),
                                  device="cpu")
            n0 = len(TSP.default_tracer().spans())
            out[on] = [r.tokens for r in
                       _drive(TS.Scheduler(eng, device="cpu"), PROMPTS)]
            grew = len(TSP.default_tracer().spans()) - n0
        finally:
            TSP.set_tracing_enabled(True)
        assert (grew > 0) == on
    assert out[True] == out[False]


def test_router_one_trace_across_both_replicas(tiny, tmp_path):
    _, _, cfg_t, tp = tiny
    sink = TSP.attach_process_sink(str(tmp_path), "router")
    try:
        reps = [LocalReplica(TS.DecodeEngine(
            tp, cfg_t, TS.EngineConfig(**EKW, **PAGED, role=role),
            device="cpu")) for role in ("prefill", "decode")]
        router = DisaggRouter(reps)
        try:
            res = router.generate([1, 2, 3, 4, 5, 6, 7, 8, 9],
                                  max_new_tokens=5, trace_ctx=(4242, 17))
            fresh = router.generate([3, 1, 4], max_new_tokens=3)
        finally:
            for r in reps:
                r.stop()
    finally:
        TSP.default_tracer().set_sink(None)
    assert res.migrated and res.trace_id == 4242
    assert fresh.migrated and fresh.trace_id not in (None, 4242)
    report = TA.assemble_dir(str(tmp_path))
    # the open sentinels of the four request roots collapse into their
    # final records
    assert report["files"] == {os.path.basename(sink):
                               report["n_spans"] + 4}
    assert report["n_orphans"] == 0 and report["n_duplicates"] == 0
    trace = next(t for t in report["traces"] if t["trace"] == f"{4242:x}")
    assert set(trace["names"]) == {
        "serve/route", "serve/request", "serve/queue_wait", "serve/prefill",
        "serve/kv_adopt", "serve/decode_tick", "serve/evict"}
    spans = [s for s in TSP.default_tracer().spans() if s["trace"] == 4242]
    route = next(s for s in spans if s["name"] == "serve/route")
    assert route["parent"] == 17 and route["attrs"]["remote_parent"]
    roots = [s for s in spans if s["name"] == "serve/request"
             and not s["attrs"].get("open")]
    # the prefill half under the route, the decode half under the prefill
    # half (the handoff carries its context), its adoption under it
    assert len(roots) == 2
    pre, dec = sorted(roots, key=lambda s: s["start_ns"])
    assert pre["parent"] == route["span"] and dec["parent"] == pre["span"]
    adopt = next(s for s in spans if s["name"] == "serve/kv_adopt")
    assert adopt["parent"] == dec["span"]


def test_front_door_joins_the_callers_trace(tiny):
    _, _, cfg_t, tp = tiny
    eng = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**EKW), device="cpu")
    front = TS.FrontDoor(TS.Scheduler(eng, device="cpu")).start()
    try:
        body = {"prompt": [1, 2, 3], "max_new_tokens": 3,
                "trace": TSP.inject((9090, 31))}
        req = urllib.request.Request(
            f"http://127.0.0.1:{front.port}/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200 and len(json.load(r)["tokens"]) == 3
        with urllib.request.urlopen(
                f"http://127.0.0.1:{front.port}/health", timeout=10) as r:
            health = json.load(r)
    finally:
        front.stop()
    spans = [s for s in TSP.default_tracer().spans() if s["trace"] == 9090]
    root = next(s for s in spans if s["name"] == "serve/request"
                and not s["attrs"].get("open"))
    assert root["parent"] == 31
    assert {"serve/request", "serve/decode_tick", "serve/prefill"} <= set(
        health["span_rollups_ms"])
    assert all(k.startswith("serve/") for k in health["span_rollups_ms"])
