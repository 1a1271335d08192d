"""The port's program reports, recompile explainer and live-memory
accounting (``paddle_tpu_torch/observability/program_report.py``) against
the JAX package's, and the satellites that read them: the fluid
``Executor``'s plan reports and rebuild causes, ``make_train_step``'s
first-call report, the monitor's anomaly dump, ``goodput_report --diff``
and ``trace_assemble --chrome`` (the reference's root tools loaded by
path), and ``trace_merge``'s event merge."""
import importlib.util
import json
import logging
import os

import numpy as np
import pytest
import torch

from paddle_tpu.observability import program_report as JP
from paddle_tpu.observability import trace_merge as JTM
import paddle_tpu_torch as fluid
from paddle_tpu_torch.observability import metrics as TMX
from paddle_tpu_torch.observability import monitor as TMON
from paddle_tpu_torch.observability import program_report as P
from paddle_tpu_torch.observability import trace_merge as TM
from paddle_tpu_torch.tools import goodput_report as GR
from paddle_tpu_torch.tools import trace_assemble as TA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# (c) the explainer: the same cause in both packages
# ---------------------------------------------------------------------------

FLAG = {"FLAGS_check_nan_inf": False}
SIG_CASES = {
    # name: (new signature args, sibling signature args) as in
    # tests/test_program_report.py:246-280
    "feed_shape": (([("x", (16, 4), "float32")], ["loss"], FLAG, 1), None),
    "feed_dtype": (([("x", (8, 4), "float64")], ["loss"], FLAG, 1), None),
    "feed_set": (([("z", (8, 4), "float32")], ["loss"], FLAG, 1), None),
    "flags": (([("x", (8, 4), "float32")], ["loss"],
               {"FLAGS_check_nan_inf": True}, 1), None),
    "program_mutation": (([("x", (8, 4), "float32")], ["loss"], FLAG, 2),
                         None),
    "other": (([("x", (8, 4), "float32")], ["loss"], FLAG, 1), None),
    "nearest_fetch_list": (([("x", (16, 4), "float32")], ["loss", "acc"],
                            FLAG, 1),
                           ([("x", (16, 4), "float32")], ["loss"], FLAG, 1)),
    "mesh": (([("x", (8, 4), "float32")], ["loss"], FLAG, 1, "dp2"), None),
}


def _sig(mod, args):
    feed, fetch, flags, version = args[:4]
    mesh = args[4] if len(args) > 4 else None
    return mod.make_sig(feed, fetch, flags=flags, version=version,
                        mesh=mesh)


@pytest.mark.parametrize("case", sorted(SIG_CASES))
def test_explain_recompile_equals_reference(case):
    new, extra = SIG_CASES[case]
    base = ([("x", (8, 4), "float32")], ["loss"], FLAG, 1)
    outs = []
    for mod in (P, JP):
        sibs = [_sig(mod, base)] + ([_sig(mod, extra)] if extra else [])
        assert _sig(mod, new) == _sig(JP, new)
        outs.append(mod.explain_recompile(_sig(mod, new), sibs))
    assert outs[0] == outs[1]
    want = case.replace("nearest_", "")
    assert outs[0][0] == want


def test_note_recompile_rate_limit_equals_reference(caplog):
    logged = []
    for mod, name in ((P, "paddle_tpu_torch.program_report"),
                      (JP, "paddle_tpu.program_report")):
        mod.reset()
        with caplog.at_level(logging.WARNING, logger=name):
            logged.append([mod.note_recompile("prog", "fetch_list", "d")
                           for _ in range(120)])
    assert logged[0] == logged[1]
    assert sum(logged[0]) == P._LOG_FIRST + 2      # 3 first, then 50, 100


# ---------------------------------------------------------------------------
# reports: counting a call, the sink, live memory
# ---------------------------------------------------------------------------

def test_counted_report_fields_and_jsonl_sink(tmp_path, monkeypatch):
    from paddle_tpu_torch.framework import core

    P.reset()
    monkeypatch.setitem(core._GLOBAL_FLAGS, "FLAGS_program_report_dir",
                        str(tmp_path))
    x = torch.randn(8, 4, requires_grad=True)
    w = torch.randn(4, 3, requires_grad=True)
    with P.counted(flops=True) as c:
        y = (x @ w).sum()
        y.backward()
    rec = P.capture("unit/matmul", c, inputs=[x, w], outputs=y,
                    extra={"mode": "test"})
    # forward 2·8·4·3, backward dx and dw the same each
    assert rec["flops"] == 3 * 2 * 8 * 4 * 3
    assert rec["bytes_accessed"] is None and rec["kernel_launches"] == 0
    assert rec["compile_ms"] > 0 and rec["mode"] == "test"
    mem = rec["memory"]
    assert mem["argument_bytes"] == (8 * 4 + 4 * 3) * 4
    assert mem["output_bytes"] == 4
    assert mem["peak_hbm_bytes"] is None and mem["temp_bytes"] is None
    assert set(mem) == set(JP.memory_summary(None))
    assert rec["in_avals"]["count"] == 2
    assert rec["in_avals"]["entries"][0] == {"shape": [8, 4],
                                             "dtype": "float32"}
    assert P.recent_reports()[-1] is rec
    lines = [json.loads(ln) for f in tmp_path.glob("program_reports.*.jsonl")
             for ln in f.read_text().splitlines()]
    assert [r["program"] for r in lines] == ["unit/matmul"]
    snap = TMX.default_registry().snapshot()
    series = {s["labels"]: s["value"]
              for s in snap["paddle_program_flops"]["series"]}
    assert series[("unit/matmul",)] == rec["flops"]
    P.reset()


def test_live_memory_on_the_cpu_and_reconcile():
    assert P.live_buffer_bytes() == (None, None)
    assert P.sample_hbm_gauges() == (None, None)
    with pytest.raises(NotImplementedError, match="A5"):
        P.reconcile_memory_usage(fluid.Program())


# ---------------------------------------------------------------------------
# (g) the fluid Executor: a report a plan, the rebuild causes
# ---------------------------------------------------------------------------

def _mlp():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.reduce_mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, logits


def _feed(batch, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.rand(batch, 8).astype("float32"),
            "y": rs.randint(0, 4, (batch, 1)).astype("int64")}


def _count(cause):
    fam = TMX.default_registry().snapshot().get(
        "paddle_recompiles_total", {"series": []})
    return sum(s["value"] for s in fam["series"] if s["labels"] == (cause,))


@pytest.fixture
def count_flops(monkeypatch):
    from paddle_tpu_torch.framework import core

    monkeypatch.setitem(core._GLOBAL_FLAGS, "FLAGS_program_report_flops",
                        True)


def test_reports_count_aten_flops_only_when_asked():
    P.reset()
    main, startup, loss, _ = _mlp()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
    rep = P.recent_reports()[-1]
    assert rep["flops"] is None and rep["compile_ms"] > 0
    assert rep["memory"]["argument_bytes"] == 8 * 8 * 4 + 8 * 8


def test_executor_reports_and_rebuild_causes(count_flops):
    P.reset()
    main, startup, loss, logits = _mlp()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    causes = ("fetch_list", "program_mutation", "feed_shape", "feed_dtype",
              "other")
    before = {c: _count(c) for c in causes}
    exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
    rep = P.recent_reports()[-1]
    n_ops = len(main.global_block().ops)
    assert rep["program"] == f"{loss.name}#{n_ops}ops"
    # one fc forward and its backward: x·W1 and W1's gradient (x is
    # data), h·W2 and both of its gradients
    assert rep["flops"] == 2 * 8 * 8 * 16 * 2 + 2 * 8 * 16 * 4 * 3
    assert rep["mode"] == "executor" and rep["in_avals"]["count"] == 2
    n = len(P.recent_reports())
    # a feed shape change: no rebuild, no report, no cause (the eager
    # plan takes any batch — a difference by design)
    exe.run(main, feed=_feed(16), fetch_list=[loss], scope=scope)
    assert len(P.recent_reports()) == n
    # a new fetch list: a rebuild blamed on it
    exe.run(main, feed=_feed(16), fetch_list=[loss, logits], scope=scope)
    assert len(P.recent_reports()) == n + 1
    # a mutated program: a rebuild blamed on the mutation
    with fluid.program_guard(main, fluid.Program()):
        fluid.layers.scale(loss, 2.0)
    exe.run(main, feed=_feed(16), fetch_list=[loss], scope=scope)
    assert len(P.recent_reports()) == n + 2
    after = {c: _count(c) - before[c] for c in causes}
    assert after == {"fetch_list": 1, "program_mutation": 1,
                     "feed_shape": 0, "feed_dtype": 0, "other": 0}


def test_train_step_first_call_report(count_flops):
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    P.reset()
    cfg = G.GPT_TINY.scaled(num_layers=1)
    params, opt = PZ.init_sharded(cfg, seed=0, fused_opt=True,
                                  device="cpu")
    step = PZ.make_train_step(cfg, lr=1e-3, fused_opt=True, device="cpu")
    assert step.report_name == "parallel_train_step/dp1pp1tp1mb1_fused"
    tok = torch.zeros((1, 2, 16), dtype=torch.long)
    step(params, opt, tok, tok)
    step(params, opt, tok, tok)
    reps = [r for r in P.recent_reports() if r["program"] ==
            step.report_name]
    assert len(reps) == 1                     # the first call only
    rep = reps[0]
    assert rep["flops"] > 0 and rep["compile_ms"] > 0
    assert rep["donated"] == ["params", "opt_state"]
    assert rep["mesh"] == {"dp": 1, "pp": 1, "tp": 1}
    assert rep["memory"]["argument_bytes"] > 0


# ---------------------------------------------------------------------------
# (h) the monitor's dump, goodput_report --diff, trace_assemble --chrome
# ---------------------------------------------------------------------------

def test_monitor_anomaly_dump_holds_program_reports(tmp_path):
    P.reset()
    with P.counted() as c:
        torch.ones(2, 2) @ torch.ones(2, 2)
    P.capture("dumped/program", c)
    mon = TMON.TrainMonitor(registry=TMX.MetricsRegistry(),
                            dump_on_anomaly=str(tmp_path),
                            examples_per_step=4)
    row = mon.record_step(10.0, loss=np.float32(np.nan))
    assert row["anomaly"] == "nan_inf"
    assert "live_buffer_bytes" not in row      # no card: left out
    with open(os.path.join(mon.dump_paths[0], "program_reports.json")) as f:
        reps = json.load(f)
    assert [r["program"] for r in reps] == ["dumped/program"]
    P.reset()


def _gp(tmp_path, name, cats, wall):
    p = tmp_path / name
    p.write_text(json.dumps({"wall_s": wall, "categories": cats}))
    return str(p)


def test_goodput_report_diff_equals_reference(tmp_path, capsys):
    ref = _ref_tool("goodput_report")
    a = _gp(tmp_path, "a.json", {"productive_step": 90.0, "compile": 6.0,
                                 "other": 4.0}, 100.0)
    b = _gp(tmp_path, "b.json", {"productive_step": 70.0, "compile": 26.0,
                                 "other": 4.0}, 100.0)
    for pa, pb, rc in ((a, a, 0), (a, b, 1)):
        assert GR.main(["--diff", pa, pb]) == rc
        mine = capsys.readouterr().out
        assert ref.diff_reports(pa, pb, 0.25, 0.02) == rc
        theirs = capsys.readouterr().out
        assert mine == theirs
    assert "compile" in mine and "OUT-OF-BAND" in mine


def _spans():
    return [{"trace": 0xabc, "span": 0x1, "parent": 0, "name": "serve/request",
             "start_ns": 1_000_000, "dur_ns": 500_000, "tid": 7,
             "thread": "loop", "pid": 11, "role": "decode",
             "attrs": {"slot": 2}},
            {"trace": 0xabc, "span": 0x2, "parent": 0x1, "name": "prefill",
             "start_ns": 1_100_000, "dur_ns": 100_000, "tid": 7,
             "thread": "loop", "pid": 11, "role": "decode"},
            {"trace": 0xdef, "span": 0x3, "parent": 0, "name": "serve/request",
             "start_ns": 900_000, "dur_ns": 50_000, "tid": 9,
             "thread": "other", "pid": 11, "role": "decode"}]


def test_trace_merge_events_equal_reference():
    host = [{"name": "h", "ph": "X", "ts": 10.0, "dur": 5.0, "pid": 3,
             "tid": 1}]
    dev = [{"plane": "/device:GPU:0", "line": "stream 7", "name": "k",
            "start_ns": 5000.0, "dur_ns": 2000.0}]
    for kw in ({}, {"align_device_to_us": 950.0},
               {"tracer_spans": _spans(), "span_epoch_us": 1000.0}):
        assert TM.merge_events(host, dev, **kw) == \
            JTM.merge_events(host, dev, **kw)
    assert TM.span_chrome_events(_spans(), epoch_us=950.0) == \
        JTM.span_chrome_events(_spans(), epoch_us=950.0)


def test_trace_assemble_chrome_equals_reference(tmp_path):
    d = tmp_path / "trace"
    d.mkdir()
    with open(d / "spans-decode-11.jsonl", "w") as f:
        for s in _spans():
            f.write(json.dumps(s) + "\n")
    ref = _ref_tool("trace_assemble")
    for extra in ([], ["--trace", "abc"]):
        mine, theirs = tmp_path / "m.json", tmp_path / "t.json"
        assert TA.main([str(d), "--chrome", str(mine)] + extra) == 0
        assert ref.main([str(d), "--chrome", str(theirs)] + extra) == 0
        m, t = json.loads(mine.read_text()), json.loads(theirs.read_text())
        assert m == t and m["traceEvents"]
    assert all(e.get("args", {}).get("trace") in (None, "abc")
               for e in m["traceEvents"])


def test_merge_profile_with_a_capture(tmp_path):
    from paddle_tpu_torch.utils import device_trace as DT

    with DT.capture(str(tmp_path / "cap")):
        (torch.ones(4, 4) @ torch.ones(4, 4)).sum()
    host = tmp_path / "host.chrome_trace.json"
    host.write_text(json.dumps({"traceEvents": [
        {"name": "step", "ph": "X", "ts": 50.0, "dur": 10.0, "pid": 1,
         "tid": 1}]}))
    out = TM.merge_profile(str(host), str(tmp_path / "cap"),
                           tracer_spans=_spans())
    doc = json.loads(open(out).read())
    planes = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("name") == "process_name"}
    assert "device /host:CPU (CPU runtime)" in planes
    assert any(e.get("args", {}).get("track") == "span"
               for e in doc["traceEvents"])
    # the capture's earliest event lands on the host trace's first one
    dev = [e for e in doc["traceEvents"]
           if e.get("args", {}).get("track") == "device"]
    assert min(e["ts"] for e in dev) == pytest.approx(50.0)
