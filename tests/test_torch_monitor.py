"""The port's ``TrainMonitor`` against the JAX package's, on the CPU:
``record_step`` gives equal rows on equal inputs (the goodput breakdown,
which times the monitor's own work, aside), the anomaly (a NaN loss, a
grad-norm spike past 10x the rolling p50) fires on the same step with the
same reason, and the anomaly dump holds the reference's files but
``program_reports.json`` (which waits for ``program_report``) plus the
flight recorder's ring. ``summarize_value`` equals the reference's
``utils/nan_inf.summarize_value``. Then the monitored loop of
``tools/train_bench.py`` (``--monitor``) over a GPT_TINY step on the CPU:
one row a step with every ``STEP_RECORD_KEYS`` key finite and the goodput
breakdown summing to the step. Tolerances: none (rows compared exactly).
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from paddle_tpu.observability import monitor as JMON
from paddle_tpu.utils import nan_inf as JNI
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.observability import metrics as TM
from paddle_tpu_torch.observability import monitor as TMON
from paddle_tpu_torch.parallel import parallelize as PZ
from paddle_tpu_torch.tools import train_bench as TB

from paddle_tpu.observability import metrics as JM

KW = dict(examples_per_step=8, tokens_per_step=8 * 64,
          flops_per_step=3.2e12, peak_flops=989e12, sample_hbm=False,
          extra_static={"config": "tiny"})
# (step ms, dispatch ms, wait ms, loss, grad norm): a NaN loss at row 4,
# a grad norm 20x the rolling p50 at row 9
STEPS = [(10.0 + i, 1.0 + 0.1 * i, 8.0, 5.0 - 0.1 * i, 1.0 + 0.01 * i)
         for i in range(12)]
STEPS[3] = (12.0, 1.2, 9.0, float("nan"), 1.0)
STEPS[8] = (15.0, 1.5, 9.0, 4.5, 21.0)


def _rows(mod, reg, dump_dir=None):
    mon = mod.TrainMonitor(registry=reg, dump_on_anomaly=dump_dir, **KW)
    rows = []
    for step_ms, disp, wait, loss, gn in STEPS:
        rows.append(mon.record_step(
            step_ms, host_dispatch_ms=disp, device_wait_ms=wait,
            loss=np.float32(loss), grad_norm=np.float32(gn), lr=1e-4))
    return mon, rows


def test_record_step_rows_equal(tmp_path):
    _, want = _rows(JMON, JM.MetricsRegistry())
    _, got = _rows(TMON, TM.MetricsRegistry())
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        assert set(g.pop("goodput_ms")) <= {"device_wait"}
        w.pop("goodput_ms")
        # as JSON text: a NaN loss equals a NaN loss
        assert json.dumps(g, sort_keys=True) == json.dumps(
            w, sort_keys=True)
    assert TMON.STEP_RECORD_KEYS == JMON.STEP_RECORD_KEYS
    assert [r.get("anomaly") for r in got] == [
        r.get("anomaly") for r in want]
    assert [i for i, r in enumerate(got) if r.get("anomaly")] == [3, 8]
    assert got[3]["anomaly"] == "nan_inf" and got[8]["anomaly"] == \
        "grad_norm"


def test_anomaly_dump(tmp_path):
    jd, td = tmp_path / "jax", tmp_path / "port"
    jmon, jrows = _rows(JMON, JM.MetricsRegistry(), str(jd))
    tmon, trows = _rows(TMON, TM.MetricsRegistry(), str(td))
    assert [os.path.basename(p) for p in tmon.dump_paths] == \
        [os.path.basename(p) for p in jmon.dump_paths] == \
        ["step000004_nan_inf", "step000009_grad_norm"]
    for jp, tp in zip(jmon.dump_paths, tmon.dump_paths):
        jfiles = {f for f in os.listdir(jp) if not f.startswith("flight")}
        tfiles = {f for f in os.listdir(tp) if not f.startswith("flight")}
        assert tfiles == jfiles
        assert any(f.startswith("flight.dump.anomaly.")
                   for f in os.listdir(tp))
        with open(os.path.join(jp, "dump_info.json")) as f:
            jinfo = json.load(f)
        with open(os.path.join(tp, "dump_info.json")) as f:
            tinfo = json.load(f)
        jinfo.pop("ts"), tinfo.pop("ts")
        assert str(tinfo) == str(jinfo)      # NaN == NaN as text
        with open(os.path.join(tp, "monitor_tail.jsonl")) as f:
            tail = [json.loads(ln) for ln in f]
        assert tail[-1]["step"] == tinfo["step"]


@pytest.mark.parametrize("value", [
    np.array([1.0, np.nan, np.inf, -2.0], np.float32),
    np.arange(6, dtype=np.int64).reshape(2, 3), np.zeros((0, 2)),
    np.array([[0.5, -0.25]], np.float64), np.float32(3.0), [1, 2, 3]])
def test_summarize_value_equals_the_reference(value):
    assert TMON.summarize_value("x", value) == JNI.summarize_value("x",
                                                                    value)


def test_summarize_value_of_a_bf16_tensor():
    t = torch.tensor([1.0, float("inf"), -3.0], dtype=torch.bfloat16)
    got = TMON.summarize_value("t", t)
    assert got["dtype"] == "float32" and got["inf_count"] == 1
    assert got["min"] == -3.0 and got["max"] == 1.0


def test_monitored_train_bench_steps(tmp_path):
    """``train_bench.monitored_steps`` over a GPT_TINY step on the CPU:
    one row a step, every ``STEP_RECORD_KEYS`` key finite, the per-row
    goodput breakdown summing to within the row's own step time."""
    cfg = TG.GPT_TINY.scaled(num_layers=1, max_seq_len=16)
    params, opt = PZ.init_sharded(cfg, seed=0, device="cpu")
    step = PZ.make_train_step(cfg, lr=1e-3, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2, 16)))
    labs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2, 16)))
    path = str(tmp_path / "rows.jsonl")
    mon = TMON.TrainMonitor(path=path, examples_per_step=2,
                            tokens_per_step=32, flops_per_step=1e9,
                            peak_flops=1e12)
    outs = TB.monitored_steps(lambda: step(params, opt, toks, labs), mon, 4)
    mon.close()
    assert len(outs) == 4
    with open(path) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    for r in rows:
        for k in TMON.STEP_RECORD_KEYS:
            assert k in r and (isinstance(r[k], bool)
                               or math.isfinite(r[k])), (k, r)
        assert r["loss"] == pytest.approx(float(outs[r["step"] - 1][2]))
        assert "live_buffer_bytes" not in r          # no card in use
    for r in rows[1:]:
        gp = r["goodput_ms"]
        assert gp["productive_step"] > 0
        assert sum(gp.values()) <= r["step_time_ms"] * 1.5 + 1.0
