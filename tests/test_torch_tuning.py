"""The autotuner (``paddle_tpu_torch/tuning/``, ``tools/autotune.py``)
against the JAX package's ``paddle_tpu/tuning/`` on the CPU, with the same
inputs: the knob spaces and their refusals, the incumbents, the static
model's estimates (1e-12 relative), successive halving's winners, prunes
and probe counts under the same scripted probes, SIGKILL-resume through
the probe log, the TUNED.json round trip and fingerprint gate, every
applier, the serve probe's traffic, the train probe against the port's
own step, ``make_train_step(tuned=)`` against the explicit kwargs
(bitwise), and ``autotune --smoke`` end to end.

Differences from the reference, each asserted here: the port refuses an
int8 psum train candidate (its step refuses error feedback without
reduce-scatter), it keeps spec with the fused decode tick (the
reference's ``spec_plus_fused_decode`` rule is not ported), and its serve
incumbent has ``fused_decode=True`` (the port's ``EngineConfig``
default)."""
import hashlib
import json
import math
import os
import signal
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference below runs on the CPU)

from paddle_tpu import tuning as J
from paddle_tpu.tuning import driver as JD
from paddle_tpu.tuning import probe as JP
from paddle_tpu.tuning import static_cost as JS
from paddle_tpu.tuning import tuned as JT
from paddle_tpu_torch import tuning as T
from paddle_tpu_torch.tuning import driver as TD
from paddle_tpu_torch.tuning import probe as TP
from paddle_tpu_torch.tuning import static_cost as TS
from paddle_tpu_torch.tuning import tuned as TT

REPO = Path(__file__).resolve().parents[1]
ROOT_TUNED = str(REPO / "TUNED.json")     # the JAX package's CPU tune

CPU1 = dict(dp=1, n_devices=1, platform="cpu", vocab_size=256, max_seq=64,
            max_batch=8, page_size=8, on_acc=False)
CPU_DP2 = dict(CPU1, dp=2, n_devices=2)
# the contexts of the reference's tests (tests/test_autotune.py)
TRAIN_CTXS = {"cpu1": CPU1, "cpu_dp2": CPU_DP2,
              "acc1": dict(CPU1, on_acc=True, platform="gpu"),
              "vocab32": dict(CPU1, vocab_size=32)}
SERVE_CTXS = {"n1": dict(CPU1), "n2": dict(CPU1, n_devices=2),
              "n8": dict(CPU1, n_devices=8),
              "n8_b4": dict(n_devices=8, max_seq=32, max_batch=4,
                            page_size=8, vocab_size=64)}


def _smoke_serve_axes(pkg, ctx, c):
    return pkg.serve_axes(
        ctx, max_batches=(c["max_batch"],),
        bucket_ladders=((max(c["page_size"], c["max_seq"] // 4),
                         c["max_seq"] // 2), (c["max_seq"] // 2,)),
        specs=(0, 2), disagg_ratios=("off", "1:1"),
        disagg_decode_batches=(1,))


def _both_spaces(space, c, smoke=False):
    out = []
    for pkg in (T, J):
        ctx = pkg.SpaceContext(**c)
        if space == "train":
            axes = pkg.train_axes(ctx)
        else:
            axes = _smoke_serve_axes(pkg, ctx, c) if smoke \
                else pkg.serve_axes(ctx)
        valid, refused = pkg.enumerate_space(space, axes, ctx)
        out.append(({v.key for v in valid},
                    {c_.key: r for c_, r in refused}))
    return out


def _knobs_of(key):
    """A candidate key's knobs (``Candidate.key`` read back)."""
    out = {}
    for kv in key.split(":", 1)[1].split(","):
        k, v = kv.split("=")
        if k == "buckets":
            out[k] = tuple(int(b) for b in v.split("/"))
        elif k in ("max_batch", "num_pages", "spec", "tp",
                   "disagg_decode_batch"):
            out[k] = int(v)
        elif k == "fused_decode":
            out[k] = v == "1"
        else:
            out[k] = v
    return out


def _int8_psum(key):
    return "comm_dtype=int8" in key and "grad_reduce=psum" in key


@pytest.mark.parametrize("name", sorted(TRAIN_CTXS))
def test_train_space_matches_reference(name):
    (tv, tr), (jv, jr) = _both_spaces("train", TRAIN_CTXS[name])
    # the one difference: int8 psum (error feedback without
    # reduce-scatter) is refused by the port, valid for the reference
    ef = {k: r for k, r in tr.items()
          if r == "invalid:error_feedback_needs_reduce_scatter"}
    assert set(ef) == {k for k in jv if _int8_psum(k)}
    assert bool(ef) == (TRAIN_CTXS[name]["dp"] > 1)
    assert tv == jv - set(ef)
    assert {k: r for k, r in tr.items() if k not in ef} == jr
    assert all(r.startswith("invalid:") for r in tr.values())


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", sorted(SERVE_CTXS))
def test_serve_space_matches_reference(name, smoke):
    c = SERVE_CTXS[name]
    (tv, tr), (jv, jr) = _both_spaces("serve", c, smoke)
    # the one difference: spec with the fused tick is valid in the port,
    # so such a candidate gets the verdict of the reference's other rules
    spec_fused = {k for k, r in jr.items()
                  if r == "invalid:spec_plus_fused_decode"}
    assert spec_fused
    jctx = J.SpaceContext(**c)
    for k in spec_fused:
        cand_knobs = dict(J.Candidate.make("serve", **_knobs_of(k)).knobs)
        want = J.validate_serve(dict(cand_knobs, fused_decode=False), jctx)
        assert (k in tv) if want is None else tr[k] == want
    admitted = {k for k in spec_fused if k in tv}
    assert admitted and tv == jv | admitted
    assert {k: r for k, r in tr.items() if k not in spec_fused} == \
        {k: r for k, r in jr.items() if k not in spec_fused}
    assert all(r.startswith("invalid:") for r in tr.values())
    if c["n_devices"] < 2:       # one device admits no tp candidate
        assert not any("sharding=tp" in k for k in tv)
        assert "invalid:tp_needs_devices" in tr.values()


@pytest.mark.parametrize("on_acc", [False, True])
def test_incumbents_match_reference(on_acc):
    c = dict(CPU1, on_acc=on_acc)
    assert T.train_incumbent(T.SpaceContext(**c)).key == \
        J.train_incumbent(J.SpaceContext(**c)).key
    ti = T.serve_incumbent(T.SpaceContext(**c))
    ji = J.serve_incumbent(J.SpaceContext(**c))
    assert ti.get("fused_decode") is True and ji.get("fused_decode") is False
    assert ti.replace(fused_decode=False).key == ji.key


# ---------------------------------------------------------------------------
# the static model
# ---------------------------------------------------------------------------

def _hw(pkg, on_acc, cap):
    return pkg.HwModel(peak_flops=989e12 if on_acc else 1e12,
                       peak_hbm_bps=3.35e12 if on_acc else 50e9,
                       hbm_capacity_bytes=cap, on_acc=on_acc)


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def _same_estimate(te, je):
    assert _close(te.ms, je.ms) and _close(te.peak_hbm_bytes,
                                           je.peak_hbm_bytes)
    assert te.over_hbm == je.over_hbm and te.bound == je.bound
    for k, v in je.detail.items():
        assert _close(te.detail[k], v), k


@pytest.mark.parametrize("on_acc", [False, True])
@pytest.mark.parametrize("dp", [1, 2])
def test_predict_train_matches_reference(dp, on_acc):
    c = dict(CPU_DP2 if dp == 2 else CPU1, on_acc=on_acc)
    tctx, jctx = T.SpaceContext(**c), J.SpaceContext(**c)
    valid, _ = T.enumerate_space("train", T.train_axes(tctx), tctx)
    base = dict(flops=3.2e9, bytes_accessed=7.5e8, peak_hbm_bytes=2.4e8,
                param_bytes=1.1e7, tokens_per_step=128, vocab_size=256)
    tb = TS.BaseStats(**base, incumbent=T.train_incumbent(tctx))
    jb = JS.BaseStats(**base, incumbent=J.train_incumbent(jctx))
    over = 0
    for cand in valid:
        jc = J.Candidate.make("train", **dict(cand.knobs))
        assert jc.key == cand.key
        te = TS.predict_train(cand, tb, _hw(TS, on_acc, 2.3e8), dp=dp)
        je = JS.predict_train(jc, jb, _hw(JS, on_acc, 2.3e8), dp=dp)
        _same_estimate(te, je)
        over += te.over_hbm
    assert 0 < over < len(valid)         # the budget cuts the space


@pytest.mark.parametrize("on_acc", [False, True])
def test_predict_serve_matches_reference(on_acc):
    c = dict(SERVE_CTXS["n8"], on_acc=on_acc)
    tctx, jctx = T.SpaceContext(**c), J.SpaceContext(**c)
    valid, _ = T.enumerate_space("serve", T.serve_axes(tctx), tctx)
    base = dict(flops=2.0e6, bytes_accessed=4.0e6, peak_hbm_bytes=1.2e7,
                param_bytes=4.0e6)
    tb = TS.BaseStats(**base, incumbent=T.serve_incumbent(tctx))
    jb = JS.BaseStats(**base, incumbent=J.serve_incumbent(jctx))
    over = 0
    for cand in valid:
        jc = J.Candidate.make("serve", **dict(cand.knobs))
        te = TS.predict_serve(cand, tb, _hw(TS, on_acc, 1.5e7),
                              kv_page_bytes=8192.0)
        je = JS.predict_serve(jc, jb, _hw(JS, on_acc, 1.5e7),
                              kv_page_bytes=8192.0)
        _same_estimate(te, je)
        over += te.over_hbm
    assert 0 < over < len(valid)


def test_hw_model_for_device_on_the_cpu():
    """Off the card the reference's fallbacks, no budget, the penalty on."""
    hwm = TS.HwModel.for_device("cpu")
    assert (hwm.peak_flops, hwm.peak_hbm_bps, hwm.hbm_capacity_bytes,
            hwm.ici_bps, hwm.on_acc) == (1e12, 50e9, None, 9e10, False)
    assert TS.HwModel.for_device("cpu", hbm_capacity_bytes=5.0
                                 ).hbm_capacity_bytes == 5.0
    from paddle_tpu_torch.observability import hw

    assert hw.PEAKS["h100"]["hbm_capacity_bytes"] == 80e9
    with pytest.raises(KeyError):
        hw.peaks_for("cpu")


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _fake_score(key: str, rung: int) -> float:
    h = int(hashlib.sha256(key.encode()).hexdigest()[:8], 16)
    return 5.0 + (h % 1000) / 100.0 + 0.01 * rung


def _tune(pkg, D, S, space, cands, refusals, inc, static, log=None):
    base = S.BaseStats(flops=3.2e9, bytes_accessed=7.5e8,
                       peak_hbm_bytes=2.4e8, param_bytes=1.1e7,
                       tokens_per_step=128, vocab_size=256, incumbent=inc)
    hwm = S.HwModel(peak_flops=1e12, peak_hbm_bps=50e9,
                    hbm_capacity_bytes=2.3e8, on_acc=False)

    def probe_fn(cand, steps, rung):
        return {"score": _fake_score(cand.key, rung)}

    def static_fn(cand, inc_result):
        return (S.predict_train(cand, base, hwm) if space == "train"
                else S.predict_serve(cand, base, hwm))

    return D.tune(space=space, candidates=cands, refusals=refusals,
                  incumbent=inc, probe_fn=probe_fn,
                  static_fn=static_fn if static else None,
                  rungs=((2, 0.5), (4, 1.0)), log=log)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("space", ["train", "serve"])
def test_tune_matches_reference(space, static):
    c = SERVE_CTXS["n1"] if space == "serve" else CPU1
    tctx = T.SpaceContext(**c)
    axes = T.train_axes(tctx) if space == "train" else T.serve_axes(tctx)
    valid, refused = T.enumerate_space(space, axes, tctx)
    inc = (T.train_incumbent if space == "train"
           else T.serve_incumbent)(tctx)
    jmake = lambda cand: J.Candidate.make(space, **dict(cand.knobs))  # noqa
    tr = _tune(T, TD, TS, space, valid, refused, inc, static)
    jr = _tune(J, JD, JS, space, [jmake(v) for v in valid],
               [(jmake(v), r) for v, r in refused], jmake(inc), static)
    assert tr.winner.key == jr.winner.key and tr.improved == jr.improved
    assert tr.pruned == jr.pruned
    assert tr.probes_executed == jr.probes_executed > 0
    assert {k: v["score"] for k, v in tr.results.items()} == \
        {k: v["score"] for k, v in jr.results.items()}
    assert tr.probe_ids == jr.probe_ids
    if static:
        assert set(tr.static) == set(jr.static)


def _counter(name, label):
    from paddle_tpu_torch.observability import metrics as om

    fam = om.default_registry().snapshot().get(name, {})
    return sum(r["value"] for r in fam.get("series", [])
               if label in tuple(r.get("labels", ())))


def test_probe_log_resume_counts_nothing_twice(tmp_path):
    """A second tune over the same log executes nothing, moves neither
    counter and names the same winner; every probe ran in an
    ``autotune/probe`` span."""
    from paddle_tpu_torch.observability import spans

    inc = T.Candidate.make("train", name="inc")
    pool = [inc] + [T.Candidate.make("train", name=n) for n in "abc"]
    refused = [(T.Candidate.make("train", name="x"), "invalid:test")]
    path = str(tmp_path / "probes.jsonl")
    p0 = _counter("paddle_autotune_probes_total", "resume_test")
    q0 = _counter("paddle_autotune_pruned_total", "invalid:test")
    n_spans = len([s for s in spans.default_tracer().spans()
                   if s["name"] == "autotune/probe"])
    runs = []
    for _ in range(2):
        log = TD.ProbeLog(path)
        runs.append(TD.tune(
            space="train", candidates=pool, refusals=refused,
            incumbent=inc, phase="resume_test", log=log,
            probe_fn=lambda c, s, r: {"score": _fake_score(c.key, r)},
            rungs=((1, 0.5), (2, 1.0))))
        log.close()
    first, second = runs
    lines = [json.loads(x) for x in Path(path).read_text().splitlines()]
    executed = sum(1 for x in lines if x.get("executed"))
    assert first.probes_executed == executed == 4 + 2 + 1   # inc + ceil(3/2)
    assert second.probes_executed == 0
    assert second.winner.key == first.winner.key
    assert second.pruned == {} and first.pruned["invalid:test"] == 1
    assert _counter("paddle_autotune_probes_total", "resume_test") - p0 == 7
    assert _counter("paddle_autotune_pruned_total", "invalid:test") - q0 == 1
    got = [s for s in spans.default_tracer().spans()
           if s["name"] == "autotune/probe"]
    assert len(got) - n_spans == 7


_KILL_SCRIPT = textwrap.dedent("""\
    import json, os, signal, sys
    sys.path.insert(0, {repo!r})
    from paddle_tpu_torch.tuning import driver
    from paddle_tpu_torch.tuning.space import Candidate

    SCORES = {{"inc": 10.0, "a": 5.0, "b": 6.0, "c": 7.0}}
    inc = Candidate.make("train", name="inc")
    pool = [Candidate.make("train", name=n) for n in "abc"]
    kill_after = int(os.environ.get("KILL_AFTER", "0"))
    executed = [0]

    def probe_fn(cand, steps, rung):
        executed[0] += 1
        if kill_after and executed[0] > kill_after:
            os.kill(os.getpid(), signal.SIGKILL)   # mid-probe, un-catchable
        return {{"score": SCORES[cand.get("name")]}}

    log = driver.ProbeLog(sys.argv[1])
    res = driver.tune(space="train", candidates=[inc] + pool,
                      incumbent=inc, probe_fn=probe_fn,
                      rungs=((1, 0.5), (2, 1.0)), log=log)
    log.close()
    print(json.dumps({{"executed": res.probes_executed,
                       "completed": log.completed_probes,
                       "winner": res.winner.key,
                       "pruned": res.pruned}}))
""")


def test_sigkill_mid_tune_resumes_from_probe_log(tmp_path):
    """SIGKILL mid-tune, then resume: completed probes replay from the
    JSONL without re-running, the total probe count is conserved, a torn
    tail line is skipped, and the winner matches an uninterrupted run
    (the reference's test, on the port's driver)."""
    script = tmp_path / "tune_once.py"
    script.write_text(_KILL_SCRIPT.format(repo=str(REPO)))
    log_path = tmp_path / "probes.jsonl"

    def run(log, **env):
        return subprocess.run([sys.executable, str(script), str(log)],
                              env=dict(os.environ, **env),
                              capture_output=True, text=True, timeout=120)

    ref = run(tmp_path / "ref.jsonl")
    assert ref.returncode == 0, ref.stderr
    clean = json.loads(ref.stdout.strip().splitlines()[-1])
    assert clean["executed"] == clean["completed"] == 7
    killed = run(log_path, KILL_AFTER="3")
    assert killed.returncode == -signal.SIGKILL
    lines = [json.loads(x) for x in log_path.read_text().splitlines()]
    assert len(lines) == 3 and all(x["executed"] for x in lines)
    with open(log_path, "a") as f:
        f.write('{"kind": "probe", "space": "train", "ru')
    resumed = run(log_path)
    assert resumed.returncode == 0, resumed.stderr
    out = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert out["executed"] == 4
    assert out["completed"] == clean["completed"] == 7
    assert out["winner"] == clean["winner"]
    assert out["pruned"] == clean["pruned"]


# ---------------------------------------------------------------------------
# TUNED.json and the appliers
# ---------------------------------------------------------------------------

def _scripted_tunes(pkg, D):
    """The reference's scripted pair of tunes (tests/test_autotune.py)."""
    t_inc = pkg.train_incumbent(pkg.SpaceContext(**CPU_DP2))
    t_win = t_inc.replace(remat="dots", grad_reduce="reduce_scatter",
                          comm_dtype="bf16", bucket_mb=8.0, fused_opt=True,
                          fused_ln=True, ce_vocab_chunk=64)
    scores = {t_inc.key: 10.0, t_win.key: 8.0}
    tr = D.tune(space="train", candidates=[t_inc, t_win], incumbent=t_inc,
                probe_fn=lambda c, s, r: {"score": scores[c.key]},
                rungs=((2, 1.0),))
    s_inc = pkg.serve_incumbent(pkg.SpaceContext(**SERVE_CTXS["n8_b4"]))
    s_win = pkg.Candidate.make(
        "serve", buckets=(8, 16), max_batch=4, kv_layout="paged",
        num_pages=16, fused_decode=False, spec=2, weight_dtype="int8",
        sharding="none", tp=1, disagg="off", disagg_decode_batch=1)
    sscores = {s_inc.key: 4.0, s_win.key: 2.0}
    sr = D.tune(space="serve", candidates=[s_inc, s_win], incumbent=s_inc,
                probe_fn=lambda c, s, r: {"score": sscores[c.key]},
                rungs=((2, 1.0),))
    return {"train": tr, "serve": sr}


CPU_FP = {"platform": "cpu", "device_kind": "cpu", "n_devices": 1,
          "degraded": True}


def test_tuned_doc_roundtrip_and_fingerprint_gate(tmp_path):
    fp = TP.hw_fingerprint(TP.device_info("cpu"))
    assert {k: fp[k] for k in CPU_FP} == CPU_FP
    assert fp == JP.hw_fingerprint(JP.DeviceInfo(**CPU_FP, on_acc=False))
    doc = TT.build_doc(_scripted_tunes(T, TD), fp, args="--test")
    jdoc = JT.build_doc(_scripted_tunes(J, JD), fp, args="--test")
    assert doc["generated_by"] == "paddle_tpu_torch/tools/autotune.py"
    doc["spaces"]["serve"].pop("incumbent")
    jdoc["spaces"]["serve"].pop("incumbent")   # fused_decode differs
    for d in (doc, jdoc):
        d["spaces"]["serve"].pop("incumbent_key")
        d.pop("generated_by")
    assert doc == jdoc
    path = str(tmp_path / "TUNED.json")
    TT.save(path, doc)
    loaded = TT.load(path)
    assert loaded == JT.load(path) == json.loads(json.dumps(doc))
    cpu = TP.device_info("cpu")
    assert TT.load_for_device(path, cpu) is not None  # the CPU's own tune
    # the JAX package's CPU tune is accepted on the CPU, refused under a
    # card's identity
    assert TT.load_for_device(ROOT_TUNED, cpu) is not None
    card = TP.DeviceInfo(platform="gpu", device_kind="NVIDIA H100 80GB HBM3",
                         n_devices=1, on_acc=True, degraded=False)
    with pytest.warns(RuntimeWarning, match="fingerprint mismatch"):
        assert TT.load_for_device(ROOT_TUNED, card) is None
    bad = str(tmp_path / "BAD.json")
    with open(bad, "w") as f:
        json.dump(dict(loaded, version=99), f)
    with pytest.warns(RuntimeWarning, match="unusable"):
        assert TT.load_for_device(bad, cpu) is None
    stamp = TT.config_stamp(loaded, path)
    assert stamp == JT.config_stamp(loaded, path)
    assert stamp["tuned_from"] == {"path": path,
                                   "sha256": TT.file_hash(path)}


class _Mesh:
    def __init__(self, dp, n):
        self.dp, self.n_devices = dp, n


@pytest.mark.parametrize("which", ["scripted", "root"])
def test_appliers_match_reference(which):
    if which == "root":
        with open(ROOT_TUNED) as f:
            doc = json.load(f)
    else:
        doc = JT.build_doc(_scripted_tunes(J, JD), CPU_FP)
    assert TT.train_cfg_kwargs(doc) == JT.train_cfg_kwargs(doc)
    callers = [dict(TT.TRAIN_STEP_DEFAULTS),
               dict(TT.TRAIN_STEP_DEFAULTS, grad_reduce="reduce_scatter",
                    bucket_mb=0.05),
               dict(TT.TRAIN_STEP_DEFAULTS, fused_opt=True)]
    for mesh in (_Mesh(1, 1), _Mesh(2, 2), _Mesh(2, 4)):
        for cur in callers:
            with warnings.catch_warnings(record=True) as tw:
                warnings.simplefilter("always")
                got = TT.resolve_train_step_kwargs(doc, mesh, cur)
            with warnings.catch_warnings(record=True) as jw:
                warnings.simplefilter("always")
                want = JT.resolve_train_step_kwargs(doc, mesh, cur)
            assert got == want
            assert [str(w.message) for w in tw] == \
                [str(w.message) for w in jw]
    fused = doc["spaces"]["serve"]["config"]["fused_decode"]
    for page in (8, 16):
        # the port states fused_decode either way (its EngineConfig
        # defaults to the fused tick, the reference's to the unfused one)
        want = JT.engine_kwargs(doc, page_size=page)
        assert want.get("fused_decode", False) == fused
        assert TT.engine_kwargs(doc, page_size=page) == dict(
            want, fused_decode=fused)
    assert TT.serve_lane_kwargs(doc) == JT.serve_lane_kwargs(doc)
    assert TT.config_stamp(doc) == JT.config_stamp(doc)


def test_resolve_skips_what_the_mesh_cannot_take():
    doc = JT.build_doc(_scripted_tunes(J, JD), CPU_FP)
    from paddle_tpu_torch.parallel import parallelize as PZ

    with pytest.warns(RuntimeWarning, match="dp=1"):
        kw = TT.resolve_train_step_kwargs(doc, PZ.ParallelConfig(),
                                          dict(TT.TRAIN_STEP_DEFAULTS))
    assert kw["grad_reduce"] == "psum" and kw["fused_opt"] is True
    kw = TT.resolve_train_step_kwargs(doc, PZ.ParallelConfig(dp=2),
                                      dict(TT.TRAIN_STEP_DEFAULTS))
    assert kw == {"grad_reduce": "reduce_scatter",
                  "grad_allreduce_dtype": "bf16", "bucket_mb": 8.0,
                  "error_feedback": False, "fused_opt": True}


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------

MICRO = dict(d_model=16, num_layers=1, num_heads=2, d_ff=32, T=8,
             vocab_size=32, batch=2)
# the reference's train-probe result keys (paddle_tpu/tuning/probe.py)
TRAIN_RESULT_KEYS = {"score", "ms_per_step", "tokens_per_s", "compile_s",
                     "loss", "steps", "params", "goodput_compute_s",
                     "report"}


def test_run_train_probe_matches_the_port_step(tmp_path):
    """The train probe on the CPU: the reference's result keys, and its
    loss equal to the port's own ``make_train_step`` over the same steps
    (1 first call + 1 warmup + 2 timed) from the same seed and batch.
    Counting FLOPs fills the report's ``flops``; ``bytes_accessed`` is
    None on the CPU, where no hand kernel launches."""
    from paddle_tpu_torch.parallel import parallelize as PZ

    geom = TP.TrainProbeGeometry(**MICRO)
    for remat, fused in (("none", False), ("dots", True)):
        cand = T.train_incumbent(T.SpaceContext(**CPU1)).replace(
            remat=remat, fused_opt=fused, fused_ln=fused,
            ce_vocab_chunk=16 if fused else 0)
        res = TP.run_train_probe(cand, geom, steps=2, warmup=1, seed=3,
                                 device="cpu", count_flops=True)
        assert set(res) == TRAIN_RESULT_KEYS
        assert set(res["report"]) == {"flops", "bytes_accessed",
                                      "compile_ms", "peak_hbm_bytes"}
        assert res["report"]["flops"] > 0
        assert res["report"]["bytes_accessed"] is None
        assert math.isfinite(res["score"]) and res["steps"] == 2
        cfg = TP.train_probe_config(cand, geom, on_acc=False)
        kw = TP.train_step_kwargs(cand)
        params, opt = PZ.init_sharded(cfg, seed=3, device="cpu", **kw)
        step = PZ.make_train_step(cfg, lr=geom.lr, device="cpu", **kw)
        tok, lab = (torch.from_numpy(a) for a in TP.probe_batch(
            geom, cfg.vocab_size, 3))
        for _ in range(4):
            loss = step(params, opt, tok, lab)[2]
        assert res["loss"] == round(float(loss), 6)
        assert res["params"] == sum(p.numel() for p in
                                    PZ.flat_leaves(params))
    # monitored: one row a timed step, the candidate's key as the config
    mon = tmp_path / "probe_monitor.jsonl"
    TP.run_train_probe(cand, geom, steps=2, monitor=str(mon), device="cpu")
    rows = [json.loads(x) for x in mon.read_text().splitlines() if x]
    assert len([r for r in rows if r.get("loss") is not None]) == 2
    assert any(r.get("config") == cand.key for r in rows)


def test_run_serve_probe_matches_reference(monkeypatch):
    """The serve probe at the reference's geometry and seed: the same
    requests (the same prompts from numpy), none failed, the same number
    of generated tokens; the port's steady-state recompiles read 0."""
    from paddle_tpu.serving import scheduler as JSched

    geom = dict(d_model=16, num_layers=1, num_heads=2, d_ff=32,
                vocab_size=64, max_seq=32, page_size=8, max_new_tokens=4,
                prompt_len_max=6)
    c = dict(n_devices=1, vocab_size=64, max_seq=32, max_batch=2,
             page_size=8)
    seen = []
    submit = JSched.Scheduler.submit

    def spy(self, prompt, *a, **kw):
        req = submit(self, prompt, *a, **kw)
        seen.append((list(prompt), req))
        return req

    monkeypatch.setattr(JSched.Scheduler, "submit", spy)
    for n in (2, 3):
        seen.clear()
        jres = JP.run_serve_probe(J.serve_incumbent(J.SpaceContext(**c)),
                                  JP.ServeProbeGeometry(**geom),
                                  n_requests=n)
        tres = TP.run_serve_probe(T.serve_incumbent(T.SpaceContext(**c)),
                                  TP.ServeProbeGeometry(**geom),
                                  n_requests=n, device="cpu")
        assert tres["requests"] == jres["requests"] == n
        assert tres["failed"] == jres["failed"] == 0
        assert tres["generated_tokens"] == sum(len(r.tokens)
                                               for _, r in seen)
        assert [p for p, _ in seen] == TP.probe_prompts(
            TP.ServeProbeGeometry(**geom), 64, n, 0)
        assert tres["steady_state_recompiles"] == 0 and tres["slo"]["ok"]
        assert set(tres) == set(jres) | {"generated_tokens"}
        assert math.isfinite(tres["score"])


def test_timed_loop_disciplines():
    for pkg in (TP, JP):
        seen = []

        def step_fn(i):
            seen.append(i)
            return i
        t = pkg.timed_loop(step_fn, 3, warmup=2)
        assert seen == [0, 1, 2, 3, 4, 5]
        assert len(t.step_times_s) == 3 and t.steps == 3
        hooked = []
        t = pkg.timed_loop(step_fn, 2, per_step_sync=False,
                           after_compile=lambda: hooked.append(True))
        assert hooked == [True] and t.step_times_s == []
        assert t.values[0] == 0 and len(t.values) == 3


# ---------------------------------------------------------------------------
# make_train_step(tuned=)
# ---------------------------------------------------------------------------

def _train_two_steps(cfg, seed, **kw):
    from paddle_tpu_torch.parallel import parallelize as PZ

    params, opt = PZ.init_sharded(cfg, seed=seed, device="cpu",
                                  **{k: v for k, v in kw.items()
                                     if k != "lr"})
    step = PZ.make_train_step(cfg, lr=1e-3, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    tok, lab = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4, 8)))
                for _ in range(2))
    losses = [float(step(params, opt, tok, lab)[2]) for _ in range(2)]
    return losses, [p.clone() for p in PZ.flat_leaves(params)]


def test_make_train_step_tuned_equals_explicit_kwargs(tmp_path):
    """The root TUNED.json (fused_opt, dots remat) through ``tuned=`` on
    both entry points against the applier's kwargs passed by hand: the
    same losses and params, bitwise, and the flat moments the tuned
    sweep needs; a foreign document warns and changes nothing."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    doc = TT.load(ROOT_TUNED)
    cfg = G.GPT_TINY.scaled(d_model=16, num_layers=1, num_heads=2, d_ff=32,
                            max_seq_len=8, vocab_size=32,
                            **TT.train_cfg_kwargs(doc))
    assert cfg.remat and cfg.remat_policy == "dots"
    kw = TT.resolve_train_step_kwargs(doc, PZ.ParallelConfig(),
                                      dict(TT.TRAIN_STEP_DEFAULTS))
    assert kw["fused_opt"] is True
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = _train_two_steps(cfg, 5, tuned=ROOT_TUNED)
    want = _train_two_steps(cfg, 5, **kw)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    # the opt state follows the document too: flat moments
    _, opt = PZ.init_sharded(cfg, seed=5, device="cpu", tuned=doc)
    assert opt["m"].dim() == 1
    # a foreign document warns and the defaults run: per-leaf moments
    foreign = dict(doc, hw=dict(doc["hw"], platform="gpu"))
    with pytest.warns(RuntimeWarning, match="fingerprint mismatch"):
        _, opt = PZ.init_sharded(cfg, seed=5, device="cpu", tuned=foreign)
    assert isinstance(opt["m"], dict)


def test_tuned_is_gated_on_the_step_device(monkeypatch):
    """The fingerprint is checked against the device the step runs on,
    not the card a host may show: with a card reported visible, a CPU
    step still takes the CPU document (and refuses a card's)."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    def no_card_query(*a, **k):
        raise AssertionError("the CPU step asked for the card's identity")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", no_card_query)
    monkeypatch.setattr(torch.cuda, "device_count", no_card_query)
    doc = TT.load(ROOT_TUNED)
    cfg = G.GPT_TINY.scaled(d_model=16, num_layers=1, num_heads=2, d_ff=32,
                            max_seq_len=8, vocab_size=32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        _, opt = PZ.init_sharded(cfg, seed=5, device="cpu", tuned=doc)
        PZ.make_train_step(cfg, lr=1e-3, device="cpu", tuned=doc)
    assert opt["m"].dim() == 1                # the document's fused_opt
    card = dict(doc, hw=dict(doc["hw"], platform="gpu"))
    with pytest.warns(RuntimeWarning, match="fingerprint mismatch"):
        _, opt = PZ.init_sharded(cfg, seed=5, device="cpu", tuned=card)
    assert isinstance(opt["m"], dict)


def test_the_card_is_the_default_and_refused_without_one(monkeypatch,
                                                         capsys):
    """Without a card, nothing picks the CPU by itself: the probes'
    identity and the hardware model raise for the default device, and
    ``autotune`` exits 2 unless ``--device cpu`` asks for the CPU."""
    from paddle_tpu_torch.tools import autotune as AT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (TP.device_info, TS.HwModel.for_device,
                 lambda: TP.device_info("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert AT.main(["--smoke"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    # --smoke is the tiny geometry, the default the full-width GPT lane
    assert vars(AT.parse_args(["--smoke"]))["d"] == 64
    full = AT.parse_args(["--layers", "2"])
    assert (full.d, full.layers, full.T, full.vocab, full.page_size) == (
        768, 2, 1024, 50304, 16)


# ---------------------------------------------------------------------------
# the CLI end to end
# ---------------------------------------------------------------------------

def test_autotune_smoke_end_to_end(tmp_path):
    """``python -m paddle_tpu_torch.tools.autotune --smoke`` in a
    subprocess on the CPU: a loadable CPU-fingerprinted TUNED.json under
    the run directory, probe counts equal to the log's executed lines,
    every refusal an ``invalid:`` reason with no tp candidate admitted on
    one device, the arbitration run and clean, and the repository root's
    TUNED.json untouched."""
    root_hash = TT.file_hash(ROOT_TUNED)
    out = tmp_path / "run" / "TUNED.json"
    # one intra-op thread: the probes' models are tiny, and on a loaded
    # host a thread pool a process oversubscribes the cores many times
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.autotune", "--smoke",
         "--device", "cpu", "--out", str(out)], cwd=str(REPO),
        capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    doc = TT.load(str(out))
    assert {k: doc["hw"][k] for k in CPU_FP} == CPU_FP
    assert TT.load_for_device(str(out), TP.device_info("cpu")) is not None
    lines = [json.loads(x) for x in
             Path(str(out) + ".probes.jsonl").read_text().splitlines()]
    for space in ("train", "serve"):
        sp = doc["spaces"][space]
        assert sp["probes_executed"] == sum(
            1 for x in lines if x.get("executed") and x["space"] == space)
        refusals = {k: v for k, v in sp["pruned"].items()
                    if k.startswith("invalid:")}
        assert sum(refusals.values()) == sum(
            1 for x in lines if x["kind"] == "pruned" and x["space"] == space
            and x["reason"].startswith("invalid:"))
        assert math.isfinite(sp["score"]["winner_ms"])
    assert "invalid:spec_plus_fused_decode" not in doc["spaces"]["serve"][
        "pruned"]
    assert doc["spaces"]["serve"]["pruned"]["invalid:tp_needs_devices"] > 0
    assert doc["arbitration"]["ran"] and doc["arbitration"]["ok"]
    assert TT.file_hash(ROOT_TUNED) == root_hash
