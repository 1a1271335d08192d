"""The port's roofline attribution and perf sentinel against the JAX
package's (``paddle_tpu_torch/observability/attribution.py``,
``baseline.py``, ``tools/profile_step.py``, ``tools/perf_diff.py``):

- the reference's synthetic rows and artifacts
  (``tests/test_attribution.py:118-290``) give the same documents and
  verdicts in both packages, time stamps aside, and each package's
  ``validate`` accepts the other's document and rejects the same bad
  ones;
- ``profile_step --smoke`` on the CPU: both packages validate its
  document, the A/A pair diffs clean on the degraded lane, the seeded
  remat regression is flagged and attributed to ``remat`` with the
  step's FLOPs moved (the port's twins of the reference's smoke tests);
- the counted matrix-product FLOPs of a tiny GPT's forward and backward
  equal the dot FLOPs of ``jax.value_and_grad(loss_fn)``'s HLO, product
  by product.
"""
import copy
import io
import json
import os
import random

import numpy as np
import pytest
import torch

import test_attribution as RT          # the reference's synthetic rows
from paddle_tpu.observability import attribution as JATT
from paddle_tpu.observability import baseline as JB
from paddle_tpu_torch.observability import attribution as ATT
from paddle_tpu_torch.observability import baseline as B
from paddle_tpu_torch.tools import perf_diff
from paddle_tpu_torch.tools import profile_step as PS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _NoSeries:
    def snapshot(self):
        return {}


@pytest.fixture
def quiet_registries(monkeypatch):
    """Both packages' ``build`` stamp their registry's recompile counts:
    the same (empty) registry in both, whatever ran earlier in the
    process."""
    import paddle_tpu.observability.metrics as JM
    import paddle_tpu_torch.observability.metrics as TM

    monkeypatch.setattr(JM, "default_registry", lambda: _NoSeries())
    monkeypatch.setattr(TM, "default_registry", lambda: _NoSeries())


def _strip(doc, keys=("generated_at", "created_at")):
    return json.dumps({k: v for k, v in doc.items() if k not in keys},
                      sort_keys=True)


def _build(mod, rows, **kw):
    base = dict(steps=2, wall_ms_per_step=0.003, peak_flops=RT.PEAK_F,
                peak_hbm_bytes_per_s=RT.PEAK_B)
    base.update(kw)
    return mod.build(copy.deepcopy(rows), **base)


# ---------------------------------------------------------------------------
# (b) the documents and verdicts of both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_build_equals_reference(seed, quiet_registries):
    rows = RT._synthetic_rows()
    random.Random(seed).shuffle(rows)
    kw = dict(step_flops=1e6, step_bytes=1.2e4, config={"remat": "dots"},
              programs=[{"program": "p", "flops": 1e6}])
    mine, ref = _build(ATT, rows, **kw), _build(JATT, rows, **kw)
    assert _strip(mine) == _strip(ref)
    assert ATT.SCHEMA_VERSION == JATT.SCHEMA_VERSION
    for a, b in ((ATT, ref), (JATT, mine)):
        a.validate(b, require_residue=True)


def test_validate_rejects_the_same_docs(quiet_registries):
    doc = _build(ATT, RT._synthetic_rows())
    bads = []
    for key, path, val in (("schema", ("schema_version",), 99),
                           ("fraction", ("fusions", 0, "roofline_fraction"),
                            1.7),
                           ("nan", ("gap_share",), float("nan")),
                           ("mode", ("mode",), "serve")):
        bad = json.loads(json.dumps(doc))
        tgt = bad
        for p in path[:-1]:
            tgt = tgt[p]
        tgt[path[-1]] = val
        bads.append(bad)
    bad = json.loads(json.dumps(doc))
    bad["fusions"] = []
    bads.append(bad)
    for bad in bads:
        for mod in (ATT, JATT):
            with pytest.raises(AssertionError):
                mod.validate(bad)
    lone = _build(ATT, [RT._synthetic_rows()[0]], steps=1,
                  wall_ms_per_step=0.01)
    for mod in (ATT, JATT):
        mod.validate(lone)
        with pytest.raises(AssertionError):
            mod.validate(lone, require_residue=True)


def _attr(mod, flops=1e6, remat="full", fused_opt=True, slow=None):
    rows = RT._synthetic_rows()
    if slow:
        for r in rows:
            if r["name"] == slow:
                r["ns"] *= 3.0
    return mod.build(
        rows, steps=2, wall_ms_per_step=0.003, peak_flops=RT.PEAK_F,
        peak_hbm_bytes_per_s=RT.PEAK_B, step_flops=flops, step_bytes=1.2e4,
        programs=[{"program": "parallel_train_step", "flops": flops,
                   "bytes_accessed": 1.2e4, "compile_ms": 100.0}],
        config={"mode": "train", "remat": remat, "fused_opt": fused_opt})


CASES = {
    "aa": dict(),
    "remat": dict(flops=1.3e6, remat="dots"),
    "fused_opt": dict(flops=1.05e6, fused_opt=False),
    "slow": dict(slow="fusion.2"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("lane,degraded", [("cpu_smoke", True),
                                           ("gpu", False)])
def test_sentinel_verdicts_equal_reference(case, lane, degraded,
                                           quiet_registries):
    reps = []
    for mod, bmod in ((ATT, B), (JATT, JB)):
        base = bmod.make_baseline({"attribution": _attr(mod)}, lane=lane,
                                  degraded=degraded)
        cur = {"attribution": _attr(mod, **CASES[case])}
        reps.append((base, bmod.compare(cur, base)))
    (mb, mr), (jb, jr) = reps
    assert _strip(mb) == _strip(jb)
    assert _strip(mr) == _strip(jr)
    if case == "aa":
        assert mr["ok"]
    if case in ("remat", "fused_opt"):
        assert not mr["ok"]
        lever = CASES[case].get("remat") and "remat" or "fused_opt"
        assert any(c["lever"] == lever for c in mr["config_changes"])
    # each package's report compares the other's artifacts alike
    cross = B.compare({"attribution": _attr(JATT, **CASES[case])}, jb)
    assert _strip(cross) == _strip(jr)


def test_compare_goodput_equals_reference():
    a = {"wall_s": 100.0, "categories": {"productive_step": 90.0,
                                         "compile": 6.0, "other": 4.0}}
    for b in (json.loads(json.dumps(a)),
              {"wall_s": 100.0, "categories": {"productive_step": 70.0,
                                               "compile": 26.0,
                                               "other": 4.0}},
              {"wall_s": 80.0, "categories": {"productive_step": 75.0,
                                              "data_wait": 5.0}}):
        assert B.compare_goodput(a, b) == JB.compare_goodput(a, b)
        assert B.compare_goodput(a, b, 0.1, 0.0) == \
            JB.compare_goodput(a, b, 0.1, 0.0)


# ---------------------------------------------------------------------------
# (e) profile_step --smoke on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """Two captures of one warmed smoke step (remat full), and the same
    spec with remat=dots: the reference's smoke triple."""
    td = tmp_path_factory.mktemp("attr")
    a, b = PS.train_profile(PS.SMOKE_SPEC, str(td / "aa"), steps=3, runs=2,
                            device="cpu")
    dots = PS.train_profile(PS.SMOKE_SPEC + ",remat=dots",
                            str(td / "dots"), steps=3, device="cpu")
    return {"a": a["attribution"], "b": b["attribution"],
            "dots": dots["attribution"], "dir": td, "rec": a}


def test_smoke_attribution_schema_and_residue(smoke_runs):
    doc = smoke_runs["a"]
    ATT.validate(doc, require_residue=True)
    JATT.validate(doc, require_residue=True)
    assert doc["degraded"] is True and doc["backend"] == "cpu"
    assert doc["source"] == "cpu_ops"
    assert doc["mode"] == "train" and doc["steps"] == 3
    assert doc["step"]["flops"] and doc["step"]["flops"] > 0
    assert doc["programs"][0]["program"] == "parallel_train_step/dp1pp1tp1mb1"
    assert "elementwise" in {g["label"] for g in doc["residue"]["groups"]}
    mm = [f for f in doc["fusions"] if f["name"] == "aten::bmm"]
    assert mm and mm[0]["label"] == "matmul" and mm[0]["flops"] > 0
    rec = smoke_runs["rec"]
    # the rows add up to the busy union; the CPU runs no hand kernel
    assert sum(r["ns"] for r in rec["rows"]) == pytest.approx(
        rec["busy_union_ns"], rel=1e-9)
    assert rec["launches"] == {} and rec["costs"] == {}
    # the written documents: ATTRIBUTION.json and PROFILE_STEP.json
    written = json.loads((smoke_runs["dir"] / "aa" /
                          "ATTRIBUTION.json").read_text())
    JATT.validate(written)
    prof = json.loads((smoke_runs["dir"] / "aa" /
                       "PROFILE_STEP.json").read_text())
    assert prof["rows"] and prof["device_busy_ms_per_step"] > 0


def test_aa_two_smoke_runs_diff_clean(smoke_runs):
    base = B.make_baseline({"attribution": smoke_runs["a"]},
                           lane="cpu_smoke")
    assert base["degraded"] is True
    report = B.compare({"attribution": smoke_runs["b"]}, base)
    assert report["out_of_band"] == [] and \
        report["structural_failures"] == [], report
    assert report["ok"] and not report["config_changes"]
    assert report["checked"] > 10


def test_seeded_remat_regression_flagged_and_attributed(smoke_runs):
    base = B.make_baseline({"attribution": smoke_runs["a"]},
                           lane="cpu_smoke")
    report = B.compare({"attribution": smoke_runs["dots"]}, base)
    assert not report["ok"]
    assert any(c["lever"] == "remat" and c["value"] == "dots"
               for c in report["config_changes"])
    flagged = report["out_of_band"] + report["structural_failures"]
    assert [b for b in flagged if b["cause"]["kind"] == "config_lever"
            and "remat" in b["cause"]["detail"]], flagged
    oob = {b["metric"]: b for b in report["out_of_band"]}
    assert "attribution.step.flops" in oob
    # remat=dots recomputes fewer matrix products
    assert oob["attribution.step.flops"]["value"] < \
        oob["attribution.step.flops"]["baseline"]
    # and the reference's sentinel says the same of the port's documents
    jrep = JB.compare({"attribution": smoke_runs["dots"]},
                      JB.make_baseline({"attribution": smoke_runs["a"]},
                                       lane="cpu_smoke"))
    assert {b["metric"] for b in jrep["out_of_band"]} == set(oob)


def test_perf_diff_cli_on_a_run_dir(smoke_runs, tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    ATT.write(smoke_runs["a"], str(run / "ATTRIBUTION.json"))
    assert perf_diff.main(["--dir", str(run), "--update-baseline"]) == 0
    base = json.loads((run / "PERF_BASELINE.json").read_text())
    assert base["lane"] == "cpu_smoke" and base["degraded"] is True
    ATT.write(smoke_runs["b"], str(run / "ATTRIBUTION.json"))
    assert perf_diff.main(["--dir", str(run)]) == 0
    assert json.loads((run / "REGRESSION.json").read_text())["ok"]
    ATT.write(smoke_runs["dots"], str(run / "ATTRIBUTION.json"))
    assert perf_diff.main(["--dir", str(run)]) == 1
    assert perf_diff.main(["--dir", str(tmp_path / "empty")]) == 2


def test_profile_step_compare_and_refusals(smoke_runs, tmp_path):
    a, d = tmp_path / "a.json", tmp_path / "d.json"
    ATT.write(smoke_runs["a"], str(a))
    ATT.write(smoke_runs["dots"], str(d))
    buf = io.StringIO()
    rows = PS.compare_attributions(str(a), str(d), out=buf)
    assert rows and "CONFIG remat: 'full' -> 'dots'" in buf.getvalue()
    with pytest.raises(NotImplementedError, match="tuning/"):
        PS.main(["--smoke", "--tuned", "TUNED.json"])
    with pytest.raises(SystemExit):
        PS.parse_spec("d=32,zz=1")


def test_serve_smoke_attribution(tmp_path):
    rec = PS.serve_profile(str(tmp_path), ticks=3, kv_layout="paged",
                           weight_dtype="f32", max_batch=2, device="cpu",
                           smoke=True, role="decode")
    doc = rec["attribution"]
    ATT.validate(doc)
    JATT.validate(doc)
    assert doc["mode"] == "decode" and doc["config"]["disagg"] == 1
    assert doc["programs"][0]["program"] == "serve/decode"
    assert (tmp_path / "ATTRIBUTION_DECODE.json").exists()


# ---------------------------------------------------------------------------
# (f) matrix-product FLOPs against the reference's HLO dots
# ---------------------------------------------------------------------------

_MM = ("mm", "bmm", "addmm", "baddbmm")


class _Products(torch.utils._python_dispatch.TorchDispatchMode):
    """Each matrix product an op runs: (op, input shapes, 2 M N K)."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _MM:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            self.rows.append((name, [tuple(x.shape) for x in args
                                     if isinstance(x, torch.Tensor)],
                              2 * out.numel() * a.shape[-1]))
        return out


def _jax_dots(cfg_kw):
    import jax
    import jax.numpy as jnp
    from jax._src.lib import xla_client as xc

    from paddle_tpu.models import gpt as JG

    cfg = JG.GPTConfig(**cfg_kw, dtype=jnp.float32, scan_layers=False)
    params = JG.init_params(jax.random.PRNGKey(0), cfg)
    tok = jnp.asarray(np.arange(32).reshape(2, 16) % cfg.vocab_size,
                      jnp.int32)
    lab = jnp.roll(tok, -1, axis=1)
    f = jax.jit(jax.value_and_grad(lambda p: JG.loss_fn(p, tok, lab, cfg)))
    mod = f.lower(params).compile().runtime_executable().hlo_modules()[0]
    opts = xc._xla.HloPrintOptions()
    opts.print_operand_shape = True       # the costs parse operand shapes
    opts.print_percent = True
    opts.print_metadata = True
    costs = JATT.hlo_instruction_costs(mod.to_string(opts))
    return [(k, v["flops"]) for k, v in costs.items()
            if v["opcode"] == "dot"]


def test_matmul_flops_equal_reference_hlo_dots(monkeypatch):
    """The plain configuration (no flash, no remat, direct CE) of a tiny
    GPT: the port's counted products of one forward and backward equal
    the dots of the reference's HLO, product by product, at 2 M N K."""
    from torch.utils.flop_counter import FlopCounterMode

    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    kw = dict(vocab_size=64, max_seq_len=16, num_layers=2, num_heads=2,
              d_model=32, d_ff=64, remat=False, use_flash=False)
    jax_dots = _jax_dots(kw)
    cfg = G.GPTConfig(**kw, dtype=torch.float32)
    params = G.init_params(cfg, seed=0, device="cpu")

    def grad_leaves(t):
        if isinstance(t, dict):
            return {k: grad_leaves(v) for k, v in t.items()}
        if isinstance(t, list):
            return [grad_leaves(v) for v in t]
        return t.detach().requires_grad_(t.is_floating_point())

    params = grad_leaves(params)
    tok = torch.arange(32).reshape(2, 16) % cfg.vocab_size
    lab = torch.roll(tok, -1, dims=1)
    prods, counter = _Products(), FlopCounterMode(display=False)
    with counter, prods:
        G.loss_fn(params, tok, lab, cfg).backward()
    mine = sorted(f for _n, _s, f in prods.rows)
    ref = sorted(f for _n, f in jax_dots)
    if mine != ref:
        left = list(ref)
        extra = []
        for n, shapes, f in prods.rows:
            if f in left:
                left.remove(f)
            else:
                extra.append(f"port {n}{shapes} = {f}")
        missing = [f"reference {k} = {f}" for k, f in jax_dots if f in left]
        pytest.fail("products differ: " + "; ".join(extra + missing))
    assert counter.get_total_flops() == sum(ref)
    # the train step's program report counts the same work
    from paddle_tpu_torch.framework import core

    monkeypatch.setitem(core._GLOBAL_FLAGS, "FLAGS_program_report_flops",
                        True)
    pz_params, opt = PZ.init_sharded(cfg, seed=0, device="cpu")
    step = PZ.make_train_step(cfg, lr=1e-3, device="cpu")
    from paddle_tpu_torch.observability import program_report as PREP

    step(pz_params, opt, tok[None], lab[None])
    rep = PREP.recent_reports()[-1]
    assert rep["program"] == step.report_name
    assert rep["flops"] == sum(ref)
