"""The port's sharding plans and its plan-driven GPT train step against
the JAX package's: ``paddle_tpu_torch.sharding.make_gpt_plan`` gives the
specs and derivation notes of ``paddle_tpu.sharding.make_gpt_plan`` for
every preset and for an annotation dict, and
``make_train_step(sharding=)`` over gloo worlds on the CPU
(``torch_dist_worker``: one world of 2 ranks and one of 4) tracks the
JAX ``make_train_step(sharding=)`` on the conftest's 8-device CPU mesh
over 3 steps at lr 1e-2, from the same params and batch: losses within
rtol 2e-4, grad norms within 1e-3, params within 2e-4 + 2e-3·|p|,
moments within 1e-3 in the relative 2-norm (the bars of
``test_torch_parallel_step.py``).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu import sharding as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.parallel import parallelize as JPZ

from paddle_tpu_torch import sharding as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.parallel import comm_opt as TC
from paddle_tpu_torch.parallel import parallelize as TPZ

import torch_dist_worker as W

# vocab == d_ff and max_seq == vocab on purpose: b_fc inherits from
# lm_head under fsdp, wpe from wte, and b_fc's tp candidates tie (so the
# plan keeps it whole and the step cuts its Megatron block)
CFG_KW = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=32, d_ff=64)
T, B, LR, STEPS = 32, 8, 1e-2, 3

# (mode, dp, tp) of each sharded run, by world size: one world a size
RUNS = {2: [("fsdp", 2, 1), ("dp", 2, 1), ("tp", 1, 2)],
        4: [("fsdp", 4, 1), ("dp+tp", 2, 2), ("fsdp", 2, 2), ("dp", 2, 2)]}


def _jcfg():
    return JG.GPT_TINY.scaled(**CFG_KW)


def _tcfg():
    return TG.GPT_TINY.scaled(**CFG_KW)


def _specs_of(jplan):
    return {path: tuple(TS.normalize_spec(tuple(s))) for path, s in (
        ("/".join(str(k.key) for k in p), s) for p, s in
        jax.tree_util.tree_flatten_with_path(
            jplan.param_specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])}


def _port_specs(tplan):
    from paddle_tpu_torch.sharding.plan import _flatten

    return dict(_flatten(tplan.param_specs))


CONFIGS = {"tiny": (JG.GPT_TINY, TG.GPT_TINY),
           "small": (JG.GPT_SMALL, TG.GPT_SMALL),
           "test": (_jcfg(), _tcfg())}


@pytest.mark.parametrize("layout", [(2, 1), (4, 1), (1, 2)],
                         ids=["dp2", "dp4", "tp2"])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", list(TS.PRESETS))
def test_plan_equals_jax(mode, config, layout):
    jcfg, tcfg = CONFIGS[config]
    dp, tp = layout
    jplan = JS.make_gpt_plan(jcfg, JPZ.ParallelConfig(dp=dp, tp=tp), mode)
    tplan = TS.make_gpt_plan(tcfg, TPZ.ParallelConfig(dp=dp, tp=tp), mode)
    assert _port_specs(tplan) == _specs_of(jplan)
    assert tplan.derived == jplan.derived
    assert tplan.report() == jplan.report()
    assert tplan.data_spec == tuple(jplan.data_spec)
    assert tplan.mesh_sizes == jplan.mesh_sizes
    assert tplan.params_replicated_over("dp") == \
        jplan.params_replicated_over("dp")


def test_small_fsdp_notes():
    """GPT_SMALL under fsdp: the notes the reference gives its
    unannotated leaves."""
    plan = TS.make_gpt_plan(TG.GPT_SMALL, TPZ.ParallelConfig(dp=2), "fsdp")
    amb = "replicated(ambiguous:blocks/w_out,blocks/w_proj,wte)"
    for leaf in ("wpe", "ln_f_scale", "ln_f_bias", "blocks/ln1_scale",
                 "blocks/b_proj", "blocks/b_out"):
        assert plan.derived[leaf] == amb, leaf
    assert plan.derived["blocks/b_fc"] == "inherited:blocks/w_fc"


def test_custom_annotations_equal_jax():
    ann = {"wte": ("dp", None), "blocks/w_fc": (None, None, "tp"),
           "blocks/w_out": (None, "tp")}
    jplan = JS.resolve_plan(ann, JG.GPT_SMALL, JPZ.ParallelConfig(dp=2,
                                                                   tp=2))
    tplan = TS.resolve_plan(ann, TG.GPT_SMALL, TPZ.ParallelConfig(dp=2,
                                                                   tp=2))
    assert tplan.mode == jplan.mode == "custom"
    assert _port_specs(tplan) == _specs_of(jplan)
    assert tplan.derived == jplan.derived


def test_indivisible_and_unknown_annotations_raise_as_jax():
    for ann in ({"wte": (None, "dp")}, {"nope": ()}):
        with pytest.raises(ValueError) as je:
            JS.resolve_plan(ann, _jcfg(), JPZ.ParallelConfig(dp=3))
        with pytest.raises(ValueError) as te:
            TS.resolve_plan(ann, _tcfg(), TPZ.ParallelConfig(dp=3))
        assert str(te.value) == str(je.value)
    with pytest.raises(TypeError):
        TS.resolve_plan(3, _tcfg(), TPZ.ParallelConfig())


def test_spec_helpers_equal_jax():
    from paddle_tpu.sharding import spec as JSP

    specs = [(), None, "dp", ("dp", None), (("dp", "tp"), None, ["tp"]),
             [None, ("pp",)]]
    for s in specs:
        for fn in ("normalize_spec", "spec_to_json", "spec_axes",
                   "is_replicated", "spec_str"):
            assert getattr(TS, fn)(s) == getattr(JSP, fn)(s), (fn, s)
        assert TS.pad_spec(s, 4) == JSP.pad_spec(s, 4)
        assert TS.spec_from_json(TS.spec_to_json(s)) == \
            JSP.spec_from_json(JSP.spec_to_json(s))
    assert TS.merge_specs(("dp", None), (None, "tp")) == ("dp", "tp")
    with pytest.raises(TS.SpecConflict) as te:
        TS.merge_specs(("dp",), ("tp",))
    with pytest.raises(JSP.SpecConflict) as je:
        JSP.merge_specs(("dp",), ("tp",))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("mode", ["tp", "dp+tp"])
def test_tp_presets_are_the_megatron_split(mode):
    """At pp 1 the tp presets' specs are ``G.param_specs``' split, so
    every tp leaf runs on the sequence-parallel block path as it is."""
    cfg = TG.GPT_SMALL
    plan = TS.make_gpt_plan(cfg, TPZ.ParallelConfig(dp=2, tp=2), mode)
    meg = TPZ.flat_leaves(TG.param_specs(cfg, pp=None, tp="tp"))
    for lp, m in zip(TPZ.plan_layout(cfg, TPZ.ParallelConfig(dp=2, tp=2),
                                     plan), meg):
        assert lp.spec == TS.pad_spec(m, len(lp.spec)), lp.path
        assert lp.tp_cut is None and lp.dp_dim is None


def test_non_megatron_tp_entry_is_refused():
    pcfg = TPZ.ParallelConfig(tp=2)
    plan = TS.resolve_plan({"blocks/w_fc": (None, "tp", None)}, _tcfg(),
                           pcfg)
    with pytest.raises(NotImplementedError, match="blocks/w_fc"):
        TPZ.plan_layout(_tcfg(), pcfg, plan)
    plan = TS.resolve_plan({"wte": (("dp", "tp"), None)}, _tcfg(),
                           TPZ.ParallelConfig(dp=2, tp=2))
    with pytest.raises(NotImplementedError, match="several mesh axes"):
        TPZ.plan_layout(_tcfg(), TPZ.ParallelConfig(dp=2, tp=2), plan)


def _jax_refusal(**kw):
    pcfg = JPZ.ParallelConfig(**kw.pop("pcfg"))
    with pytest.raises(NotImplementedError) as e:
        JPZ.make_train_step(_jcfg(), pcfg, JPZ.build_mesh(pcfg), **kw)
    return str(e.value)


def test_reference_refusals_raise_in_the_port():
    """pp > 1 with a plan, and comm levers with a plan that shards over
    dp, raise with the reference's messages; ``tuned=`` (the JAX
    package's CPU TUNED.json, accepted by a CPU step) is applied before
    the plan's own checks; a dp-replicated plan with comm levers takes the comm_opt
    path (no plan)."""
    cases = [dict(pcfg=dict(dp=2, pp=2), sharding="dp"),
             dict(pcfg=dict(dp=2), sharding="fsdp",
                  grad_reduce="reduce_scatter"),
             dict(pcfg=dict(dp=2), sharding="fsdp",
                  grad_allreduce_dtype="bf16")]
    for case in cases:
        want = _jax_refusal(**dict(case))
        kw = dict(case)
        pcfg = TPZ.ParallelConfig(**kw.pop("pcfg"))
        with pytest.raises(NotImplementedError) as e:
            TPZ.make_train_step(_tcfg(), pcfg, None, **kw)
        assert str(e.value) == want
    root_tuned = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "TUNED.json")
    with pytest.raises(ValueError, match="mesh"):
        TPZ.make_train_step(_tcfg(), TPZ.ParallelConfig(), None,
                            sharding="dp", tuned=root_tuned, device="cpu")
    ccfg = TC.CommConfig(grad_reduce="reduce_scatter")
    assert TPZ._sharding_route("dp", _tcfg(), TPZ.ParallelConfig(dp=2),
                               None, ccfg) is None
    with pytest.raises(ValueError, match="mesh"):
        TPZ.make_train_step(_tcfg(), TPZ.ParallelConfig(dp=2), None,
                            sharding="fsdp")


def _data():
    rng = np.random.default_rng(11)
    return (rng.integers(0, CFG_KW["vocab_size"], (1, B, T)).astype(np.int32),
            rng.integers(0, CFG_KW["vocab_size"], (1, B, T)).astype(np.int32))


@pytest.fixture(scope="module")
def init():
    params = JG.init_params(jax.random.PRNGKey(0), _jcfg())
    return params, jax.tree_util.tree_map(np.asarray, params)


_ORACLE = {}


def jax_run(mode, dp, tp, params):
    """(losses, gnorms, params, m, v) of STEPS JAX steps of
    ``make_train_step(sharding=mode)`` on a dp x tp mesh."""
    key = (mode, dp, tp)
    if key not in _ORACLE:
        cfg = _jcfg()
        pcfg = JPZ.ParallelConfig(dp=dp, tp=tp)
        mesh = JPZ.build_mesh(pcfg)
        p, opt = JPZ.init_sharded(jax.random.PRNGKey(0), cfg, pcfg, mesh,
                                  sharding=mode)
        p = jax.tree_util.tree_map(
            lambda a, b: jax.device_put(jnp.asarray(a), b.sharding),
            params, p)
        step = JPZ.make_train_step(cfg, pcfg, mesh, lr=LR, sharding=mode)
        tokens, labels = _data()
        losses, gnorms = [], []
        for _ in range(STEPS):
            p, opt, loss, gnorm = step(p, opt, tokens, labels)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
        flat = [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]
        _ORACLE[key] = (losses, gnorms, flat,
                        [np.asarray(x) for x in jax.tree_util.tree_leaves(
                            opt["m"])],
                        [np.asarray(x) for x in jax.tree_util.tree_leaves(
                            opt["v"])])
    return _ORACLE[key]


def _block(x, spec, coords, sizes):
    for d, entry in enumerate(spec):
        if entry is None or sizes[entry] == 1:
            continue
        n = x.shape[d] // sizes[entry]
        i = coords[entry]
        x = x[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
    return x


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, init):
    """{(mode, dp, tp): the ranks' records} of every run of RUNS."""
    tokens, labels = _data()
    out = {}
    for n, runs in RUNS.items():
        layouts = {}
        for mode, dp, tp in runs:
            layouts.setdefault((dp, tp), []).append(mode)
        jobs = [("sharded_worker", (CFG_KW, dict(dp=dp, tp=tp), init[1],
                                    tokens, labels, modes, STEPS, LR))
                for (dp, tp), modes in layouts.items()]
        ranks = W.spawn(W.jobs_worker, n, jobs,
                        out_dir=str(tmp_path_factory.mktemp(f"world{n}")))
        for i, ((dp, tp), modes) in enumerate(layouts.items()):
            for mode in modes:
                out[(mode, dp, tp)] = [dict(r[i][mode], coords=r[i]["coords"])
                                       for r in ranks]
    return out


def _rel(got, want):
    num = sum(float(np.sum(np.square(a - b))) for a, b in zip(got, want))
    den = sum(float(np.sum(np.square(b))) for b in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("run", [r for rs in RUNS.values() for r in rs],
                         ids=lambda r: f"{r[0]}-dp{r[1]}tp{r[2]}")
def test_sharded_step_tracks_jax(worlds, init, run):
    mode, dp, tp = run
    losses, gnorms, params, m, v = jax_run(mode, dp, tp, init[0])
    sizes = {"dp": dp, "pp": 1, "tp": tp}
    plan = TS.make_gpt_plan(_tcfg(), TPZ.ParallelConfig(dp=dp, tp=tp), mode)
    specs = TPZ.flat_leaves(plan.param_specs)
    for r in worlds[run]:
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-4)
        np.testing.assert_allclose(r["gnorms"], gnorms, rtol=1e-3)
        for i, (x, s) in enumerate(zip(params, specs)):
            np.testing.assert_allclose(
                r["params"][i], _block(x, s, r["coords"], sizes),
                rtol=2e-3, atol=2e-4, err_msg=f"{r['coords']} leaf {i}")
        for k, want in (("m", m), ("v", v)):
            assert _rel(r[k], [_block(x, s, r["coords"], sizes)
                               for x, s in zip(want, specs)]) <= 1e-3, k
        assert r["report_name"] == (f"parallel_train_step/dp{dp}pp1tp{tp}"
                                    f"mb1_gspmd-{mode}")
    assert worlds[run][0]["losses"][-1] < worlds[run][0]["losses"][0]


@pytest.mark.parametrize("dp", [2, 4])
def test_fsdp_residency_and_wire_bytes(worlds, dp):
    """Each fsdp rank holds at most total/dp of the params plus the
    plan's dp-replicated tail (the moments twice that), and its wire
    bytes a step are the ring model's: an all-gather and a reduce-scatter
    of every dp-sharded leaf at full size, a psum of every replicated
    leaf's grad and of the loss."""
    cfg = _tcfg()
    plan = TS.make_gpt_plan(cfg, TPZ.ParallelConfig(dp=dp), "fsdp")
    shapes = TPZ.flat_leaves(TG.param_shapes(cfg))
    specs = TPZ.flat_leaves(plan.param_specs)
    total = 4 * sum(int(np.prod(s)) for s in shapes)
    tail = 4 * sum(int(np.prod(sh)) for sh, s in zip(shapes, specs)
                   if "dp" not in s)
    want = {}

    def add(op, payload):
        want[op] = want.get(op, 0) + STEPS * TC.wire_bytes(op, payload, dp)

    add("psum", 4)
    for sh, s in zip(shapes, specs):
        nbytes = 4 * int(np.prod(sh))
        if "dp" in s:
            add("all_gather", nbytes)
            add("psum_scatter", nbytes)
        else:
            add("psum", nbytes)
    for r in worlds[("fsdp", dp, 1)]:
        assert r["param_bytes"] <= total / dp + tail
        assert r["moment_bytes"] <= 2 * (total / dp + tail)
        assert r["param_bytes"] < total / dp * 1.1 + tail
        assert r["wire"] == {f"{k}/float32": v for k, v in want.items()}
