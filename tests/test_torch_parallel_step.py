"""The port's multi-rank train step (``make_train_step`` with a mesh)
against an oracle step made of the JAX package's pieces: the grads of
single-device ``jax.value_and_grad`` of the reference test's
``_reference_loss`` (the sum the JAX per-rank loss adds up to, held
against ``_pipeline_loss`` itself in ``test_torch_parallel.py``) and the
reference's ``PZ._adamw_update`` (with its ``_clip_scale``) on the full
leaves, 3 steps at lr 1e-2. Each case spawns a gloo world on the CPU
(``torch_dist_worker``). Losses within the reference's rtol 2e-4;
params within 2e-4 + 2e-3·|p| (Adam's step is lr·m/sqrt(v), so a
gradient that differs by float association moves a param by a small
multiple of lr·rtol).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.models import gpt as JG
from paddle_tpu.parallel import parallelize as JPZ

import torch
import torch_dist_worker as W

CFG_KW = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=32, d_ff=64)
T, LR, STEPS = 32, 1e-2, 3


def _jcfg():
    return JG.GPT_TINY.scaled(**CFG_KW)


def _data(m, b, seed=7):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG_KW["vocab_size"], (m, b, T)).astype(np.int32)
    labels = rng.integers(0, CFG_KW["vocab_size"], (m, b, T)).astype(np.int32)
    return tokens, labels


def _reference_loss(params, tokens, labels, cfg):
    tot = 0.0
    for i in range(tokens.shape[0]):
        tot = tot + JG.token_ce(JG.forward(params, tokens[i], cfg), labels[i])
    return tot / labels.size


_vg = jax.jit(jax.value_and_grad(_reference_loss), static_argnums=3)
_update = jax.jit(functools.partial(JPZ._adamw_update, lr=LR,
                                    weight_decay=0.1, grad_clip=1.0))
_ORACLE = {}


def oracle(params, tokens, labels, moment_dtype=None):
    """(losses, gnorms, params) of STEPS oracle steps (one computation a
    batch and moment dtype, kept for the module's tests)."""
    key = (tokens.tobytes(), labels.tobytes(), str(moment_dtype))
    if key not in _ORACLE:
        cfg = _jcfg()
        opt = JPZ.init_adamw_state(params, moment_dtype=moment_dtype)
        losses, gnorms = [], []
        for _ in range(STEPS):
            loss, grads = _vg(params, jnp.asarray(tokens),
                              jnp.asarray(labels), cfg)
            params, opt, gnorm = _update(params, grads, opt)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
        _ORACLE[key] = (losses, gnorms, params)
    return _ORACLE[key]


def local_block(x, spec, coords, sizes):
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = x.shape[d] // sizes[entry]
        i = coords[entry]
        x = x[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
    return x


def _specs():
    return jax.tree_util.tree_leaves(JG.param_specs(_jcfg()),
                                     is_leaf=lambda x: isinstance(x, P))


@pytest.fixture(scope="module")
def init():
    params = JG.init_params(jax.random.PRNGKey(0), _jcfg())
    return params, jax.tree_util.tree_map(np.asarray, params)


def step_job(pnp, layout, runs, m=1, b=8):
    """A ``step_worker`` job training each run of ``runs`` ({name: (step
    kwargs, nan step)}) in turn, with its batch."""
    dp, pp, tp = layout
    tokens, labels = _data(m, b)
    return ("step_worker", (
        CFG_KW, dict(dp=dp, pp=pp, tp=tp, microbatches=m), pnp, tokens,
        labels, [dict(step_kw=dict(lr=LR, **kw), steps=STEPS, nan_step=nan)
                 for kw, nan in runs.values()])), list(runs), tokens, labels


def check(ranks, layout, want, loss_rtol=2e-4):
    losses, gnorms, params = want
    sizes = dict(zip(("dp", "pp", "tp"), layout))
    flat = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=loss_rtol)
        np.testing.assert_allclose(r["gnorms"], gnorms, rtol=1e-3)
        for i, (x, s) in enumerate(zip(flat, _specs())):
            np.testing.assert_allclose(
                r["params"][i], local_block(x, tuple(s), r["coords"], sizes),
                rtol=2e-3, atol=2e-4, err_msg=f"{r['coords']} leaf {i}")


RS = dict(grad_reduce="reduce_scatter")
DP2_RUNS = {
    "psum-dp2": ({}, None),
    "rs-fused-dp2": (dict(RS, fused_opt=True, bucket_mb=0.01), None),
    "rs-fused-bf16-moments": (dict(RS, fused_opt=True,
                                   moment_dtype=torch.bfloat16), None),
    "psum-bf16": (dict(grad_allreduce_dtype="bf16"), None),
    "rs-bf16": (dict(RS, grad_allreduce_dtype="bf16"), None),
    "rs-int8": (dict(RS, grad_allreduce_dtype="int8"), None),
    "rs-int8-ef": (dict(RS, grad_allreduce_dtype="int8",
                        error_feedback=True), None),
    "skip-psum": (dict(skip_nonfinite=True), 1),
    "skip-rs-int8-ef": (dict(RS, grad_allreduce_dtype="int8",
                             error_feedback=True, skip_nonfinite=True), 1),
}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, init):
    """Every 2-rank case in one spawned world: the dp-2 runs, one step run
    at pp 2 x M 2 and at tp 2, and ``make_forward`` at dp 2. Returns
    {case: (runs {name: ranks' results} or ranks' logits, tokens,
    labels)}."""
    pnp = init[1]
    cases = {"dp2": step_job(pnp, (2, 1, 1), DP2_RUNS),
             "pp2-m2": step_job(pnp, (1, 2, 1), {"step": ({}, None)}, m=2),
             "tp2": step_job(pnp, (1, 1, 2), {"step": ({}, None)})}
    fwd_tokens = _data(1, 4)[0][0]
    jobs = [c[0] for c in cases.values()] + [
        ("device_worker", (CFG_KW,)),
        ("forward_worker", (CFG_KW, dict(dp=2), pnp, fwd_tokens))]
    ranks = W.spawn(W.jobs_worker, 2, jobs,
                    out_dir=str(tmp_path_factory.mktemp("world2")))
    out = {}
    for i, (case, (_, names, tokens, labels)) in enumerate(cases.items()):
        out[case] = ({n: [r[i][k] for r in ranks]
                      for k, n in enumerate(names)}, tokens, labels)
    out["device"] = [r[-2] for r in ranks]
    out["forward-dp2"] = ([r[-1] for r in ranks], fwd_tokens, None)
    return out


@pytest.fixture(scope="module")
def dp2(world2):
    return world2["dp2"]


@pytest.mark.parametrize("layout,case", [((1, 2, 1), "pp2-m2"),
                                         ((1, 1, 2), "tp2")],
                         ids=["pp2-m2", "tp2"])
def test_step_matches_oracle(world2, init, layout, case):
    runs, tokens, labels = world2[case]
    check(runs["step"], layout, oracle(init[0], tokens, labels))


@pytest.mark.parametrize("name", ["psum-dp2", "rs-fused-dp2"])
def test_dp2_step_matches_oracle(dp2, init, name):
    runs, tokens, labels = dp2
    check(runs[name], (2, 1, 1), oracle(init[0], tokens, labels))


def test_rs_fused_bf16_moments_match_oracle(dp2, init):
    """Reduce-scatter with the flat sweep on bf16 moments: the oracle's
    per-leaf update on bf16 moments (the same rounding a moment)."""
    runs, tokens, labels = dp2
    ranks = runs["rs-fused-bf16-moments"]
    check(ranks, (2, 1, 1), oracle(init[0], tokens, labels,
                                   moment_dtype=jnp.bfloat16))
    assert all(r["opt"]["m"].size == ranks[0]["opt"]["m"].size
               for r in ranks)


@pytest.mark.parametrize("name,rtol", [
    ("psum-bf16", 0.02), ("rs-bf16", 0.02), ("rs-int8", 0.05),
    ("rs-int8-ef", 0.05)])
def test_quantized_wire_tracks_oracle(dp2, init, name, rtol):
    """bf16 / int8 wire payloads (float32 accumulation) at dp 2: the loss
    trajectory within the reference's bars of the float32 oracle
    (``test_comm_opt.py``: bf16 rtol 0.02, int8 0.05) and still falling."""
    runs, tokens, labels = dp2
    ranks = runs[name]
    losses, _, _ = oracle(init[0], tokens, labels)
    for r in ranks:
        assert np.isfinite(r["losses"]).all()
        np.testing.assert_allclose(r["losses"], losses, rtol=rtol)
        assert r["losses"][-1] < r["losses"][0] - 0.05
    if name.endswith("-ef"):
        # the residual is carried, and it is this rank's own
        assert all(np.abs(r["opt"]["ef"]).max() > 0 for r in ranks)
        assert not np.array_equal(ranks[0]["opt"]["ef"],
                                  ranks[1]["opt"]["ef"])


@pytest.mark.parametrize("name", ["skip-psum", "skip-rs-int8-ef"])
def test_skip_nonfinite_keeps_state_on_every_rank(dp2, name):
    """A NaN loss at step 1 (the embedding poisoned) keeps params and the
    optimizer state (step counter, moments, residual) on every rank;
    the steps around it train."""
    for r in dp2[0][name]:
        assert r["kept"] == [True, True]
        assert not np.isfinite(r["losses"][1])
        assert np.isfinite(r["losses"][0]) and np.isfinite(r["losses"][2])
        assert r["opt"]["step"] == 2


def test_refusals():
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    cfg = G.GPT_TINY
    two = PZ.ParallelConfig(dp=2)
    with pytest.raises(NotImplementedError, match="reduce_scatter"):
        PZ.make_train_step(cfg, two, fused_opt=True, device="cpu")
    with pytest.raises(NotImplementedError, match="error_feedback"):
        PZ.make_train_step(cfg, two, grad_allreduce_dtype="int8",
                           error_feedback=True, device="cpu")
    with pytest.raises(ValueError, match="sharding= needs mesh"):
        PZ.make_train_step(cfg, sharding="dp", device="cpu")
    with pytest.raises(NotImplementedError, match="pp=1"):
        PZ.make_train_step(cfg, PZ.ParallelConfig(pp=2), sharding="dp",
                           device="cpu")
    # tuned= is fingerprint-gated: a document without this machine's
    # fingerprint warns and the kwargs run as given
    with pytest.warns(RuntimeWarning, match="fingerprint mismatch"):
        PZ.init_sharded(cfg, tuned={}, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        PZ.make_train_step(cfg, two, device="cpu")
    with pytest.raises(ValueError):
        PZ.ParallelConfig(pp=0)
    # the reference's refusal conditions, checked against it
    with pytest.raises(NotImplementedError):
        JPZ.make_train_step(JG.GPT_TINY, JPZ.ParallelConfig(dp=2),
                            JPZ.build_mesh(JPZ.ParallelConfig(dp=2)),
                            fused_opt=True)


def test_mesh_device_is_the_card_unless_named(world2):
    """Over gloo, ``build_mesh`` without a device takes the current card
    (and raises where there is none); the CPU only when named. With a
    mesh, ``init_sharded`` and ``make_train_step`` run on its device and
    raise when a ``device`` beside it names another."""
    for r in world2["device"]:
        if r["card"]:
            assert r["default"].startswith("cuda"), r
        else:
            assert r["default"] == "RuntimeError", r
        assert r["named"] == {"init_sharded": "raised",
                              "make_train_step": "raised"}, r
        assert r["follows"] == ["cpu", "cpu"], r


def test_make_forward_logits_match_jax_dp2(world2, init):
    """``make_forward`` at dp 2: every rank returns the full [B, T, V]
    logits of JAX's single-device ``forward`` (rtol 2e-4 / atol 2e-5)."""
    ranks, tokens, _ = world2["forward-dp2"]
    want = np.asarray(JG.forward(init[0], jnp.asarray(tokens), _jcfg()))
    for r in ranks:
        np.testing.assert_allclose(r["logits"], want, rtol=2e-4, atol=2e-5)


def test_make_forward_logits_match_jax_pp2_tp2(tmp_path, init):
    """``make_forward`` at pp 2 x tp 2: the last stage gathers the logits
    over tp and sends them to the first; every rank's equal JAX's."""
    params, pnp = init
    tokens = _data(1, 4)[0][0]
    ranks = W.spawn(W.forward_worker, 4, CFG_KW, dict(pp=2, tp=2), pnp,
                    tokens, out_dir=str(tmp_path))
    want = np.asarray(JG.forward(params, jnp.asarray(tokens), _jcfg()))
    for r in ranks:
        np.testing.assert_allclose(r["logits"], want, rtol=2e-4, atol=2e-5)
