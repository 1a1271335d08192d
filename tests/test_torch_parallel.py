"""The port's dp x pp x tp GPT loss and gradients against the JAX package.

Each case spawns a gloo world on the CPU (``torch_dist_worker.spawn``,
one process a rank, importing only torch) and holds the summed loss and
every rank's grad shards against the JAX oracle: ``shard_map`` of the
reference's own per-rank loss ``PZ._pipeline_loss`` on the conftest's
8-device CPU mesh, its grads summed over the axes each leaf's spec does
not name (``jax.lax.psum`` over ``PZ._axes_not_in_spec``: the rule of
``psum_grads_by_spec`` without its byte counter, whose ``axis_size`` does
not run under jax 0.9.0). Both are also held against single-device
``value_and_grad`` of the reference test's ``_reference_loss``.
Tolerances are the reference's (``tests/test_gpt_parallel.py``): loss
rtol 2e-4, grads rtol 5e-3 / atol 2e-4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.models import gpt as JG
from paddle_tpu.parallel import parallelize as JPZ

import torch_dist_worker as W

# the reference's tiny config at the issue's widths, float32
CFG_KW = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=32, d_ff=64)
T = 32


def _jcfg(**kw):
    return JG.GPT_TINY.scaled(**CFG_KW, **kw)


def _data(m, b, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG_KW["vocab_size"], (m, b, T)).astype(np.int32)
    labels = rng.integers(0, CFG_KW["vocab_size"], (m, b, T)).astype(np.int32)
    return tokens, labels


def _reference_loss(params, tokens, labels, cfg):
    M = tokens.shape[0]
    tot = 0.0
    for i in range(M):
        logits = JG.forward(params, tokens[i], cfg)
        tot = tot + JG.token_ce(logits, labels[i])
    return tot / labels.size


_REF_VG = jax.jit(jax.value_and_grad(_reference_loss), static_argnums=3)


def _reference_value_and_grad(params, tokens, labels, cfg):
    return _REF_VG(params, jnp.asarray(tokens), jnp.asarray(labels), cfg)


def jax_oracle(cfg, pcfg, params, tokens, labels):
    """(loss, grads) of the reference's per-rank loss under shard_map."""
    mesh = JPZ.build_mesh(pcfg)
    specs = JG.param_specs(cfg)
    data_spec = P(None, "dp", None)

    def gfn(p, t, l):
        loss, grads = jax.value_and_grad(JPZ._pipeline_loss)(p, t, l, cfg,
                                                             pcfg)
        loss = jax.lax.psum(loss, pcfg.axis_names)

        def red(g, s):
            axes = JPZ._axes_not_in_spec(s, pcfg.axis_names)
            return jax.lax.psum(g, axes) if axes else g

        return loss, jax.tree_util.tree_map(
            red, grads, specs, is_leaf=lambda x: isinstance(x, P))

    f = JPZ.shard_map_compat(gfn, mesh, in_specs=(specs, data_spec,
                                                  data_spec),
                             out_specs=(P(), specs))
    return jax.jit(f)(params, jnp.asarray(tokens), jnp.asarray(labels))


def local_block(x, spec, coords, sizes):
    """Rank ``coords``' block of the global array ``x`` by ``spec``."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = x.shape[d] // sizes[entry]
        i = coords[entry]
        x = x[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
    return x


def _flat(tree):
    return jax.tree_util.tree_leaves(tree)


def _flat_specs(cfg):
    return jax.tree_util.tree_leaves(JG.param_specs(cfg),
                                     is_leaf=lambda x: isinstance(x, P))


GRID = [(2, 2, 2, 2), (1, 4, 1, 4), (1, 1, 2, 1), (8, 1, 1, 1)]


SERIAL, DOUBLE = (False, ()), (True, ())
REMAT = {p: (False, (("remat", True), ("remat_policy", p)))
         for p in ("dots", "full")}


# every layout the tests ask for, by world size: one spawned world a size
# runs its layouts in turn
LAYOUTS = {
    8: [(2, 2, 2, 2, ()), (8, 1, 1, 1, ())],
    4: [(1, 4, 1, 4, ()), (1, 2, 2, 2, ()),
        (2, 1, 2, 2, (("fused_ln", True), ("ce_vocab_chunk", 48)))],
    2: [(1, 1, 2, 1, ())],
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``get(dp, pp, tp, m, **cfg_kw)`` -> (cfg, params, tokens, labels,
    ranks' results) of a layout of ``LAYOUTS``: the serial schedule, and
    where pp > 1 the double-buffered one; at (1, 2, 2, 2) the remat
    policies too."""
    cache = {}
    params = JG.init_params(jax.random.PRNGKey(0), _jcfg())
    pnp = jax.tree_util.tree_map(np.asarray, params)

    def get(dp, pp, tp, m, **cfg_kw):
        key = (dp, pp, tp, m, tuple(sorted(cfg_kw.items())))
        n = dp * pp * tp
        if key not in cache:
            jobs, keys = [], []
            for (d, p, t, mm, kw) in LAYOUTS[n]:
                variants = [SERIAL] + ([DOUBLE] if p > 1 else [])
                if (d, p, t, mm) == (1, 2, 2, 2):
                    variants = [SERIAL] + list(REMAT.values())
                tokens, labels = _data(mm, 4 * d)
                jobs.append(("grads_worker", (
                    CFG_KW | dict(kw), dict(dp=d, pp=p, tp=t,
                                            microbatches=mm),
                    pnp, tokens, labels, variants)))
                keys.append(((d, p, t, mm, tuple(sorted(kw))), tokens,
                             labels))
            ranks = W.spawn(W.jobs_worker, n, jobs,
                            out_dir=str(tmp_path_factory.mktemp("world")))
            for i, (k, tokens, labels) in enumerate(keys):
                cache[k] = (_jcfg(**dict(k[4])), params, tokens, labels,
                            [r[i] for r in ranks])
        return cache[key]

    return get


def _check_against(loss, grads, ranks, cfg, sizes, variant=SERIAL):
    specs = _flat_specs(cfg)
    gl = [np.asarray(g) for g in _flat(grads)]
    for r in ranks:
        got = r[variant]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-4)
        for i, (g, s) in enumerate(zip(gl, specs)):
            want = local_block(g, tuple(s), r["coords"], sizes)
            np.testing.assert_allclose(
                got["grads"][i], want, rtol=5e-3, atol=2e-4,
                err_msg=f"rank {r['coords']} leaf {i} spec {s}")


@pytest.mark.parametrize("dp,pp,tp,m", GRID)
def test_loss_and_grad_shards_match_jax_pipeline_loss(worlds, dp, pp, tp, m):
    cfg, params, tokens, labels, ranks = worlds(dp, pp, tp, m)
    pcfg = JPZ.ParallelConfig(dp=dp, pp=pp, tp=tp, microbatches=m)
    loss, grads = jax_oracle(cfg, pcfg, params, tokens, labels)
    _check_against(loss, grads, ranks, cfg, dict(dp=dp, pp=pp, tp=tp))


@pytest.mark.parametrize("dp,pp,tp,m", GRID)
def test_loss_and_grad_shards_match_single_device(worlds, dp, pp, tp, m):
    cfg, params, tokens, labels, ranks = worlds(dp, pp, tp, m)
    loss, grads = _reference_value_and_grad(params, tokens, labels, cfg)
    _check_against(loss, grads, ranks, cfg, dict(dp=dp, pp=pp, tp=tp))


def test_fused_ln_and_vocab_chunk_match_jax(worlds):
    """(2, 1, 2, 2) with the fused-layernorm block and the vocab-chunked
    CE: the plain versions of the fused-LN and ce_fwd kernels on the
    rank's B·T/tp rows and sequence chunk of the labels."""
    kw = dict(fused_ln=True, ce_vocab_chunk=48)
    cfg, params, tokens, labels, ranks = worlds(2, 1, 2, 2, **kw)
    pcfg = JPZ.ParallelConfig(dp=2, pp=1, tp=2, microbatches=2)
    loss, grads = jax_oracle(cfg, pcfg, params, tokens, labels)
    _check_against(loss, grads, ranks, cfg, dict(dp=2, pp=1, tp=2))
    ref_loss, ref_grads = _reference_value_and_grad(params, tokens, labels,
                                                    _jcfg())
    _check_against(ref_loss, ref_grads, ranks, cfg, dict(dp=2, pp=1, tp=2))


@pytest.mark.parametrize("dp,pp,tp,m", [(2, 2, 2, 2), (1, 4, 1, 4)])
def test_double_buffer_same_values_as_serial(worlds, dp, pp, tp, m):
    """The double-buffered schedule (each stage send in flight over the
    next tick) gives the serial schedule's loss and grads, bitwise."""
    *_, ranks = worlds(dp, pp, tp, m)
    for r in ranks:
        assert r[DOUBLE]["loss"] == r[SERIAL]["loss"]
        for a, b in zip(r[DOUBLE]["grads"], r[SERIAL]["grads"]):
            np.testing.assert_array_equal(a, b)


def test_unused_replicated_leaves_have_zero_grads_before_the_sum(worlds):
    """The embeddings off stage 0 and the head / final LN off the last
    stage take exact zero grads before the sum over pp, as the
    reference's masked ticks give them; the stage that uses a leaf has a
    non-zero grad."""
    cfg, params, *_, ranks = worlds(1, 4, 1, 4)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    first = ("['wte']", "['wpe']")
    last = ("['lm_head']", "['ln_f_scale']", "['ln_f_bias']")
    for r in ranks:
        stage = r["coords"]["pp"]
        for name in first + last:
            g = r[SERIAL]["raw"][names.index(name)]
            used = stage == 0 if name in first else stage == 3
            assert (np.abs(g).max() > 0) == used, (stage, name)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_policies_under_pp_and_tp(worlds, policy):
    """The block's sequence-parallel collectives inside a checkpoint: the
    recompute issues them again in the backward, in the same order on
    every tp rank; loss and grads as the single-device reference's."""
    cfg, params, tokens, labels, ranks = worlds(1, 2, 2, 2)
    loss, grads = _reference_value_and_grad(params, tokens, labels, cfg)
    _check_against(loss, grads, ranks, cfg, dict(dp=1, pp=2, tp=2),
                   REMAT[policy])
