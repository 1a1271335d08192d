"""ERNIE's (dp, tp) mesh step in the port (``make_pretrain_step(mesh=)``:
the batch over dp, the blocks Megatron-split over tp with sequence
parallelism) against the JAX ``make_pretrain_step(mesh=Mesh(..., ("dp",
"tp")))`` on the conftest's 8-device CPU mesh: ERNIE_TINY from the JAX
``init_params`` (through numpy), padded lengths, 3 momentum steps at
lr 1e-2 on a gloo world of 4 (dp 2 x tp 2) — the loss within rtol 1e-5
and every param shard within atol and rtol 1e-5 of its block of the JAX
params (the bars of ``test_torch_ernie.py::
test_momentum_steps_track_jitted_jax``), in the plain arm and the flash
arm (the padding bias at nh/tp heads a rank; JAX's Pallas kernels in
interpret mode). Also the spec tree against the reference's.
"""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.models import ernie as JE
from paddle_tpu_torch.models import ernie as TE
from paddle_tpu_torch.parallel.parallelize import flat_leaves

import torch_dist_worker as W

B, T, LR, STEPS = 4, 64, 1e-2, 3
ARMS = {"plain": {}, "flash": {"use_flash": True}}
AXES = [("dp", 2), ("tp", 2)]


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    M = cfg.max_masked
    lens = rng.integers(16, T + 1, B)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32),
        "seg_ids": rng.integers(0, 2, (B, T), dtype=np.int32),
        "pad_mask": np.arange(T)[None, :] < lens[:, None],
        "mlm_pos": rng.integers(0, T, (B, M), dtype=np.int32),
        "mlm_ids": rng.integers(0, cfg.vocab_size, (B, M), dtype=np.int32),
        "mlm_valid": rng.random((B, M)) < 0.8,
        "nsp_label": rng.integers(0, 2, (B,), dtype=np.int32),
    }


def test_param_specs_equal_jax():
    want = jax.tree_util.tree_leaves(JE.param_specs(JE.ERNIE_BASE),
                                     is_leaf=lambda x: isinstance(x, P))
    got = flat_leaves(TE.param_specs(TE.ERNIE_BASE))
    assert [tuple(s) for s in want] == got


def _jax_run(arm, params):
    cfg = JE.ERNIE_TINY.scaled(**ARMS[arm])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    step = JE.make_pretrain_step(cfg, mesh=mesh, lr=LR)
    opt = JE.init_opt(params)
    losses = []
    with mesh:
        for _ in range(STEPS):
            params, opt, loss = step(params, opt, _batch(cfg))
            losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = JE.init_params(jax.random.PRNGKey(4), JE.ERNIE_TINY)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    ranks = W.spawn(W.ernie_mesh_worker, 4, AXES, pnp,
                    _batch(JE.ERNIE_TINY), ARMS, STEPS, LR,
                    out_dir=str(tmp_path_factory.mktemp("ernie4")))
    return pnp, ranks


def _block(x, spec, coords):
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = x.shape[d] // 2
        i = coords[entry]
        x = x[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
    return x


@pytest.mark.parametrize("arm", list(ARMS))
def test_mesh_step_tracks_jax(world, arm):
    pnp, ranks = world
    losses, params = _jax_run(arm, jax.tree_util.tree_map(np.array, pnp))
    specs = flat_leaves(TE.param_specs(TE.ERNIE_TINY))
    for r in ranks:
        np.testing.assert_allclose(r[arm]["losses"], losses, rtol=1e-5)
        for i, (x, s) in enumerate(zip(params, specs)):
            np.testing.assert_allclose(
                r[arm]["params"][i], _block(x, s, r["coords"]), rtol=1e-5,
                atol=1e-5, err_msg=f"{arm} {r['coords']} leaf {i}")
    assert losses[-1] < losses[0]
