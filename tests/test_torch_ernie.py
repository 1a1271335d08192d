"""The port's ERNIE encoder against ``paddle_tpu/models/ernie.py``, on the
CPU.

ERNIE_TINY (head_dim 8) with JAX's parameters carried across
(``params_from_numpy``) and padded sequence lengths: ``pretrain_loss`` and
the gradient of every leaf against ``jax.value_and_grad(E.pretrain_loss)``
in every arm of the model — plain attention, flash with the padding bias
(JAX's Pallas kernels in interpret mode), the fused-layernorm blocks, the
vocab-chunked MLM CE, remat ``full`` and ``none`` — and three momentum
steps against the jitted JAX step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import ernie as JE
from paddle_tpu_torch.models import ernie as TE
from paddle_tpu_torch.parallel.parallelize import _unflatten, flat_leaves

B, T = 4, 64


def _batch(cfg, seed=0):
    """A pretraining batch with padded lengths 16..64 and some unused MLM
    slots."""
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


def _jax_params(cfg, seed=0):
    return JE.init_params(jax.random.PRNGKey(seed), cfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


ARMS = {
    "plain": {},
    "flash": {"use_flash": True},
    "fused_ln": {"fused_ln": True},
    "vchunk96": {"ce_vocab_chunk": 96},
    "remat_full": {"remat": True, "remat_policy": "full"},
    "remat_none_flash_fused": {"remat": False, "use_flash": True,
                               "fused_ln": True, "ce_vocab_chunk": 96},
    "remat_full_flash": {"remat": True, "remat_policy": "full",
                         "use_flash": True},
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_loss_and_grads_match_jax(arm):
    """float32: the loss to 1e-5 relative and every leaf's gradient to
    1e-5 of its largest |value| (V 256 is not a multiple of the 96-column
    vocab chunk; remat changes what is saved, not the values)."""
    kw = ARMS[arm]
    jcfg, tcfg = JE.ERNIE_TINY.scaled(**kw), TE.ERNIE_TINY.scaled(**kw)
    jp = _jax_params(jcfg)
    batch = _batch(jcfg)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: JE.pretrain_loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
        has_aux=True)(jp)
    tp = TE.params_from_numpy(_np_tree(jp), device="cpu")
    live = [p.detach().requires_grad_() for p in flat_leaves(tp)]
    tl, taux = TE.pretrain_loss(_unflatten(tp, live),
                                TE.batch_to_device(batch, "cpu"), tcfg)
    grads = torch.autograd.grad(tl, live)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for key in ("mlm", "nsp"):
        np.testing.assert_allclose(taux[key].item(), float(jaux[key]),
                                   rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves)
    for a, b in zip(grads, jleaves):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-5 * np.abs(b).max() + 1e-12)


def test_momentum_steps_track_jitted_jax():
    """Three pretrain steps (momentum 0.9, lr 1e-2 so that the params move)
    of the port against ``jax.jit(E.make_pretrain_step(cfg))`` with no
    mesh, through the flash and fused-LN arms: losses to 1e-5 relative,
    params and momentum to 1e-5."""
    kw = {"use_flash": True, "fused_ln": True}
    jcfg, tcfg = JE.ERNIE_TINY.scaled(**kw), TE.ERNIE_TINY.scaled(**kw)
    jp = _jax_params(jcfg, seed=1)
    tp = TE.params_from_numpy(_np_tree(jp), device="cpu")
    topt = TE.init_opt(tp)
    jopt = JE.init_opt(jp)
    batch = _batch(jcfg, seed=1)
    jstep = JE.make_pretrain_step(jcfg, lr=1e-2)
    tstep = TE.make_pretrain_step(tcfg, lr=1e-2, device="cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jp, jopt, jl = jstep(jp, jopt, jb)
        tp, topt, tl = tstep(tp, topt, batch)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, want in ((tp, jp), (topt["m"], jopt["m"])):
        for a, b in zip(flat_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)


def test_flops_per_token_equals_jax():
    for cfg_j, cfg_t in ((JE.ERNIE_BASE, TE.ERNIE_BASE),
                         (JE.ERNIE_TINY, TE.ERNIE_TINY)):
        n = 110_000_000
        for t in (64, 512):
            assert TE.pretrain_flops_per_token(cfg_t, n, t) == \
                JE.pretrain_flops_per_token(cfg_j, n, t)


def test_params_round_trip_and_tree_matches_jax():
    """``params_from_numpy`` carries the JAX tree across leaf for leaf and
    back; the port's own ``init_params`` has the same names, shapes and
    float32 dtypes, and ``num_params`` counts the same."""
    jp = _jax_params(JE.ERNIE_TINY)
    tp = TE.params_from_numpy(_np_tree(jp), device="cpu")
    for a, b in zip(flat_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mine = TE.init_params(TE.ERNIE_TINY, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(flat_leaves(mine))
    for (path, b), a in zip(flat_j, flat_leaves(mine)):
        assert tuple(a.shape) == b.shape, path
        assert a.dtype == torch.float32
    assert sorted(mine) == sorted(jp)
    assert sorted(mine["blocks"]) == sorted(jp["blocks"])
    assert TE.num_params(mine) == JE.num_params(jp)


def test_padding_does_not_reach_real_positions():
    """Tokens under the pad do not change the hidden states of the real
    positions, with plain and flash attention (the JAX model's
    ``test_encode_shapes_and_padding_invariance``)."""
    for use_flash in (False, True):
        cfg = TE.ERNIE_TINY.scaled(use_flash=use_flash)
        params = TE.init_params(cfg, seed=2, device="cpu")
        b = TE.batch_to_device(_batch(cfg, seed=2), "cpu")
        pad = b["pad_mask"].clone()
        pad[:, -4:] = False
        h = []
        for fill in (7, 111):
            toks = b["tokens"].clone()
            toks[:, -4:] = fill
            h.append(TE.encode(params, toks, b["seg_ids"], pad, cfg))
        assert h[0].shape == (B, T, cfg.d_model)
        torch.testing.assert_close(h[0][:, :-4], h[1][:, :-4], atol=1e-5,
                                   rtol=1e-5)


def test_batch_to_device_and_refusals():
    """Index arrays become int64, masks stay bool; a mesh that is not the
    port's ``parallel.mesh.Mesh`` raises, and so does an unknown remat
    policy."""
    b = TE.batch_to_device(_batch(TE.ERNIE_TINY), "cpu")
    assert b["tokens"].dtype == torch.int64
    assert b["pad_mask"].dtype == torch.bool
    assert b["mlm_valid"].dtype == torch.bool
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TE.make_pretrain_step(TE.ERNIE_TINY, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        TE.ERNIE_TINY.scaled(remat_policy="bogus")
