"""The port's training slice against the JAX package, on the CPU: the GPT
loss and its gradients, the remat policies, the row-chunked CE and the
single-device train step.

The oracle for the step is ``jax.value_and_grad(G.loss_fn)`` followed by
``PZ._adamw_update_fused`` — the same math as ``PZ.make_train_step`` at
dp = pp = tp = microbatches = 1 (``_pipeline_loss`` divides by
``labels.size``). Inputs come from numpy seeds and go to both frameworks.
"""
import functools

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as JG
from paddle_tpu.parallel import parallelize as PZ
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops import flash_attention as TFA
from paddle_tpu_torch.parallel import parallelize as TPZ
from paddle_tpu_torch.parallel import remat as TR

B, T = 2, 32


def _cfgs(**kw):
    base = dict(num_layers=2, remat=False)
    base.update(kw)
    return JG.GPT_TINY.scaled(**base), TG.GPT_TINY.scaled(**base)


def _data(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return toks, labs


def _params(cfg_j, seed=0):
    jp = JG.init_params(jax.random.PRNGKey(seed), cfg_j)
    return jp, TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")


def _torch_loss_grads(tp, toks, labs, cfg_t):
    leaves = [p.detach().requires_grad_() for p in TPZ.flat_leaves(tp)]
    tree = TPZ._unflatten(tp, leaves)
    loss = TG.loss_fn(tree, torch.from_numpy(toks).long(),
                      torch.from_numpy(labs).long(), cfg_t)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_loss_and_grads_match_jax(use_flash):
    """2-layer GPT_TINY f32: loss to 1e-5 relative, every gradient leaf to
    3e-4 (the flash-gradient tolerance of tests/test_pallas.py:57)."""
    cfg_j, cfg_t = _cfgs(use_flash=use_flash)
    jp, tp = _params(cfg_j)
    toks, labs = _data(cfg_j)
    jl, jg = jax.jit(jax.value_and_grad(JG.loss_fn), static_argnums=3)(
        jp, toks, labs, cfg_j)
    tl, tg = _torch_loss_grads(tp, toks, labs, cfg_t)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, want in zip(tg, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4,
                                   rtol=3e-4)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("policy", ["full", "dots", "save_only_flash"])
def test_remat_policy_grads_equal_none(policy, use_flash, monkeypatch):
    """Every policy gives the no-remat gradients bit for bit; the flash
    forward runs L times without recompute (none, save_only_flash) and
    2L times with it (full, dots), as in JAX."""
    calls = []
    fwd = TFA.flash_fwd
    monkeypatch.setattr(TFA, "flash_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    cfg_j, cfg_t = _cfgs(use_flash=use_flash)
    _jp, tp = _params(cfg_j, seed=1)
    toks, labs = _data(cfg_j, seed=1)
    _l0, want = _torch_loss_grads(tp, toks, labs, cfg_t)
    calls.clear()
    cfg_p = cfg_t.scaled(remat=True, remat_policy=policy)
    _l1, got = _torch_loss_grads(tp, toks, labs, cfg_p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if use_flash:
        L = cfg_t.num_layers
        assert len(calls) == (L if policy == "save_only_flash" else 2 * L)


def test_dots_saves_exactly_the_unbatched_products():
    cfg = TG.GPT_TINY.scaled(num_layers=1)
    seen = []

    def spy(ctx, op, *args, **kw):
        out = TR._dots_policy(ctx, op, *args, **kw)
        if not ctx.is_recompute and out == CheckpointPolicy.MUST_SAVE:
            seen.append(tuple(args[0].shape))
        return out

    p = TG.init_params(cfg, seed=0, device="cpu")
    layer = {k: v[0].requires_grad_() for k, v in p["blocks"].items()}
    x = torch.randn(2, 8, cfg.d_model, requires_grad=True)
    ctx = functools.partial(create_selective_checkpoint_contexts, spy)
    y = checkpoint(TG.block_fn, layer, x, cfg, use_reentrant=False,
                   context_fn=ctx)
    y.sum().backward()
    # qkv, attention out-projection, fc, fc-out — never the two attention
    # products (batch B*nh)
    assert seen == [(1, 16, 64), (1, 16, 64), (1, 16, 64), (1, 16, 128)]


def test_chunked_ce_matches_jax():
    """The row-chunked CE (direct path off, 64 rows in chunks of 24 with a
    padded tail) and its gradients vs JAX, f32."""
    cfg_j, cfg_t = _cfgs(ce_direct_bytes_limit=0, ce_chunk=24)
    jp, tp = _params(cfg_j, seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, cfg_j.d_model)).astype(np.float32)
    _toks, labs = _data(cfg_j, seed=2)

    def jce(p, x):
        return JG.ce_from_hidden(p, x, labs, cfg_j)

    jv, (jgp, jgx) = jax.value_and_grad(jce, argnums=(0, 1))(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    head = tp["lm_head"].requires_grad_()
    tv = TG.ce_from_hidden(tp, tx, torch.from_numpy(labs).long(), cfg_t)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5)
    np.testing.assert_allclose(head.grad.numpy(), np.asarray(jgp["lm_head"]),
                               atol=1e-5)


def _oracle_steps(jp, jopt, toks, labs, cfg_j, n, fused):
    vg = jax.jit(jax.value_and_grad(JG.loss_fn), static_argnums=3)
    losses = []
    for _ in range(n):
        loss, grads = vg(jp, toks, labs, cfg_j)
        if fused:
            jp, jopt, _g = PZ._adamw_update_fused(
                jp, grads, jopt, 1e-2, weight_decay=0.1, grad_clip=1.0,
                use_pallas=True)
        else:
            jp, jopt, _g = PZ._adamw_update(jp, grads, jopt, 1e-2,
                                            weight_decay=0.1, grad_clip=1.0)
        losses.append(float(loss))
    return jp, jopt, losses


@pytest.mark.parametrize("fused,mdt", [(True, None), (True, "bf16"),
                                       (False, None)],
                         ids=["fused-f32", "fused-bf16", "per-leaf-f32"])
def test_train_step_tracks_oracle(fused, mdt):
    """3 steps at lr 1e-2 (large, so the params move): losses to 1e-5
    relative; params to 1e-2·lr — Adam divides by sqrt(v), so where a
    gradient is near zero a last-bit difference in it moves u = m/sqrt(v)
    by up to a percent of a step; moments to 1e-5 (f32) or 1 bf16 ulp of
    the largest moment (bf16 storage rounds both sides)."""
    cfg_j, cfg_t = _cfgs(use_flash=True, remat=True, remat_policy="dots")
    jp, tp = _params(cfg_j, seed=3)
    jdt = jnp.bfloat16 if mdt else None
    jopt = PZ.init_adamw_state(jp, moment_dtype=jdt, fused=fused)
    if fused:
        topt = TPZ.opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jopt), device="cpu")
    else:
        topt = TPZ.init_adamw_state(tp)
    toks, labs = _data(cfg_j, seed=3)
    jp, jopt, jl = _oracle_steps(jp, jopt, toks, labs, cfg_j, 3, fused)
    step = TPZ.make_train_step(cfg_t, lr=1e-2, fused_opt=fused,
                               device="cpu")
    tl = []
    for _ in range(3):
        tp, topt, loss, gnorm = step(tp, topt, toks[None], labs[None])
        assert torch.isfinite(gnorm)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for got, want in zip(TPZ.flat_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    for key in ("m", "v"):
        got = torch.cat([t.float().reshape(-1)
                         for t in TPZ.flat_leaves({"x": topt[key]})])
        want = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                               for a in jax.tree_util.tree_leaves(
                                   jopt[key])])
        atol = 1e-5 if not mdt else float(np.abs(want).max()) * 2 ** -8
        np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_flat_view_params_update_like_copies():
    """init_sharded(fused_opt=True) lays the params out as views of one
    buffer; the sweep then runs on it in place and gives the same params
    as separate leaves (concatenated and copied back)."""
    cfg = TG.GPT_TINY.scaled(num_layers=2)
    pv, ov = TPZ.init_sharded(cfg, seed=4, fused_opt=True, device="cpu")
    base = TPZ._flat_base(TPZ.flat_leaves(pv))
    assert base is not None and base.numel() == TG.num_params(pv)
    pc = {k: ({kk: vv.clone() for kk, vv in v.items()}
              if isinstance(v, dict) else v.clone()) for k, v in pv.items()}
    assert TPZ._flat_base(TPZ.flat_leaves(pc)) is None
    oc = TPZ.init_adamw_state(pc, fused=True)
    toks, labs = _data(cfg, seed=4)
    step = TPZ.make_train_step(cfg, lr=1e-2, fused_opt=True, device="cpu")
    for _ in range(2):
        step(pv, ov, toks[None], labs[None])
        step(pc, oc, toks[None], labs[None])
    for a, b in zip(TPZ.flat_leaves(pv), TPZ.flat_leaves(pc)):
        assert torch.equal(a, b)
    assert TPZ._flat_base(TPZ.flat_leaves(pv)) is base


def test_skip_nonfinite_keeps_state():
    cfg = TG.GPT_TINY.scaled(num_layers=1)
    params, opt = TPZ.init_sharded(cfg, seed=5, fused_opt=True,
                                   device="cpu")
    with torch.no_grad():
        params["wte"][0, 0] = float("nan")
    before = [p.clone() for p in TPZ.flat_leaves(params)]
    toks = np.zeros((1, B, 8), np.int32)
    step = TPZ.make_train_step(cfg, fused_opt=True, skip_nonfinite=True,
                               device="cpu")
    _p, opt, loss, _g = step(params, opt, toks, toks)
    assert not torch.isfinite(loss)
    assert int(opt["step"]) == 0 and not opt["m"].any()
    for a, b in zip(TPZ.flat_leaves(params), before):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def test_refusals_and_defaults():
    with pytest.raises(ValueError):
        TG.GPT_TINY.scaled(remat_policy="sometimes")
    with pytest.raises(NotImplementedError):
        TPZ.ParallelConfig(dp=2)
    cfg = TG.GPT_TINY.scaled(num_layers=1, ce_vocab_chunk=64)
    p = TG.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError):
        TG.loss_fn(p, torch.zeros((1, 4), dtype=torch.long),
                   torch.zeros((1, 4), dtype=torch.long), cfg)
    assert TG.train_flops_per_token(TG.GPT_SMALL, 163109376, 1024) == \
        JG.train_flops_per_token(JG.GPT_SMALL, 163109376, 1024)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TPZ.make_train_step(TG.GPT_TINY)
        with pytest.raises(RuntimeError):
            TPZ.init_sharded(TG.GPT_TINY)
