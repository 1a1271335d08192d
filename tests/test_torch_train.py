"""The port's training slice against the JAX package, on the CPU: the GPT
loss and its gradients (with flash attention, the fused-layernorm block
and the vocab-chunked CE), the remat policies, the row-chunked CE and the
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
from paddle_tpu_torch.ops import fused_ln as TFL
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


def test_save_only_flash_saves_plain_attention_output(monkeypatch, capsys):
    """Without ``use_flash``, ``save_only_flash`` keeps the attention
    output [B, T, nh, hd] as JAX's block does (its ``checkpoint_name``
    tag, ``gpt.py:196``), and the tag changes no value. JAX's residuals
    come from ``print_saved_residuals``; the port's are what the block's
    checkpoint keeps: its input (the one tensor that
    ``saved_tensors_hooks`` sees outside the checkpoint frame) and the
    outputs the selective policy marks MUST_SAVE in the forward (an
    identity op's output has its input's shape)."""
    from jax.ad_checkpoint import print_saved_residuals
    from paddle_tpu.parallel import remat as JR

    cfg_j, cfg_t = _cfgs(num_layers=1)
    nh, hd, D = cfg_t.num_heads, cfg_t.head_dim, cfg_t.d_model
    jp, tp = _params(cfg_j, seed=3)
    x_np = np.random.default_rng(3).standard_normal((B, T, D)).astype(
        np.float32)
    layer_j = jax.tree_util.tree_map(lambda v: v[0], jp["blocks"])
    jblock = jax.checkpoint(lambda p, x: JG.block_fn(p, x, cfg_j),
                            policy=JR.resolve("save_only_flash").jax_policy())
    print_saved_residuals(jblock, layer_j, jnp.asarray(x_np))
    jax_saved = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()
                 if ln.strip() and "from the argument" not in ln]
    assert jax_saved == [f"f32[{B},{T},{nh},{hd}]"]

    kept = []
    policy = TR._SELECTIVE["save_only_flash"]

    def spy(ctx, op, *args, **kw):
        out = policy(ctx, op, *args, **kw)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append((op, tuple(args[0].shape)))
        return out

    monkeypatch.setitem(TR._SELECTIVE, "save_only_flash", spy)
    layer = {k: v[0] for k, v in tp["blocks"].items()}
    x = torch.from_numpy(x_np).requires_grad_()
    hooked = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: hooked.append(tuple(t.shape)) or t, lambda t: t):
        y = TR.resolve("save_only_flash").wrap(TG.block_fn)(layer, x, cfg_t)
    assert hooked == [(B, T, D)]
    assert kept == [(TR.ATTN_OUT_OP, (B, T, nh, hd))]
    (gx,) = torch.autograd.grad(y.sum(), x)

    x0 = torch.from_numpy(x_np).requires_grad_()
    y0 = TG.block_fn(layer, x0, cfg_t)
    (gx0,) = torch.autograd.grad(y0.sum(), x0)
    assert torch.equal(y, y0) and torch.equal(gx, gx0)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jblock(layer_j, jnp.asarray(x_np))),
                               rtol=1e-5, atol=1e-5)


def test_gpt_tiny_full_depth_flash_matches_jax():
    """GPT_TINY as published (4 layers, head_dim 16) with flash, f32: the
    config that trains on the card now that the kernels take head_dim 16;
    loss to 1e-5 relative, gradients to 3e-4."""
    cfg_j = JG.GPT_TINY.scaled(use_flash=True, remat=False)
    cfg_t = TG.GPT_TINY.scaled(use_flash=True, remat=False)
    assert cfg_t.head_dim == 16 and cfg_t.num_layers == 4
    jp, tp = _params(cfg_j, seed=4)
    toks, labs = _data(cfg_j, seed=4)
    jl, jg = jax.jit(jax.value_and_grad(JG.loss_fn), static_argnums=3)(
        jp, toks, labs, cfg_j)
    tl, tg = _torch_loss_grads(tp, toks, labs, cfg_t)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, want in zip(tg, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4,
                                   rtol=3e-4)


_LEVERS = {"fused_ln": dict(fused_ln=True),
           "vchunk": dict(ce_vocab_chunk=96, ce_chunk=32),
           "both": dict(fused_ln=True, ce_vocab_chunk=96, ce_chunk=32)}


@pytest.mark.parametrize("lever", list(_LEVERS))
def test_memory_levers_loss_and_grads_match_jax(lever):
    """2-layer GPT_TINY f32 with the fused-layernorm block, the
    vocab-chunked CE (vocab 256 in chunks of 96, so it pads; 64 rows in
    row chunks of 32), and both: loss to 1e-5 relative and every gradient
    leaf to 3e-4 against jax.value_and_grad of the JAX model."""
    cfg_j, cfg_t = _cfgs(**_LEVERS[lever])
    jp, tp = _params(cfg_j, seed=6)
    toks, labs = _data(cfg_j, seed=6)
    jl, jg = jax.jit(jax.value_and_grad(JG.loss_fn), static_argnums=3)(
        jp, toks, labs, cfg_j)
    tl, tg = _torch_loss_grads(tp, toks, labs, cfg_t)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, want in zip(tg, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4,
                                   rtol=3e-4)


@pytest.mark.parametrize("policy", ["full", "dots", "save_only_flash"])
def test_remat_policy_grads_equal_none_fused_ln(policy, monkeypatch):
    """With fused_ln=True every policy gives the no-remat gradients bit for
    bit; the LN forward runs 2L + 1 times without recompute and 4L + 1
    times with it (the final LN sits outside the blocks), as in JAX."""
    calls = []
    fwd = TFL.fused_ln_fwd
    monkeypatch.setattr(TFL, "fused_ln_fwd",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    cfg_j, cfg_t = _cfgs(use_flash=True, fused_ln=True)
    _jp, tp = _params(cfg_j, seed=7)
    toks, labs = _data(cfg_j, seed=7)
    _l0, want = _torch_loss_grads(tp, toks, labs, cfg_t)
    L = cfg_t.num_layers
    assert len(calls) == 2 * L + 1
    calls.clear()
    _l1, got = _torch_loss_grads(tp, toks, labs,
                                 cfg_t.scaled(remat=True, remat_policy=policy))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(calls) == 4 * L + 1


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


@pytest.mark.parametrize("fused,mdt,levers", [
    (True, None, False), (True, "bf16", False), (False, None, False),
    (True, None, True)],
    ids=["fused-f32", "fused-bf16", "per-leaf-f32", "fused-f32-fln-vchunk"])
def test_train_step_tracks_oracle(fused, mdt, levers):
    """3 steps at lr 1e-2 (large, so the params move): losses to 1e-5
    relative; params to 1e-2·lr — Adam divides by sqrt(v), so where a
    gradient is near zero a last-bit difference in it moves u = m/sqrt(v)
    by up to a percent of a step; moments to 1e-5 (f32) or 1 bf16 ulp of
    the largest moment (bf16 storage rounds both sides). ``levers`` adds
    the fused-layernorm block and the vocab-chunked CE."""
    cfg_j, cfg_t = _cfgs(use_flash=True, remat=True, remat_policy="dots",
                         **(_LEVERS["both"] if levers else {}))
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
    # multi-rank layouts and the sharding plans are ported
    # (tests/test_torch_parallel*.py, test_torch_sharding.py); a plan and
    # a multi-rank layout need a mesh
    assert TPZ.ParallelConfig(dp=2).n_devices == 2
    with pytest.raises(ValueError, match="sharding= needs mesh"):
        TPZ.make_train_step(TG.GPT_TINY, sharding="dp", device="cpu")
    with pytest.raises(ValueError):
        TPZ.make_train_step(TG.GPT_TINY, TPZ.ParallelConfig(dp=2),
                            device="cpu")
    # ce_vocab_chunk is ported: the chunked loss equals the direct one
    cfg = TG.GPT_TINY.scaled(num_layers=1)
    p = TG.init_params(cfg, seed=0, device="cpu")
    toks = torch.arange(8, dtype=torch.long).reshape(1, 8)
    direct = TG.loss_fn(p, toks, toks, cfg)
    chunked = TG.loss_fn(p, toks, toks, cfg.scaled(ce_vocab_chunk=64))
    torch.testing.assert_close(chunked, direct, rtol=1e-6, atol=0)
    assert TG.train_flops_per_token(TG.GPT_SMALL, 163109376, 1024) == \
        JG.train_flops_per_token(JG.GPT_SMALL, 163109376, 1024)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TPZ.make_train_step(TG.GPT_TINY)
        with pytest.raises(RuntimeError):
            TPZ.init_sharded(TG.GPT_TINY)
