"""Optimizer update op lowerings — the slice of
``paddle_tpu/ops/optimizer_ops.py`` the fluid training path runs.

The per-parameter ``sgd``, ``momentum``, ``adam`` and ``adamw`` ops, and
the fused flat-buffer sweeps ``fused_sgd``, ``fused_momentum``,
``fused_adam`` and ``fused_adamw``: one op per (dtype, lr-multiplier)
parameter group, whose params and grads are concatenated into one flat
buffer, updated in one pass, and split back out; the moments live flat
as the op's accumulator inputs. Each fused op runs its group through
``ops/cuda_kernels.megakernel_*`` — the hand-written kernel on the card,
its plain version on CPU tensors — unless ``FLAGS_fuse_optimizer_pallas``
is set False, which takes the op's unfused expression (the reference's
switch). The kernels update the flat p and the moments in place, as the
reference's aliasing does; the unfused expressions build new tensors.
Every expression is the reference's, operation for operation.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register_op("sgd", grad=None, is_optimizer=True)
def sgd(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": p - _lr(ins).to(p.dtype) * g.to(p.dtype)}


@register_op("momentum", grad=None, is_optimizer=True)
def momentum(ctx, op, ins):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = _lr(ins).float()
    mu = op.attr("mu", 0.9)
    gf = g.float()
    pf = p.float()
    v_new = mu * v.float() + gf
    if op.attr("use_nesterov", False):
        p_new = pf - (gf + mu * v_new) * lr
    else:
        p_new = pf - lr * v_new
    return {"ParamOut": p_new.to(p.dtype), "VelocityOut": v_new.to(v.dtype)}


@register_op("adam", grad=None, is_optimizer=True)
def adam(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = _lr(ins).float()
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    b1p_f = b1p.reshape(()).float()
    b2p_f = b2p.reshape(()).float()
    lr_t = lr * torch.sqrt(1 - b2p_f * b2) / (1 - b1p_f * b1)
    p_new = p.float() - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {
        "ParamOut": p_new.to(p.dtype),
        "Moment1Out": m_new,
        "Moment2Out": v_new,
        "Beta1PowOut": b1p * b1,
        "Beta2PowOut": b2p * b2,
    }


@register_op("adamw", grad=None, is_optimizer=True)
def adamw(ctx, op, ins):
    """Adam with decoupled weight decay."""
    p = ins["Param"][0]
    out = adam(ctx, op, ins)
    decayed = out["ParamOut"].float() - \
        _lr(ins).float() * op.attr("coeff", 0.01) * p.float()
    out["ParamOut"] = decayed.to(p.dtype)
    return out


# ---------------------------------------------------------------------------
# Fused flat-buffer sweeps (optimizer.py _apply_fused_gradients)
# ---------------------------------------------------------------------------


def _flat_cat(ts, dtype):
    """One new flat buffer holding ``ts`` in order (a copy even for one
    tensor: the kernels update it in place)."""
    return torch.cat([t.to(dtype).reshape(-1) for t in ts])


def _split_like(flat, params):
    out, off = [], 0
    for p in params:
        n = p.numel()
        out.append(flat[off:off + n].reshape(p.shape).to(p.dtype))
        off += n
    return out


def _fused_lr(ins, op):
    return _lr(ins).float() * float(op.attr("lr_mult", 1.0))


def _use_megakernel() -> bool:
    """FLAGS_fuse_optimizer_pallas: None or True runs each fused group
    through its kernel route, False through the unfused expression."""
    from ..framework.core import get_flag

    return get_flag("FLAGS_fuse_optimizer_pallas") is not False


@register_op("fused_sgd", grad=None, is_optimizer=True)
def fused_sgd(ctx, op, ins):
    ps, gs = ins["Param"], ins["Grad"]
    dt = ps[0].dtype                 # the group key pins one dtype per op
    pf = _flat_cat(ps, dt)
    gf = _flat_cat(gs, dt)
    if _use_megakernel():
        from .cuda_kernels import megakernel_sgd

        p_new = megakernel_sgd(pf, gf, _fused_lr(ins, op))
    else:
        p_new = pf - _fused_lr(ins, op).to(dt) * gf
    return {"ParamOut": _split_like(p_new, ps)}


@register_op("fused_momentum", grad=None, is_optimizer=True)
def fused_momentum(ctx, op, ins):
    ps, gs = ins["Param"], ins["Grad"]
    v = ins["Velocity"][0]
    lr = _fused_lr(ins, op)
    mu = op.attr("mu", 0.9)
    use_nesterov = op.attr("use_nesterov", False)
    gf = _flat_cat(gs, torch.float32)
    pf = _flat_cat(ps, torch.float32)
    if _use_megakernel():
        from .cuda_kernels import megakernel_momentum

        p_new, v_new = megakernel_momentum(pf, gf, v, lr, mu=mu,
                                           nesterov=use_nesterov)
    else:
        v_new = mu * v.float() + gf
        if use_nesterov:
            p_new = pf - (gf + mu * v_new) * lr
        else:
            p_new = pf - lr * v_new
    return {"ParamOut": _split_like(p_new, ps),
            "VelocityOut": v_new.to(v.dtype)}


def _fused_adam_impl(ctx, op, ins, coeff):
    ps, gs = ins["Param"], ins["Grad"]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = _fused_lr(ins, op)
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    gf = _flat_cat(gs, torch.float32)
    pf = _flat_cat(ps, torch.float32)
    b1p_f = b1p.reshape(()).float()
    b2p_f = b2p.reshape(()).float()
    if _use_megakernel():
        from .cuda_kernels import megakernel_adam

        p_new, m_new, v_new = megakernel_adam(
            pf, gf, m, v, lr, b1p_f, b2p_f, b1=b1, b2=b2, eps=eps,
            coeff=coeff)
    else:
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        lr_t = lr * torch.sqrt(1 - b2p_f * b2) / (1 - b1p_f * b1)
        p_new = pf - lr_t * m_new / (torch.sqrt(v_new) + eps)
        if coeff:
            p_new = p_new - lr * coeff * pf  # decoupled decay (AdamW)
    return {
        "ParamOut": _split_like(p_new, ps),
        "Moment1Out": m_new,
        "Moment2Out": v_new,
        "Beta1PowOut": b1p * b1,
        "Beta2PowOut": b2p * b2,
    }


@register_op("fused_adam", grad=None, is_optimizer=True)
def fused_adam(ctx, op, ins):
    return _fused_adam_impl(ctx, op, ins, coeff=0.0)


@register_op("fused_adamw", grad=None, is_optimizer=True)
def fused_adamw(ctx, op, ins):
    return _fused_adam_impl(ctx, op, ins, coeff=op.attr("coeff", 0.01))
