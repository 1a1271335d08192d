"""Optimizer update op lowerings — the port of
``paddle_tpu/ops/optimizer_ops.py``.

The per-parameter update ops: ``sgd``, ``momentum``, ``lars_momentum``,
``adam``, ``adamw``, ``adamax``, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``rmsprop`` (centered or not), ``ftrl``, ``lamb``,
``dpsgd``, ``proximal_gd`` and ``dgc_momentum``; ``ema_update`` and
``lookahead_update`` for the averaging wrappers. Each computes in
float32 as the reference does, in plain torch ops on the parameter's
device (the reference's are XLA elementwise ops; the new rules have no
fused form there, so none here). The reductions — ``lamb``'s and
``lars_momentum``'s norms, ``dpsgd``'s clip norm, ``dgc_momentum``'s
top-k threshold — sum in another order than XLA's.

The fused flat-buffer sweeps ``fused_sgd``, ``fused_momentum``,
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


@register_op("lars_momentum", grad=None, is_optimizer=True)
def lars_momentum(ctx, op, ins):
    """Layer-wise adaptive rate: the local rate from the param and grad
    norms (the reference's ``lars_momentum_op.cc``)."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = _lr(ins).float()
    mu = op.attr("mu", 0.9)
    lars_coeff = op.attr("lars_coeff", 0.001)
    lars_wd = op.attr("lars_weight_decay", 0.0005)
    eps = op.attr("epsilon", 0.0)
    pf, gf = p.float(), g.float()
    p_norm = torch.sqrt(torch.sum(pf * pf))
    g_norm = torch.sqrt(torch.sum(gf * gf))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + lars_wd * p_norm + eps), lr)
    v_new = mu * v.float() + local_lr * (gf + lars_wd * pf)
    return {"ParamOut": (pf - v_new).to(p.dtype),
            "VelocityOut": v_new.to(v.dtype)}


@register_op("adamax", grad=None, is_optimizer=True)
def adamax(ctx, op, ins):
    """Adam on the infinity norm; ``Beta1Pow`` is advanced by the
    ``scale`` op ``AdamaxOptimizer._finish_update`` appends."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf_norm = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    lr = _lr(ins).float()
    b1, b2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    inf_new = torch.maximum(b2 * inf_norm, torch.abs(gf))
    lr_t = lr / (1 - b1p.reshape(()))
    p_new = p.float() - lr_t * m_new / (inf_new + eps)
    return {"ParamOut": p_new.to(p.dtype), "MomentOut": m_new,
            "InfNormOut": inf_new}


@register_op("adagrad", grad=None, is_optimizer=True)
def adagrad(ctx, op, ins):
    p, g, moment = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _lr(ins).float()
    eps = op.attr("epsilon", 1e-6)
    gf = g.float()
    m_new = moment + gf * gf
    p_new = p.float() - lr * gf / (torch.sqrt(m_new) + eps)
    return {"ParamOut": p_new.to(p.dtype), "MomentOut": m_new}


@register_op("decayed_adagrad", grad=None, is_optimizer=True)
def decayed_adagrad(ctx, op, ins):
    p, g, moment = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _lr(ins).float()
    decay = op.attr("decay", 0.95)
    eps = op.attr("epsilon", 1e-6)
    gf = g.float()
    m_new = decay * moment + (1 - decay) * gf * gf
    p_new = p.float() - lr * gf / (torch.sqrt(m_new) + eps)
    return {"ParamOut": p_new.to(p.dtype), "MomentOut": m_new}


@register_op("adadelta", grad=None, is_optimizer=True)
def adadelta(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq_g, avg_sq_u = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = op.attr("rho", 0.95)
    eps = op.attr("epsilon", 1e-6)
    gf = g.float()
    g_acc = rho * avg_sq_g + (1 - rho) * gf * gf
    update = -torch.sqrt((avg_sq_u + eps) / (g_acc + eps)) * gf
    u_acc = rho * avg_sq_u + (1 - rho) * update * update
    return {"ParamOut": (p.float() + update).to(p.dtype),
            "AvgSquaredGradOut": g_acc, "AvgSquaredUpdateOut": u_acc}


@register_op("rmsprop", grad=None, is_optimizer=True)
def rmsprop(ctx, op, ins):
    """RMSProp with momentum; ``centered`` keeps the mean gradient
    (``MeanGrad``) and divides by the centred second moment."""
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    lr = _lr(ins).float()
    eps = op.attr("epsilon", 1e-10)
    decay = op.attr("decay", 0.9)
    momentum_c = op.attr("momentum", 0.0)
    gf = g.float()
    ms_new = decay * ms + (1 - decay) * gf * gf
    outs = {}
    if op.attr("centered", False):
        mg = ins["MeanGrad"][0]
        mg_new = decay * mg + (1 - decay) * gf
        denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
        outs["MeanGradOut"] = mg_new
    else:
        denom = torch.sqrt(ms_new + eps)
    mom_new = momentum_c * mom + lr * gf / denom
    outs.update({"ParamOut": (p.float() - mom_new).to(p.dtype),
                 "MeanSquareOut": ms_new, "MomentOut": mom_new})
    return outs


@register_op("ftrl", grad=None, is_optimizer=True)
def ftrl(ctx, op, ins):
    """Follow-the-regularized-leader with l1 / l2 and ``lr_power``."""
    p, g = ins["Param"][0], ins["Grad"][0]
    sq_acc, lin_acc = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    lr = _lr(ins).float()
    l1 = op.attr("l1", 0.0)
    l2 = op.attr("l2", 0.0)
    lr_power = op.attr("lr_power", -0.5)
    gf = g.float()
    new_sq = sq_acc + gf * gf
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq_acc)) / lr
        y = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (torch.pow(new_sq, -lr_power)
                 - torch.pow(sq_acc, -lr_power)) / lr
        y = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    new_lin = lin_acc + gf - sigma * p.float()
    pre = torch.clamp(new_lin, -l1, l1)
    p_new = torch.where(torch.abs(new_lin) > l1, (pre - new_lin) / y,
                        torch.zeros_like(new_lin))
    return {"ParamOut": p_new.to(p.dtype), "SquaredAccumOut": new_sq,
            "LinearAccumOut": new_lin}


@register_op("lamb", grad=None, is_optimizer=True)
def lamb(ctx, op, ins):
    """Layer-adaptive large-batch Adam (the reference's ``lamb_op.cc``):
    Adam's bias-corrected step plus the weight decay, scaled by the trust
    ratio ||p|| / ||r|| (1 where either norm is 0)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = _lr(ins).float()
    b1, b2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-6)
    wd = op.attr("weight_decay", 0.01)
    gf = g.float()
    pf = p.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    m_hat = m_new / (1 - b1p.reshape(()).float() * b1)
    v_hat = v_new / (1 - b2p.reshape(()).float() * b2)
    r = m_hat / (torch.sqrt(v_hat) + eps) + wd * pf
    p_norm = torch.sqrt(torch.sum(pf * pf))
    r_norm = torch.sqrt(torch.sum(r * r))
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    p_new = pf - lr * ratio * r
    return {
        "ParamOut": p_new.to(p.dtype),
        "Moment1Out": m_new,
        "Moment2Out": v_new,
        "Beta1PowOut": b1p * b1,
        "Beta2PowOut": b2p * b2,
    }


@register_op("dpsgd", grad=None, is_optimizer=True)
def dpsgd(ctx, op, ins):
    """Differentially private SGD (the reference's ``dpsgd_op.cc``): the
    gradient clipped to norm ``clip``, Gaussian noise of std
    ``sigma * clip`` added (drawn from ``ctx.generator_for(op)``: torch's
    bits, not threefry's), divided by ``batch_size``."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins).float()
    clip = op.attr("clip", 10.0)
    batch_size = op.attr("batch_size", 16.0)
    sigma = op.attr("sigma", 1.0)
    gf = g.float()
    g_norm = torch.sqrt(torch.sum(gf * gf))
    scale = torch.clamp_max(clip / torch.clamp_min(g_norm, 1e-12), 1.0)
    noise = sigma * clip * torch.randn(
        gf.shape, generator=ctx.generator_for(op), device=gf.device)
    g_priv = (gf * scale + noise) / batch_size
    return {"ParamOut": (p.float() - lr * g_priv).to(p.dtype)}


@register_op("proximal_gd", grad=None, is_optimizer=True)
def proximal_gd(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins).float()
    l1, l2 = op.attr("l1", 0.0), op.attr("l2", 0.0)
    prox = p.float() - lr * g.float()
    p_new = torch.sign(prox) * torch.clamp_min(
        torch.abs(prox) - lr * l1, 0.0) / (1.0 + lr * l2)
    return {"ParamOut": p_new.to(p.dtype)}


@register_op("ema_update", grad=None, is_optimizer=True)
def ema_update(ctx, op, ins):
    p, ema = ins["Param"][0], ins["Ema"][0]
    decay = op.attr("decay", 0.999)
    return {"EmaOut": decay * ema + (1.0 - decay) * p.to(ema.dtype)}


@register_op("lookahead_update", grad=None, is_optimizer=True)
def lookahead_update(ctx, op, ins):
    """Every ``k``-th run (by the step counter ``Step``) the slow weights
    move ``alpha`` of the way to the fast ones and the fast take them."""
    p, slow = ins["Param"][0], ins["Slow"][0]
    step = ins["Step"][0].reshape(())
    alpha = op.attr("alpha", 0.5)
    sync = (step % op.attr("k", 5)) == 0
    new_slow = torch.where(sync, slow + alpha * (p.to(slow.dtype) - slow),
                           slow)
    new_p = torch.where(sync, new_slow.to(p.dtype), p)
    return {"ParamOut": new_p, "SlowOut": new_slow}


@register_op("dgc_momentum", grad=None, is_optimizer=True)
def dgc_momentum(ctx, op, ins):
    """Deep Gradient Compression momentum (Lin et al. 2018; the
    reference's ``DGCMomentumOptimizer``). From ``rampup_begin_step`` on
    (by ``CurrentStep``), the local accumulation with momentum
    correction and masking:

        u = mu * u + g;  v = v + u
        mask = |v| >= the k-th largest |v|, k = max(1, round(numel *
               (1 - sparsity))) (ties keep every element at the threshold)
        p = p - lr * (v * mask);  v, u = 0 where mask

    before it, plain momentum on ``U``. Over ranks the sparse gradient,
    and the dense one before ramp-up, are averaged over ``ring_id``'s
    group (the reference's ``pmean`` over its dp axis: each rank's
    gradient is its rows' mean); on one rank there is nothing to
    reduce."""
    p, g = ins["Param"][0], ins["Grad"][0]
    u, v = ins["U"][0], ins["V"][0]
    step = ins["CurrentStep"][0] if ins.get("CurrentStep") else None
    lr = _lr(ins).float()
    mu = float(op.attr("mu", 0.9))
    sparsity = float(op.attr("sparsity", 0.999))
    rampup_begin = float(op.attr("rampup_begin_step", 0.0))
    use_nesterov = bool(op.attr("use_nesterov", False))

    gf, pf, uf, vf = g.float(), p.float(), u.float(), v.float()
    group = ctx.axis_name(op.attr("ring_id", 0))

    def pmean(x):
        if group is None or group.size == 1:
            return x
        from .collective import _sum

        return _sum(x, group, mean=True)

    # the DGC branch: SGD on the sparsified accumulation
    u_acc = mu * uf + gf
    v_acc = vf + u_acc
    flat = v_acc.reshape(-1)
    k = max(1, int(round(flat.numel() * (1.0 - sparsity))))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    mask = (torch.abs(flat) >= thresh).reshape(v_acc.shape)
    sparse = torch.where(mask, v_acc, 0.0)
    v_dgc = torch.where(mask, 0.0, v_acc)
    u_dgc = torch.where(mask, 0.0, u_acc)
    p_dgc = pf - lr * pmean(sparse)

    # the plain momentum branch (before rampup)
    g_all = pmean(gf)
    u_mom = mu * uf + g_all
    if use_nesterov:
        p_mom = pf - (g_all + mu * u_mom) * lr
    else:
        p_mom = pf - lr * u_mom

    if step is not None:
        in_dgc = step.float().reshape(()) >= rampup_begin
        p_new = torch.where(in_dgc, p_dgc, p_mom)
        u_new = torch.where(in_dgc, u_dgc, u_mom)
        v_new = torch.where(in_dgc, v_dgc, vf)
    else:
        p_new, u_new, v_new = p_dgc, u_dgc, v_dgc
    return {"ParamOut": p_new.to(p.dtype), "UOut": u_new.to(u.dtype),
            "VOut": v_new.to(v.dtype)}


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
