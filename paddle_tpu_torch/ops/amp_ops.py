"""AMP op lowerings — the port of ``paddle_tpu/ops/amp_ops.py``:
``check_finite_and_unscale`` / ``amp_check_finite_and_scale``,
``update_loss_scaling`` and ``cast_with_ptr``.

Plain torch ops, as the reference's are XLA code. ``FoundInfinite``, the
loss scale and the step counters stay device tensors: nothing here reads
a value back to the host. On overflow ``update_loss_scaling`` zeroes the
gradients it is given, so the optimizer's step after it moves nothing.
"""
from __future__ import annotations

import torch

from ..framework.core import dtype_to_torch
from ..framework.registry import register_op


def _promoted(x, scale):
    """``x`` in the dtype JAX gives ``x / scale``: a float32 scale array
    promotes a bf16 or fp16 ``x`` (torch would keep a 0-dim scale's
    operand dtype)."""
    return x.to(torch.promote_types(x.dtype, scale.dtype))


@register_op("amp_check_finite_and_scale", grad=None)
def amp_check_finite_and_scale(ctx, op, ins):
    xs = ins["X"]
    scale = ins["Scale"][0].reshape(())
    finite = torch.ones((), dtype=torch.bool, device=scale.device)
    for x in xs:
        finite = finite & torch.isfinite(x).all()
    outs = [_promoted(x, scale) / scale for x in xs]
    return {"Out": outs, "FoundInfinite": (~finite).reshape(1)}


@register_op("check_finite_and_unscale", grad=None)
def check_finite_and_unscale(ctx, op, ins):
    return amp_check_finite_and_scale(ctx, op, ins)


@register_op("update_loss_scaling", grad=None, is_optimizer=True)
def update_loss_scaling(ctx, op, ins):
    """The dynamic loss-scaling state machine (the reference's
    operators/amp/update_loss_scaling_op.cc): ``decr_every_n_nan_or_inf``
    bad steps in a row scale down to ``max(prev * decr_ratio, 1.0)``,
    ``incr_every_n_steps`` good ones scale up by ``incr_ratio``."""
    found_inf = ins["FoundInfinite"][0].reshape(())
    prev_scale = ins["PrevLossScaling"][0].reshape(())
    good = ins["InGoodSteps"][0].reshape(())
    bad = ins["InBadSteps"][0].reshape(())
    incr_every = op.attr("incr_every_n_steps", 1000)
    decr_every = op.attr("decr_every_n_nan_or_inf", 2)
    incr_ratio = op.attr("incr_ratio", 2.0)
    decr_ratio = op.attr("decr_ratio", 0.5)

    zero = torch.zeros_like(bad)
    new_bad = torch.where(found_inf, bad + 1, zero)
    new_good = torch.where(found_inf, zero, good + 1)
    scale_up = new_good >= incr_every
    scale_down = new_bad >= decr_every
    new_scale = torch.where(
        scale_down, torch.clamp_min(prev_scale * decr_ratio, 1.0),
        torch.where(scale_up, prev_scale * incr_ratio, prev_scale))
    new_good = torch.where(scale_up, zero, new_good)
    new_bad = torch.where(scale_down, zero, new_bad)

    outs = {}
    if "X" in ins:
        # zero the grads on overflow so the optimizer step is a no-op
        outs["Out"] = [torch.where(found_inf, torch.zeros_like(x), x)
                       for x in ins["X"]]
    outs.update({
        "LossScaling": new_scale.reshape(1),
        "OutGoodSteps": new_good.reshape(1).to(torch.int32),
        "OutBadSteps": new_bad.reshape(1).to(torch.int32),
    })
    return outs


@register_op("cast_with_ptr", grad=None)
def cast_with_ptr(ctx, op, ins):
    return {"Out": ins["X"][0].to(dtype_to_torch(op.attr("out_dtype")))}
