"""Random op lowerings — the slice of ``paddle_tpu/ops/tensor.py`` the
fluid training path runs: parameter initializers and on-device synthetic
data. Each draws from ``ctx.generator_for(op)``: the program's
``torch.Generator``, or one seeded by the op's own ``seed`` attr. Torch
draws other numbers than JAX's threefry from the same seed, so parity
tests feed their data. The rest of the reference's lowerings are still
to be ported (ROADMAP A5)."""
from __future__ import annotations

import math

import torch

from ..framework.core import dtype_to_torch
from ..framework.registry import register_op


def _empty(ctx, op):
    shape = [int(s) for s in op.attr("shape")]
    return torch.empty(shape, dtype=torch.float32, device=ctx.device)


def _out_dtype(op, default="float32"):
    return dtype_to_torch(op.attr("dtype", default))


@register_op("gaussian_random", grad=None)
def gaussian_random(ctx, op, ins):
    out = _empty(ctx, op).normal_(generator=ctx.generator_for(op))
    out = op.attr("mean", 0.0) + op.attr("std", 1.0) * out
    return {"Out": out.to(_out_dtype(op))}


@register_op("uniform_random", grad=None)
def uniform_random(ctx, op, ins):
    out = _empty(ctx, op).uniform_(op.attr("min", -1.0), op.attr("max", 1.0),
                                   generator=ctx.generator_for(op))
    return {"Out": out.to(_out_dtype(op))}


_PHI_LO = 0.5 * math.erfc(2.0 / math.sqrt(2.0))     # standard normal CDF at -2


@register_op("truncated_gaussian_random", grad=None)
def truncated_gaussian_random(ctx, op, ins):
    """A standard normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal(key, -2, 2)``), by inverting the CDF of
    a uniform draw, then scaled by std and shifted by mean."""
    u = _empty(ctx, op).uniform_(_PHI_LO, 1.0 - _PHI_LO,
                                 generator=ctx.generator_for(op))
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0)
    out = z * op.attr("std", 1.0) + op.attr("mean", 0.0)
    return {"Out": out.to(_out_dtype(op))}


@register_op("randint", grad=None)
def randint(ctx, op, ins):
    shape = [int(s) for s in op.attr("shape")]
    return {"Out": torch.randint(
        op.attr("low", 0), op.attr("high", 100), shape,
        generator=ctx.generator_for(op), device=ctx.device,
        dtype=_out_dtype(op, "int64"))}
