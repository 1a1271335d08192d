"""Tensor-manipulation and random op lowerings — the slice of
``paddle_tpu/ops/tensor.py`` the fluid training path runs: ``reshape2``,
``slice`` and ``where``; parameter initializers and on-device synthetic
data; recompute's ``recompute_barrier``. Each random op draws from ``ctx.generator_for(op)``: the program's
``torch.Generator``, or one seeded by the op's own ``seed`` attr. Torch
draws other numbers than JAX's threefry from the same seed, so parity
tests feed their data. The rest of the reference's lowerings are still
to be ported (ROADMAP A5)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.core import dtype_to_torch
from ..framework.registry import register_op


def _infer_reshape(block, op):
    """reshape2's shape: 0 copies X's dim, one -1 is inferred when X's
    shape is known (the reference's ``_infer_reshape``)."""
    x = block._var_recursive(op.input("X")[0])
    shape = list(op.attr("shape", []))
    out_shape = []
    for i, d in enumerate(shape):
        if d == 0:
            out_shape.append(x.shape[i] if i < len(x.shape) else -1)
        else:
            out_shape.append(d)
    if -1 in out_shape and all(d != -1 for d in x.shape):
        known = int(np.prod([d for d in out_shape if d != -1]))
        total = int(np.prod(x.shape))
        out_shape[out_shape.index(-1)] = total // known
    for name in op.output("Out"):
        v = block._var_recursive(name)
        v.shape = tuple(out_shape)
        v.dtype = x.dtype


@register_op("reshape2", diff_inputs=("X",), infer_shape=_infer_reshape)
def reshape2(ctx, op, ins):
    x = ins["X"][0]
    shape = list(op.attr("shape", []))
    if ins.get("Shape"):
        shape = [int(s) for s in ins["Shape"][0].tolist()]
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return {"Out": x.reshape(shape), "XShape": None}


@register_op("slice", diff_inputs=("Input",))
def slice_op(ctx, op, ins):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(op.attr("axes"), op.attr("starts"),
                          op.attr("ends")):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(st, en)
    out = x[tuple(idx)]
    decrease = op.attr("decrease_axis", [])
    if decrease:
        out = out.squeeze(tuple(decrease))
    return {"Out": out}


@register_op("where", diff_inputs=("X", "Y"))
def where(ctx, op, ins):
    return {"Out": torch.where(ins["Condition"][0], ins["X"][0],
                               ins["Y"][0])}


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


@register_op("recompute_barrier", grad=None)
def recompute_barrier(ctx, op, ins):
    """The wall ``append_backward(checkpoints=)`` puts before a
    recomputed segment (``framework/backward.py``): an identity. The
    reference needs it as an ``optimization_barrier`` against XLA's CSE
    merging the recomputation with the forward; eager torch runs every op
    it is given, so there is nothing to defeat."""
    return {"Out": list(ins.get("X", []))}
