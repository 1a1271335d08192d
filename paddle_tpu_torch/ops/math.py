"""Math, elementwise and reduction op lowerings — the slice of
``paddle_tpu/ops/math.py`` the fluid training path runs, in torch ops:
what ResNet, the MLPs, the gradient clips, the regularizers, the LR
schedules and the transformer encoder emit. The rest of the reference's
lowerings are still to be ported (ROADMAP A5).

Where operands differ in dtype (an AMP program relabels vars by metadata
only), a product computes in their promoted dtype as JAX's does and
returns X's dtype, as the reference's ``.astype(x.dtype)`` does."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.core import dtype_to_torch
from ..framework.registry import infer_cast, infer_identity, register_op

_INFER_X = infer_identity("X", "Out")


@register_op("fill_constant", grad=None)
def fill_constant(ctx, op, ins):
    shape = [int(s) for s in op.attr("shape", [])]
    if ins.get("ShapeTensor"):
        shape = [int(x) for x in ins["ShapeTensor"][0].tolist()]
    return {"Out": torch.full(shape, op.attr("value", 0.0),
                              dtype=dtype_to_torch(op.attr("dtype", "float32")),
                              device=ctx.device)}


@register_op("fill_zeros_like", grad=None)
def fill_zeros_like(ctx, op, ins):
    return {"Out": torch.zeros_like(ins["X"][0])}


@register_op("assign")
def assign(ctx, op, ins):
    return {"Out": ins["X"][0]}


@register_op("assign_value", grad=None)
def assign_value(ctx, op, ins):
    shape = [int(s) for s in op.attr("shape")]
    values = np.asarray(op.attr("values"), dtype=np.float64).reshape(shape)
    return {"Out": torch.tensor(values, device=ctx.device).to(
        dtype_to_torch(op.attr("dtype", "float32")))}


# ---------------------------------------------------------------------------
# Elementwise binary ops: Y aligns to X at `axis` (-1: ranks aligned right)
# ---------------------------------------------------------------------------


def _broadcast_y(x, y, axis):
    if x.dim() == y.dim() or y.dim() == 0:
        return y
    if y.dim() > x.dim():
        # Y of higher rank only broadcasts if its extra leading dims are 1
        extra = y.dim() - x.dim()
        if any(d != 1 for d in y.shape[:extra]):
            raise ValueError(
                f"elementwise broadcast: Y rank {y.dim()} > X rank {x.dim()} "
                f"with non-unit leading dims {tuple(y.shape)}")
        return y.reshape(y.shape[extra:])
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    new_shape = [1] * x.dim()
    for i, d in enumerate(y.shape):
        new_shape[axis + i] = d
    return y.reshape(new_shape)


def _ew(fn):
    def lower(ctx, op, ins):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": fn(x, _broadcast_y(x, y, op.attr("axis", -1)))}

    return lower


register_op("elementwise_add", infer_shape=_INFER_X)(_ew(torch.add))
register_op("elementwise_sub", infer_shape=_INFER_X)(_ew(torch.sub))
register_op("elementwise_mul", infer_shape=_INFER_X)(_ew(torch.mul))
register_op("elementwise_div", infer_shape=_INFER_X)(_ew(torch.div))
register_op("elementwise_min", infer_shape=_INFER_X)(_ew(torch.minimum))
register_op("elementwise_max", infer_shape=_INFER_X)(_ew(torch.maximum))
register_op("elementwise_pow", infer_shape=_INFER_X)(_ew(torch.pow))


@register_op("scale", infer_shape=_INFER_X)
def scale(ctx, op, ins):
    x = ins["X"][0]
    s = op.attr("scale", 1.0)
    if ins.get("ScaleTensor"):
        s = ins["ScaleTensor"][0]
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        return {"Out": x * s + bias}
    return {"Out": (x + bias) * s}


@register_op("sum", infer_shape=_INFER_X)
def sum_op(ctx, op, ins):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("clip", infer_shape=_INFER_X)
def clip(ctx, op, ins):
    return {"Out": torch.clamp(ins["X"][0], op.attr("min"), op.attr("max"))}


@register_op("cast", diff_inputs=("X",), infer_shape=infer_cast)
def cast(ctx, op, ins):
    return {"Out": ins["X"][0].to(dtype_to_torch(op.attr("out_dtype")))}


# unary math (the reference's _UNARY table, the entries ported so far)
_UNARY = {
    "exp": torch.exp,
    "sqrt": torch.sqrt,
    "floor": torch.floor,
    "square": torch.square,
    "cos": torch.cos,
    "sign": torch.sign,
}
for _name, _fn in _UNARY.items():
    register_op(_name, infer_shape=_INFER_X)(
        (lambda fn: lambda ctx, op, ins: {"Out": fn(ins["X"][0])})(_fn)
    )


def _matmul_same(x, y):
    """``x @ y`` in the operands' promoted dtype, returned in ``x``'s."""
    ct = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(ct), y.to(ct)).to(x.dtype)


@register_op("matmul")
def matmul(ctx, op, ins):
    """The reference's matmul_op: optional transposes, 1-D operands
    lifted to matrices, the product scaled by ``alpha``."""
    x, y = ins["X"][0], ins["Y"][0]
    alpha = op.attr("alpha", 1.0)
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if op.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = _matmul_same(x, y)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("mul")
def mul(ctx, op, ins):
    """The reference's mul_op: X flattened to 2D at x_num_col_dims, Y at
    y_num_col_dims."""
    x, y = ins["X"][0], ins["Y"][0]
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xnc])), int(np.prod(xs[xnc:])))
    y2 = y.reshape(int(np.prod(ys[:ync])), int(np.prod(ys[ync:])))
    return {"Out": _matmul_same(x2, y2).reshape(xs[:xnc] + ys[ync:])}


def _reduce(fn):
    def lower(ctx, op, ins):
        x = ins["X"][0]
        dims = op.attr("dim", [0])
        keep = op.attr("keep_dim", False)
        if op.attr("reduce_all", False) or dims is None or len(dims) == 0:
            axes = tuple(range(x.dim()))
        else:
            axes = tuple(d % max(x.dim(), 1) for d in dims)
        return {"Out": fn(x, dim=axes, keepdim=keep)}

    return lower


register_op("reduce_sum")(_reduce(torch.sum))
register_op("reduce_mean")(_reduce(torch.mean))


@register_op("mean")
def mean(ctx, op, ins):
    return {"Out": torch.mean(ins["X"][0])}


@register_op("less_than", grad=None)
def less_than(ctx, op, ins):
    return {"Out": torch.lt(ins["X"][0], ins["Y"][0])}


@register_op("greater_than", grad=None)
def greater_than(ctx, op, ins):
    return {"Out": torch.gt(ins["X"][0], ins["Y"][0])}


@register_op("increment", grad=None)
def increment(ctx, op, ins):
    x = ins["X"][0]
    step = op.attr("step", 1.0)
    if not x.is_floating_point():
        step = int(step)
    return {"Out": x + step}
