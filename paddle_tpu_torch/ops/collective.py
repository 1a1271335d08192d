"""Collective op lowerings — the port of ``paddle_tpu/ops/collective.py``
(the reference's ``operators/collective/``: ``c_allreduce_{sum,max,min,
prod,avg}``, ``c_allgather``, ``c_reducescatter``, ``c_broadcast``,
``c_concat``, ``c_split``, ``c_identity``, the legacy ``allreduce`` and
``broadcast``, and the bootstrap and stream ops as no-ops).

A ``ring_id`` names a group of ranks: ``ctx.axis_name(ring_id)`` is the
:class:`~paddle_tpu_torch.parallel.mesh.AxisGroup` the per-rank plan bound
it to. Outside any mesh (one rank) every op is the identity, as on a ring
of one. Each op is differentiable as the reference's vjp of its lowering
is, the program's loss being the sum of the ranks' losses: the transpose
of an all-reduce sum is an all-reduce sum, of an all-gather a
reduce-scatter, and so on. Every exchange passes
``comm_opt.record_collective`` (``paddle_collective_bytes_total{op,
dtype}``), in the backward too.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op


def _comm():
    from ..parallel import comm_opt

    return comm_opt


def _record(kind: str, x: torch.Tensor, group, factor: int = 1) -> None:
    _comm().record_collective(kind, x.dtype,
                              x.numel() * x.element_size() * factor,
                              group.size)


def _group(ctx, op):
    g = ctx.axis_name(op.attr("ring_id", 0))
    return g if g is not None and g.size > 1 else None


def _sum(x: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
    """The sum (or mean) of ``x`` over ``group``, a new tensor."""
    _record("psum", x, group)
    out = group.all_reduce(x.clone())
    return out / group.size if mean else out


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """[size, *x.shape]: every rank's ``x`` in group order."""
    _record("all_gather", x, group, group.size)
    return group.all_gather(x.reshape((1,) + tuple(x.shape)).contiguous())


def _scatter_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Reduce-scatter along dim 0: [size·k, ...] -> this rank's summed
    [k, ...]."""
    _record("psum_scatter", x, group)
    return group.reduce_scatter(x.contiguous())


class _AllReduce(torch.autograd.Function):
    """sum / avg / max / min / prod over the group; the backward is the
    vjp of the per-rank program whose loss sums the ranks' losses."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        if kind in ("sum", "avg"):
            return _sum(x, group, mean=kind == "avg")
        every = _gather(x, group)
        if kind == "max":
            y = every.amax(0)
        elif kind == "min":
            y = every.amin(0)
        else:
            y = every.prod(0)
            # the product of the other ranks' values (no division by x)
            r = group.index
            ctx.others = (every[:r].prod(0) if r else torch.ones_like(x)) \
                * (every[r + 1:].prod(0) if r + 1 < group.size
                   else torch.ones_like(x))
        if kind in ("max", "min"):
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        total = _sum(g, ctx.group, mean=ctx.kind == "avg")
        if ctx.kind in ("sum", "avg"):
            return total, None, None
        if ctx.kind == "prod":
            return total * ctx.others, None, None
        x, y = ctx.saved_tensors
        return total * (x == y).to(total.dtype), None, None


class _AllGather(torch.autograd.Function):
    """Concatenation along ``dim`` of every rank's ``x``; the backward
    sums the cotangents and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        every = _gather(x, group)               # [size, ...]
        return torch.cat(list(every.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        if dim == 0:
            return _scatter_sum(g, group), None, None
        total = _sum(g, group)
        return total.chunk(group.size, dim=dim)[group.index].contiguous(), \
            None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        every = _gather(g, ctx.group)
        return every.reshape((-1,) + tuple(g.shape[1:])), None


class _Broadcast(torch.autograd.Function):
    """``root``'s value on every rank; the cotangents' sum flows back to
    the root alone."""

    @staticmethod
    def forward(ctx, x, group, root):
        ctx.group, ctx.root = group, root
        every = _gather(x, group)
        return every[root].clone()

    @staticmethod
    def backward(ctx, g):
        total = _sum(g, ctx.group)
        if ctx.group.index != ctx.root:
            total = torch.zeros_like(total)
        return total, None, None


def _identity(x):
    return x.clone()


def _allreduce(kind: str):
    def lower(ctx, op, ins):
        x = ins["X"][0]
        group = _group(ctx, op)
        if group is None:
            return {"Out": _identity(x)}
        return {"Out": _AllReduce.apply(x, group, kind)}

    return lower


for _kind in ("sum", "max", "min", "prod", "avg"):
    register_op(f"c_allreduce_{_kind}", diff_inputs=("X",))(
        _allreduce(_kind))


@register_op("c_allgather", diff_inputs=("X",))
def c_allgather(ctx, op, ins):
    x = ins["X"][0]
    group = _group(ctx, op)
    if group is None:
        return {"Out": _identity(x)}
    return {"Out": _AllGather.apply(x, group, 0)}


@register_op("c_reducescatter", diff_inputs=("X",))
def c_reducescatter(ctx, op, ins):
    x = ins["X"][0]
    group = _group(ctx, op)
    if group is None:
        return {"Out": _identity(x)}
    return {"Out": _ReduceScatter.apply(x, group)}


@register_op("c_broadcast", diff_inputs=("X",))
def c_broadcast(ctx, op, ins):
    x = ins["X"][0]
    group = _group(ctx, op)
    if group is None:
        return {"Out": _identity(x)}
    return {"Out": _Broadcast.apply(x, group, int(op.attr("root", 0)))}


@register_op("c_concat", diff_inputs=("X",))
def c_concat(ctx, op, ins):
    """Model-parallel concat: every rank's ``x`` along the last dim."""
    x = ins["X"][0]
    group = _group(ctx, op)
    if group is None:
        return {"Out": _identity(x)}
    return {"Out": _AllGather.apply(x, group, x.dim() - 1)}


@register_op("c_split", diff_inputs=("X",))
def c_split(ctx, op, ins):
    """This rank's block of the last dim (no exchange; the reference's
    vjp pads the cotangent with zeros)."""
    x = ins["X"][0]
    group = _group(ctx, op)
    if group is None:
        return {"Out": _identity(x)}
    return {"Out": x.chunk(group.size, dim=-1)[group.index].clone()}


@register_op("c_identity", diff_inputs=("X",))
def c_identity(ctx, op, ins):
    return {"Out": _identity(ins["X"][0])}


@register_op("broadcast", diff_inputs=("X",))
def legacy_broadcast(ctx, op, ins):
    return c_broadcast(ctx, op, ins)


@register_op("allreduce", diff_inputs=("X",))
def legacy_allreduce(ctx, op, ins):
    """reduce_type 0 sum, 1 max, 2 min (another value sums)."""
    x = ins["X"][0]
    group = _group(ctx, op)
    if group is None:
        return {"Out": _identity(x)}
    kind = {1: "max", 2: "min"}.get(int(op.attr("reduce_type", 0)), "sum")
    return {"Out": _AllReduce.apply(x, group, kind)}


# bootstrap and stream ops: the process group and program order stand in
# for them; kept as no-ops so transpiled reference programs run
def _passthrough(ctx, op, ins):
    return {"Out": ins["X"][0]} if ins.get("X") else {}


for _t in ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id",
           "c_sync_calc_stream", "c_sync_comm_stream", "c_wait_comm",
           "c_wait_compute", "barrier"):
    register_op(_t, grad=None)(_passthrough)
