"""The rank grid — the port of ``paddle_tpu/parallel/mesh.py:21-102``.

JAX names the axes of a ``jax.sharding.Mesh`` of devices and lets XLA
route the collectives. The port lays the ``torch.distributed`` ranks out
row-major over the named axes, in the order JAX lays out the mesh's
devices, so rank r holds the shard JAX's device r holds, and keeps one
process group for every line of ranks along each set of axes
(:class:`AxisGroup`): the collectives of ``comm_opt`` and
``parallelize`` run on those.

Over gloo (a host transport) a collective on CUDA tensors copies them to
host memory, runs there and copies the result back — a property of the
backend, decided when the mesh is built. Over NCCL nothing is staged.

A spec is a tuple with one entry a dim: an axis name, a tuple of names or
None (replicated); it replaces ``PartitionSpec``. ``jit_shard_map`` and
``probe_produced_state`` serve the fluid path and are still to be ported
with it (ROADMAP A5).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..observability import metrics as _obs_metrics
from ..device import resolve_device

__all__ = ["MeshConfig", "Mesh", "AxisGroup", "build_mesh", "current_mesh",
           "mesh_guard", "axis_index", "axis_size", "spec_for",
           "spec_axes", "local_shape", "local_shard"]


@dataclasses.dataclass
class MeshConfig:
    """Logical mesh shape: ordered (axis_name, size) pairs; size -1 =
    inferred from the rank count (at most one)."""

    axes: List[Tuple[str, int]]

    def resolve(self, n_ranks: int) -> List[Tuple[str, int]]:
        fixed, infer_idx = 1, None
        for i, (_, size) in enumerate(self.axes):
            if size == -1:
                infer_idx = i
            else:
                fixed *= size
        axes = list(self.axes)
        if infer_idx is not None:
            axes[infer_idx] = (axes[infer_idx][0], max(n_ranks // fixed, 1))
        return axes


_m_staged_seconds = _obs_metrics.default_registry().counter(
    "paddle_collective_staged_seconds_total",
    "Host wall seconds of collectives staged through host memory (gloo), "
    "copies included, timed from a device synchronize", ("op",))


# a staged collective's profiler range: STAGED_RANGE + the op
# (comm_opt.measure_overlap_fraction reads it)
STAGED_RANGE = "paddle_collective/"


def _staged(op: str):
    """Time a collective of a staging (gloo) group into
    ``paddle_collective_staged_seconds_total{op}``: the device is
    synchronised first, so the time is the copies and the exchange, not
    the compute queued before them (a receive also waits for its peer).
    The call runs inside a ``record_function("paddle_collective/<op>")``
    range, which ``comm_opt.measure_overlap_fraction`` reads in a
    profiler capture. NCCL groups are not timed (their collectives are
    asynchronous on the stream)."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(self, t, *args, **kw):
            if not self.stage or self.size == 1:
                return fn(self, t, *args, **kw)
            with torch.profiler.record_function(STAGED_RANGE + op):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.synchronize(t.device)
                t0 = time.perf_counter()
                out = fn(self, t, *args, **kw)
                _m_staged_seconds.labels(op).inc(time.perf_counter() - t0)
            return out
        return timed
    return wrap


class _Pending:
    """An asynchronous send: the work handle and the buffer it reads,
    kept alive until :meth:`wait`."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()


class AxisGroup:
    """The ranks of this rank's line along ``names`` (mesh order): their
    global ranks in group order, this rank's index among them, and the
    process group (None at size 1, where every collective is the
    identity). ``stage`` copies CUDA tensors through host memory around
    each collective (gloo)."""

    def __init__(self, names, ranks, index, group, stage):
        self.names: Tuple[str, ...] = tuple(names)
        self.ranks: List[int] = list(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group
        self.stage = stage

    def __repr__(self):
        return (f"AxisGroup({'x'.join(self.names)}, size={self.size}, "
                f"index={self.index})")

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.stage and t.is_cuda else t

    def _out(self, shape, like: torch.Tensor) -> torch.Tensor:
        dev = "cpu" if self.stage else like.device
        return torch.empty(shape, dtype=like.dtype, device=dev)

    @_staged("all_reduce")
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the group, IN PLACE on ``t``; returns ``t``."""
        if self.size == 1:
            return t
        buf = self._host(t)
        if buf is t and not t.is_contiguous():
            buf = t.contiguous()
        dist.all_reduce(buf, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    @_staged("reduce_scatter")
    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Flat [n] (n a multiple of the size) -> this rank's summed
        [n / size] block."""
        if self.size == 1:
            return t
        src = self._host(t).contiguous()
        out = self._out((t.shape[0] // self.size,) + tuple(t.shape[1:]), t)
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return out.to(t.device)

    @_staged("all_gather")
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[k, ...] from every rank -> [size·k, ...] in group order."""
        if self.size == 1:
            return t
        src = self._host(t).contiguous()
        out = self._out((t.shape[0] * self.size,) + tuple(t.shape[1:]), t)
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.to(t.device)

    @_staged("all_to_all")
    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """[size·k, ...]: block j goes to rank j; returns the blocks
        received, in group order."""
        if self.size == 1:
            return t
        src = self._host(t).contiguous()
        out = self._out(tuple(t.shape), t)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(t.device)

    @_staged("broadcast")
    def broadcast(self, t: torch.Tensor, src_index: int) -> torch.Tensor:
        """``t`` from group index ``src_index`` to every rank, in place."""
        if self.size == 1:
            return t
        buf = self._host(t).contiguous()
        dist.broadcast(buf, src=self.ranks[src_index], group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    @_staged("send")
    def isend(self, t: torch.Tensor, peer: int, tag: int) -> _Pending:
        """Start sending ``t`` to group index ``peer``."""
        buf = self._host(t).contiguous()
        return _Pending(dist.isend(buf, dst=self.ranks[peer],
                                   group=self.group, tag=tag), buf)

    @_staged("recv")
    def recv(self, shape, dtype, device, peer: int, tag: int
             ) -> torch.Tensor:
        """Receive a ``shape`` tensor from group index ``peer``."""
        dev = "cpu" if self.stage else device
        buf = torch.empty(shape, dtype=dtype, device=dev)
        dist.recv(buf, src=self.ranks[peer], group=self.group, tag=tag)
        return buf.to(device)


class Mesh:
    """This rank's place in the grid: the axes, its coordinates, and an
    :class:`AxisGroup` for every set of axes (:meth:`group`)."""

    def __init__(self, axes: Sequence[Tuple[str, int]], device, backend,
                 private=None):
        self.axis_names = tuple(n for n, _ in axes)
        self.shape = tuple(int(s) for _, s in axes)
        self.sizes = dict(zip(self.axis_names, self.shape))
        self.size = int(np.prod(self.shape))
        self.rank = private.rank if private is not None else dist.get_rank()
        self.device = torch.device(device)
        self.backend = backend
        self.stage = backend == "gloo"
        self.coords = dict(zip(self.axis_names,
                               np.unravel_index(self.rank, self.shape)))
        self.coords = {k: int(v) for k, v in self.coords.items()}
        self._groups: Dict[Tuple[str, ...], AxisGroup] = {}
        grid = np.arange(self.size).reshape(self.shape)
        # every rank creates every group in the same order (new_group is
        # collective over the world), keeping the one holding its line
        for r in range(1, len(self.axis_names) + 1):
            for names in itertools.combinations(self.axis_names, r):
                dims = [self.axis_names.index(n) for n in names]
                rest = [d for d in range(len(self.shape)) if d not in dims]
                lines = np.transpose(grid, rest + dims).reshape(
                    -1, int(np.prod([self.shape[d] for d in dims])))
                for line in lines:
                    ranks = [int(x) for x in line]
                    pg = None
                    if len(ranks) > 1 and private is not None:
                        if len(ranks) != private.size:
                            raise NotImplementedError(
                                "a mesh over a private group has one line "
                                f"a set of axes (the group); {axes} needs "
                                "sub-groups")
                        pg = private.pg
                    elif len(ranks) > 1:
                        pg = (dist.group.WORLD if ranks == list(range(
                            dist.get_world_size())) else
                            dist.new_group(ranks=ranks))
                    if self.rank in ranks:
                        self._groups[names] = AxisGroup(
                            names, ranks, ranks.index(self.rank), pg,
                            self.stage)

    def group(self, *names) -> AxisGroup:
        """The line through this rank along ``names`` (any order; empty =
        this rank alone)."""
        names = tuple(n for n in self.axis_names if n in names)
        if not names:
            return AxisGroup((), [self.rank], 0, None, self.stage)
        return self._groups[names]

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def axis_size(self, name: str) -> int:
        return self.sizes[name]

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank={self.rank}, backend={self.backend})")


def build_mesh(config, device=None, group=None) -> Mesh:
    """A :class:`Mesh` over the initialised world (``env.
    init_distributed_env`` first), or over ``group``, an ``env.
    PrivateGroup`` (``env.init_private_group``; one line a set of axes,
    so a one-axis mesh). ``config`` is a :class:`MeshConfig` or (name,
    size) pairs whose product is the world size; ``device`` is this
    rank's device: the current CUDA device (``init_distributed_env`` set
    it) under every backend unless the caller names another, and raises
    when there is no card; the CPU only as ``device="cpu"``."""
    if group is None and not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised process group "
                           "(parallel.env.init_distributed_env)")
    if not isinstance(config, MeshConfig):
        config = MeshConfig(list(config))
    world = group.size if group is not None else dist.get_world_size()
    axes = config.resolve(world)
    total = int(np.prod([s for _, s in axes]))
    if total != world:
        raise ValueError(f"mesh axes {axes} need {total} ranks; the world "
                         f"has {world}")
    backend = group.backend if group is not None else dist.get_backend()
    device = resolve_device("cuda" if device is None else device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    return Mesh(axes, device, backend, private=group)


_current_mesh: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    return _current_mesh


@contextlib.contextmanager
def mesh_guard(mesh: Mesh):
    global _current_mesh
    old = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = old


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    mesh = mesh or _current_mesh
    if mesh is None:
        raise RuntimeError("no mesh: pass one or enter mesh_guard(mesh)")
    return mesh


def axis_index(name: str, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).axis_index(name)


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).axis_size(name)


def spec_for(var_sharding: Optional[Sequence[Optional[str]]]) -> tuple:
    """A per-dim axis-name tuple (None = replicated dim) -> a spec."""
    return () if var_sharding is None else tuple(var_sharding)


def spec_axes(spec) -> set:
    """The axis names a spec shards on."""
    out = set()
    for entry in spec:
        if entry is None:
            continue
        out.update(entry if isinstance(entry, (tuple, list)) else (entry,))
    return out


def _dim_split(entry, sizes, coords):
    """(ways, index) of one spec entry for the rank at ``coords``."""
    if entry is None:
        return 1, 0
    axes = entry if isinstance(entry, (tuple, list)) else (entry,)
    ways, idx = 1, 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
        ways *= sizes[a]
    return ways, idx


def local_shape(shape, spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shard shape of a ``shape`` array split by ``spec`` over axes of
    ``sizes``; raises when a dim does not divide."""
    out = list(shape)
    for d, entry in enumerate(spec):
        ways, _ = _dim_split(entry, sizes, {a: 0 for a in sizes})
        if out[d] % ways:
            raise ValueError(f"param dim {tuple(shape)}[{d}] not divisible "
                             f"by mesh {entry} ({ways})")
        out[d] //= ways
    return tuple(out)


def local_shard(x, spec, mesh: Mesh):
    """This rank's block of ``x`` (a tensor or numpy array) by ``spec``."""
    for d, entry in enumerate(spec):
        ways, idx = _dim_split(entry, mesh.sizes, mesh.coords)
        if ways > 1:
            n = x.shape[d] // ways
            x = x[(slice(None),) * d + (slice(idx * n, (idx + 1) * n),)]
    return x
