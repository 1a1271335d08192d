"""Op registry: declarative op specs with PyTorch lowerings.

The port of ``paddle_tpu/framework/registry.py``. Each op registers ONE
lowering ``(ctx, op, ins) -> outs`` over torch tensors. Grad ops are IR
ops (``<type>_grad``, appended by ``backward.py``); their default
lowering is the vjp of the forward lowering. The reference gets it by
``jax.vjp`` of a replayed forward, which XLA's CSE merges with the real
one. Eager torch would pay for that second forward, so the executor
records the forward op's autograd graph when the block holds its grad op,
and the grad op runs that graph (``executor.py``).

The lowerings (``ops/math.py``, ``ops/nn.py``, ``ops/tensor.py``,
``ops/optimizer_ops.py``, ``ops/amp_ops.py``, ``ops/misc_extra2.py``)
load at the first registry lookup, so
``import paddle_tpu_torch`` stays light.

Build-time shape inference runs a lowering on ``device="meta"`` tensors
where the reference uses ``jax.eval_shape``: -1 dims are substituted with
a stand-in extent and restored after.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .core import dtype_name, dtype_to_torch

GRAD_SUFFIX = "@GRAD"

LowerFn = Callable[["LowerCtx", Any, Dict[str, List[Any]]], Dict[str, Any]]


@dataclasses.dataclass
class OpSpec:
    type: str
    lower: LowerFn
    # declared shape inference; None -> run the lowering on meta tensors
    infer_shape: Optional[Callable] = None
    # 'auto' = the recorded-vjp grad op; None = non-differentiable
    grad: Any = "auto"
    # slots eligible for gradients (None = every floating-point input slot)
    diff_inputs: Optional[Sequence[str]] = None
    # op updates persistable state in place by name (optimizer ops)
    is_optimizer: bool = False


_OPS: Dict[str, OpSpec] = {}
_LOWERING_MODULES = ("math", "nn", "tensor", "optimizer_ops", "amp_ops",
                     "misc_extra2", "collective")
_loaded = False


def register_op(type: str, **kwargs):
    """Decorator: ``@register_op("relu") def _(ctx, op, ins): ...``"""

    def deco(fn: LowerFn):
        _OPS[type] = OpSpec(type=type, lower=fn, **kwargs)
        return fn

    return deco


def _ensure_lowerings() -> None:
    global _loaded
    if not _loaded:
        _loaded = True
        for mod in _LOWERING_MODULES:
            importlib.import_module(f"paddle_tpu_torch.ops.{mod}")


def get_op_spec(type: str) -> OpSpec:
    _ensure_lowerings()
    spec = _OPS.get(type)
    if spec is None:
        if type.endswith("_grad") and type[: -len("_grad")] in _OPS:
            return _generic_grad_spec(type)
        raise NotImplementedError(
            f"op {type!r} has no lowering in paddle_tpu_torch yet "
            "(ROADMAP A5)")
    return spec


def has_op(type: str) -> bool:
    _ensure_lowerings()
    return type in _OPS or (type.endswith("_grad")
                            and type[: -len("_grad")] in _OPS)


@contextlib.contextmanager
def compute_dtypes(slots_by_type: Dict[str, Sequence[str]]):
    """Within the block, each lowering of an op type in ``slots_by_type``
    records, a call, the dtype it computes in: the promoted dtype of the
    floating-point tensors it receives in those slots (a product lowering
    computes in its operands' promoted dtype). Yields a
    ``collections.Counter`` of (op type, dtype name). An AMP rewrite's
    labels say what a var should hold; this counts what the lowerings
    were given. The executor's cached plans hold these same specs, so a
    plan built before the block is observed too; forward lowerings only
    (a grad op replays its forward op's recorded graph)."""
    seen: collections.Counter = collections.Counter()
    saved = {}
    for type_, slots in slots_by_type.items():
        spec = get_op_spec(type_)
        saved[type_] = spec.lower

        def observed(ctx, op, ins, _lower=spec.lower, _slots=tuple(slots)):
            dts = [t.dtype for s in _slots for t in ins.get(s, ())
                   if isinstance(t, torch.Tensor) and t.is_floating_point()]
            if dts:
                seen[(op.type, dtype_name(
                    functools.reduce(torch.promote_types, dts)))] += 1
            return _lower(ctx, op, ins)

        spec.lower = observed
    try:
        yield seen
    finally:
        for type_, fn in saved.items():
            _OPS[type_].lower = fn


# ---------------------------------------------------------------------------
# Lowering context
# ---------------------------------------------------------------------------


class LowerCtx:
    """What a lowering may ask of its run: the device the block runs on
    and the program's random generator (``None`` on the meta device, where
    shape inference runs).

    ``replay`` names the random ops whose draw a recomputed twin must
    repeat (``append_backward(checkpoints=)`` re-emits a segment's ops
    with renamed outputs and pins the originals' sorted output names in
    ``__rng_names__``): the reference keys every random op by its output
    names, so the twin's dropout mask is the forward's. Here the program
    draws one stream, so such an op keeps the stream's state under its
    names before it draws, and its twin draws from a generator set to
    that state — the same bits, the stream unmoved. A program without
    checkpoints saves nothing and draws as before.

    Over ranks, ``mesh_axes`` binds each ``ring_id`` to the group its
    collective ops run on (:meth:`axis_name`), and ``batch_group`` is the
    data-parallel plan's dp group."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 replay: frozenset = frozenset(), mesh_axes=None,
                 batch_group=None):
        self.device = device
        self.generator = generator
        self.replay = replay
        self._rng_states: Dict[tuple, torch.Tensor] = {}
        # ring_id -> the AxisGroup its collectives run on (the reference's
        # ring_id -> mesh axis name); empty outside a mesh
        self.mesh_axes: Dict[int, Any] = dict(mesh_axes or {})
        # the data-parallel plan's dp group: batch_norm's statistics
        # reduce over it, as the reference's batch-sharded mean does
        self.batch_group = batch_group

    def axis_name(self, ring_id: int):
        """The :class:`~paddle_tpu_torch.parallel.mesh.AxisGroup` of
        ``ring_id``, or None outside a mesh (a collective is then the
        identity, as on a ring of one)."""
        return self.mesh_axes.get(int(ring_id))

    def generator_for(self, op) -> Optional[torch.Generator]:
        """The generator a random op draws from: its own, seeded by the
        op's ``seed`` attr when that is non-zero (the reference keys such
        an op by ``PRNGKey(seed)``); a recomputed twin's, at its forward
        op's state; else the program's stream."""
        if self.device.type == "meta":
            return None
        seed = int(op.attr("seed", 0) or 0)
        if seed:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            return gen
        pinned = op.attr("__rng_names__")
        if pinned:
            state = self._rng_states.get(tuple(pinned))
            if state is None:
                raise RuntimeError(
                    f"{op.type}: a recomputed random op ran before its "
                    f"forward op (outputs {list(pinned)})")
            gen = torch.Generator(device=self.device)
            gen.set_state(state)
            return gen
        if self.replay and self.generator is not None:
            key = tuple(sorted(op.output_arg_names))
            if key in self.replay:
                self._rng_states[key] = self.generator.get_state()
        return self.generator


def gather_inputs(env, op) -> Dict[str, List[Any]]:
    """The op's input slots whose vars are all bound in ``env``."""
    return {
        slot: [env[n] for n in names]
        for slot, names in op.inputs.items()
        if all(n in env for n in names)
    }


def bind_outputs(env, op, outs: Dict[str, Any]) -> None:
    for slot, vals in outs.items():
        names = op.outputs.get(slot, [])
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(names, vals):
            if val is not None and name != "@EMPTY@":
                env[name] = val


def _generic_grad_spec(grad_type: str) -> OpSpec:
    def lower_grad(ctx, op, ins):
        raise RuntimeError(
            f"{grad_type}: the forward op's recorded graph is missing — "
            "a grad op runs inside Executor.run, after its forward op in "
            "the same block")

    return OpSpec(type=grad_type, lower=lower_grad, grad=None)


# ---------------------------------------------------------------------------
# Build-time shape inference
# ---------------------------------------------------------------------------

_DYN = 97  # stand-in extent for -1 dims on the meta device


def _copy_meta(block, out_name, shape, dtype) -> None:
    if out_name and out_name != "@EMPTY@" and \
            block._has_var_recursive(out_name):
        var = block._var_recursive(out_name)
        var.shape = tuple(shape)
        var.dtype = dtype


def infer_identity(in_slot: str = "X", out_slot: str = "Out"):
    """Declared infer_shape: every ``out_slot`` output takes the first
    ``in_slot`` input's shape and dtype (unary math, activations, scale,
    sum and the elementwise family, whose Y broadcasts into X)."""

    def infer(block, op):
        names = op.inputs.get(in_slot) or []
        if not names or not block._has_var_recursive(names[0]):
            return
        src = block._var_recursive(names[0])
        for out_name in op.outputs.get(out_slot, []):
            _copy_meta(block, out_name, src.shape, src.dtype)

    return infer


def infer_cast(block, op):
    """cast: X's shape, the attr's dtype."""
    from .core import convert_dtype

    names = op.inputs.get("X") or []
    if not names or not block._has_var_recursive(names[0]):
        return
    src = block._var_recursive(names[0])
    dtype = convert_dtype(op.attr("out_dtype", src.dtype))
    for out_name in op.outputs.get("Out", []):
        _copy_meta(block, out_name, src.shape, dtype)


def infer_shape_for_op(block, op) -> None:
    """Fill output Variable shapes and dtypes at build time: the op's
    declared infer_shape, else its lowering on meta tensors with -1 dims
    substituted. Optimizer ops write their inputs' vars back by name, so
    there is nothing to infer. Metadata only: a lowering that cannot run
    on meta tensors leaves the vars as they are, as the reference does
    when ``eval_shape`` fails."""
    try:
        spec = get_op_spec(op.type)
    except NotImplementedError:
        return
    if spec.infer_shape is not None:
        spec.infer_shape(block, op)
        return
    if op.type.endswith("_grad"):
        _infer_grad_shapes(block, op)
        return
    if spec.is_optimizer:
        return
    meta = torch.device("meta")
    try:
        ins: Dict[str, List[Any]] = {}
        for slot, names in op.inputs.items():
            for n in names:
                v = block._var_recursive(n)
                shape = [_DYN if d == -1 else d for d in v.shape]
                ins.setdefault(slot, []).append(torch.empty(
                    shape, dtype=dtype_to_torch(v.dtype), device=meta))
        with torch.no_grad():
            outs = spec.lower(LowerCtx(meta), op, ins)
    except (RuntimeError, ValueError, TypeError, IndexError,
            NotImplementedError):
        return

    for slot, vals in outs.items():
        names = op.outputs.get(slot, [])
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(names, vals):
            if val is None or not block._has_var_recursive(name):
                continue
            var = block._var_recursive(name)
            var.shape = tuple(-1 if d == _DYN else int(d) for d in val.shape)
            var.dtype = dtype_name(val.dtype)


def _infer_grad_shapes(block, op):
    """Grad of x has x's shape and dtype."""
    for slot, names in op.outputs.items():
        if not slot.endswith(GRAD_SUFFIX):
            continue
        src_slot = slot[: -len(GRAD_SUFFIX)]
        src_names = op.inputs.get(src_slot, [])
        for gname, sname in zip(names, src_names):
            if block._has_var_recursive(gname) and block._has_var_recursive(sname):
                gvar = block._var_recursive(gname)
                svar = block._var_recursive(sname)
                gvar.shape = tuple(svar.shape)
                gvar.dtype = svar.dtype
