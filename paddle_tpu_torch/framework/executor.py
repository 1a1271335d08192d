"""Executor: runs a Program's block 0 op by op on one torch device.

The port of ``paddle_tpu/framework/executor.py``, with the same user API
(``Executor.run(program, feed, fetch_list, feed_var_name,
fetch_var_name, scope, return_numpy, use_program_cache)``,
``Scope``, ``global_scope``, ``scope_guard``). Where the reference
compiles a whole block into one XLA executable, this runs each op's
lowering eagerly on the place's device:

- persistables are read from the scope by name before the run and the
  ones the block writes (parameters, BN's ``MeanOut``/``VarianceOut``,
  optimizer accumulators) are written back after it; one the block reads
  but the scope lacks is a ``RuntimeError`` (run the startup program
  first);
- feeds are cast to their var's declared dtype;
- a forward op whose grad op is in the block runs with autograd on and
  keeps its graph — edges only, no tensor — and the grad op runs that
  graph for the cotangents it is given (``torch.autograd.grad``), which
  frees it; each recorded op's inputs enter through a cut node, so its
  grad op never walks into another op's graph;
- a var the block no longer reads is dropped from the environment after
  its last use (a grad op reads only its ``@GRAD`` slots: the recorded
  graph holds what it saved), so activations live as long as a graph
  needs them;
- random ops draw from one ``torch.Generator`` for each program, seeded
  by ``program.random_seed`` at its first run; a recomputed random op
  repeats its forward op's draw (``registry.LowerCtx``);
- a program ``GradientMergeOptimizer`` annotated runs its forward and
  backward once a microbatch and its optimizer tail once
  (``parallel/grad_merge.py``); one ``PipelineOptimizer`` annotated runs
  as GPipe stages over ranks (``parallel/pipeline_program.py``).

Over ranks (``Executor.run`` of a ``CompiledProgram``, or of a program
whose ``_annotations["mesh"]`` says so), each rank is a
``torch.distributed`` process that calls ``run`` with the GLOBAL batch
and takes its own rows along dim 0 (:func:`plan_for_program` routes):

- the data-parallel plan (:class:`DataParallelBlock`, the reference's
  ``gspmd`` mode) gives the single-device run's numbers: the gradients
  all-reduced over dp after the backward region (averaged for a
  ``mean`` / ``reduce_mean`` loss, summed for ``reduce_sum`` / ``sum``),
  ``batch_norm`` on the whole dp group's statistics, a fetched batch var
  gathered;
- the per-rank plan (:class:`PerRankBlock`, the ``shard_map`` mode) runs
  a program that carries its own collective ops, each ``ring_id`` bound
  to a group of the mesh; a fetch is every rank's value concatenated
  along dim 0, and each rank keeps the persistables it wrote.

The JAX jit, its dispatch fast path, host ops, datasets and checkpoints
are still to be ported (ROADMAP A5). ``scope_from_numpy`` carries state
across: the JAX scope's persistables, as numpy arrays by name, become a
scope of this one.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.graph import get_gradient_edge

from .core import CUDAPlace, Place, dtype_to_torch
from .program import Program, Variable, default_main_program
from .registry import (GRAD_SUFFIX, LowerCtx, bind_outputs, gather_inputs,
                       get_op_spec)

__all__ = ["Scope", "global_scope", "scope_guard", "Executor",
           "scope_from_numpy", "MeshPlan", "plan_for_program",
           "DataParallelBlock", "PerRankBlock"]


class Scope:
    """Name -> tensor map: the persistables a program reads and writes."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}

    def var(self, name: str):
        return self._vars.setdefault(name, None)

    def set_var(self, name: str, value):
        self._vars[name] = value

    def find_var(self, name: str):
        return self._vars.get(name)

    def has_var(self, name: str) -> bool:
        return name in self._vars


_scope_stack: List[Scope] = [Scope()]


def global_scope() -> Scope:
    return _scope_stack[-1]


class scope_guard:
    """Swap the ambient global scope so ``Executor.run`` defaults into
    ``scope``."""

    def __init__(self, scope: Scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _scope_stack.pop()


def _tensor_from_numpy(arr, device: torch.device) -> torch.Tensor:
    """A copy of ``arr`` on ``device``; bfloat16 arrays (ml_dtypes, as
    ``np.asarray`` of a JAX array gives them) keep their bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(device)
    return torch.tensor(arr, device=device)


def scope_from_numpy(arrays: Dict[str, Any],
                     place: Optional[Place] = None) -> Scope:
    """A scope holding a copy of each named array on ``place``'s device
    (default ``CUDAPlace(0)``): how parameters, BN statistics and
    optimizer accumulators cross from the JAX package's scope."""
    device = (place if place is not None else CUDAPlace(0)).torch_device()
    scope = Scope()
    for name, arr in arrays.items():
        scope.set_var(name, _tensor_from_numpy(arr, device))
    return scope


def _normalize_feed(var, value, device: torch.device) -> torch.Tensor:
    """A fed value on ``device``, cast to its var's declared dtype."""
    t = value if isinstance(value, torch.Tensor) else \
        _tensor_from_numpy(value, device)
    if var is not None and t.dtype != dtype_to_torch(var.dtype):
        t = t.to(dtype_to_torch(var.dtype))
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16
        t = t.float()
    return t.numpy()


def _analyze_persistables(program: Program) -> Tuple[List[str], List[str]]:
    """Persistables read from the scope (before any op produces them) and
    persistables written back to it by block-0 ops."""
    block = program.global_block()
    persistable = {n for n, v in block.vars.items() if v.persistable}
    read, written = [], []
    produced: set = set()
    for op in block.ops:
        for n in op.input_arg_names:
            if n in persistable and n not in produced and n not in read:
                read.append(n)
        for n in op.output_arg_names:
            produced.add(n)
            if n in persistable and n not in written:
                written.append(n)
    return read, written


# ---------------------------------------------------------------------------
# Recorded forward ops and their grad ops
# ---------------------------------------------------------------------------


class _Cut(torch.autograd.Function):
    """Where a recorded op's input enters its graph: a view of the input
    whose only edge goes to ``anchor``, a scalar leaf. The grad op
    captures the gradient at this node, so the graph search stops here
    and never runs another op's nodes; the node holds no tensor."""

    @staticmethod
    def forward(ctx, x, anchor):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a grad op walked past its forward op's inputs")


class _Record:
    """A recorded forward op: the gradient edges of its differentiable
    inputs (with their shapes and dtypes, for zero gradients) and of its
    outputs that carry gradient (with their dtypes)."""

    __slots__ = ("inputs", "outputs")

    def __init__(self):
        self.inputs: List[Tuple[Tuple[str, int], Any, torch.Size,
                                torch.dtype]] = []
        self.outputs: Dict[Tuple[str, int], Tuple[Any, torch.dtype]] = {}


# a recomputed op writes a checkpoint it also makes to <name>@RCdup<s>,
# while its grad op's desc names the checkpoint, as the reference's does
_RCDUP = re.compile(r"@RCdup\d+$")


def _out_key(outputs: Dict[str, List[str]]):
    """The key pairing a grad op's ``__fwd__`` desc with its forward op:
    the outputs by slot, a recomputed checkpoint read as the checkpoint."""
    return tuple(sorted((k, tuple(_RCDUP.sub("", n) for n in v))
                        for k, v in outputs.items()))


class _Plan:
    """What a run of (program version, fetch list) needs, computed once
    for the ops ``[lo, hi)`` of block 0 (all of them by default): each
    op's spec; which grad op runs which forward op's graph, and which
    input positions of that op it asks gradients for; the persistables
    read and written (over the whole block); the vars to drop after each
    op, all but the persistables, the fetches and ``keep``; the random
    ops a recomputed twin replays."""

    def __init__(self, program: Program, fetch_names: Sequence[str],
                 lo: int = 0, hi: Optional[int] = None,
                 keep: Sequence[str] = ()):
        self.program = program
        block = program.global_block()
        ops = self.ops = block.ops[lo:hi]
        self.specs = [get_op_spec(op.type) for op in ops]
        self.grad_of: Dict[int, int] = {}
        self.record: Dict[int, Dict[str, List[int]]] = {}
        producers: Dict[Any, int] = {}
        for i, op in enumerate(ops):
            fwd = op.attrs.get("__fwd__") if op.type.endswith("_grad") \
                else None
            if fwd is None:
                producers[(op.type, _out_key(op.outputs))] = i
                continue
            j = producers.get((fwd["type"], _out_key(fwd["outputs"])))
            if j is None:
                raise RuntimeError(
                    f"{op.type} (op {lo + i}) has no forward op before it "
                    "in the block")
            self.grad_of[i] = j
            want = self.record.setdefault(j, {})
            for gslot, names in op.outputs.items():
                if gslot.endswith(GRAD_SUFFIX):
                    pos = [k for k, n in enumerate(names) if n != "@EMPTY@"]
                    if pos:
                        want[gslot[: -len(GRAD_SUFFIX)]] = pos
        self.replay = frozenset(
            tuple(op.attrs["__rng_names__"]) for i, op in enumerate(ops)
            if i not in self.grad_of and op.attrs.get("__rng_names__"))
        self.read, self.written = _analyze_persistables(program)
        keep = set(keep)
        keep.update(n for n, v in block.vars.items() if v.persistable)
        keep.update(fetch_names)
        last: Dict[str, int] = {}
        for i, op in enumerate(ops):
            if i in self.grad_of:
                reads = [n for s, ns in op.inputs.items()
                         if s.endswith(GRAD_SUFFIX) for n in ns]
            else:
                reads = op.input_arg_names
            for n in reads + op.output_arg_names:
                last[n] = i
        self.free_after: List[List[str]] = [[] for _ in ops]
        for n, i in last.items():
            if n not in keep:
                self.free_after[i].append(n)

    def run(self, exe: "Executor", feed, fetch_names, scope: "Scope",
            return_numpy: bool):
        """One run of the program on ``exe``'s device: the scope's
        persistables and the feeds in, the written persistables back to
        the scope, the fetches out."""
        block = self.program.global_block()
        env = exe._read_scope(self, scope)
        for name, value in (feed or {}).items():
            env[name] = _normalize_feed(block.vars.get(name), value,
                                        exe.device)
        self.run_ops(exe._ctx(self), env, exe.device)
        exe._write_scope(self, env, scope)
        return exe._fetch(env, fetch_names, return_numpy)

    def run_ops(self, ctx: LowerCtx, env: Dict[str, Any],
                device: torch.device) -> None:
        """Run the plan's ops over ``env`` (no autograd but the recorded
        ops'), binding their outputs and dropping each var after its last
        use."""
        anchor = (torch.zeros((), device=device, requires_grad=True)
                  if self.record else None)
        records: Dict[int, _Record] = {}
        with torch.no_grad():
            for i, op in enumerate(self.ops):
                j = self.grad_of.get(i)
                if j is not None:
                    _run_grad(env, op, records.pop(j, None), device)
                elif i in self.record:
                    records[i] = _run_recorded(ctx, env, op, self.specs[i],
                                               self.record[i], anchor)
                else:
                    bind_outputs(env, op, self.specs[i].lower(
                        ctx, op, gather_inputs(env, op)))
                for n in self.free_after[i]:
                    env.pop(n, None)


def _run_recorded(ctx: LowerCtx, env, op, spec, want: Dict[str, List[int]],
                  anchor: torch.Tensor) -> _Record:
    """Run a forward op with autograd on; bind its outputs detached and
    return the gradient edges its grad op needs."""
    rec = _Record()
    ins = gather_inputs(env, op)
    with torch.enable_grad():
        for slot, positions in want.items():
            if slot not in ins:
                continue
            vals = ins[slot] = list(ins[slot])
            for pos in positions:
                t = vals[pos]
                if not t.is_floating_point():
                    continue
                vals[pos] = _Cut.apply(t, anchor)
                rec.inputs.append(((slot, pos), get_gradient_edge(vals[pos]),
                                   t.shape, t.dtype))
        outs = spec.lower(ctx, op, ins)
    bound = {}
    for slot, vals in outs.items():
        if vals is None:
            continue
        single = not isinstance(vals, (list, tuple))
        vals = [vals] if single else list(vals)
        for pos, val in enumerate(vals):
            if isinstance(val, torch.Tensor) and val.requires_grad:
                rec.outputs[(slot, pos)] = (get_gradient_edge(val), val.dtype)
                vals[pos] = val.detach()
        bound[slot] = vals[0] if single else vals
    bind_outputs(env, op, bound)
    return rec


def _run_grad(env, op, rec: Optional[_Record], device: torch.device) -> None:
    """A grad op: the recorded graph of its forward op, for the cotangents
    bound to its ``<slot>@GRAD`` inputs. A gradient that does not reach
    an input is zeros, as the reference's vjp gives it."""
    if rec is None:
        raise RuntimeError(f"{op.type}: its forward op's graph was not "
                           "recorded (or its grad op ran twice)")
    roots, cots = [], []
    for (slot, pos), (edge, dtype) in rec.outputs.items():
        gnames = op.inputs.get(slot + GRAD_SUFFIX)
        if not gnames or pos >= len(gnames) or gnames[pos] not in env:
            continue
        g = env[gnames[pos]]
        roots.append(edge)
        cots.append(g if g.dtype == dtype else g.to(dtype))
    if not rec.inputs:
        return
    if roots:
        grads = torch.autograd.grad(roots, [e for _, e, _, _ in rec.inputs],
                                    cots, allow_unused=True)
    else:
        grads = [None] * len(rec.inputs)
    for ((slot, pos), _edge, shape, dtype), g in zip(rec.inputs, grads):
        name = op.outputs[slot + GRAD_SUFFIX][pos]
        if g is None:
            g = torch.zeros(shape, dtype=dtype, device=device)
        env[name] = g


# ---------------------------------------------------------------------------
# Over ranks: the mesh plan and its two blocks
# ---------------------------------------------------------------------------

# op types whose presence makes a data-parallel program per-rank (the
# reference's shard_map mode): its collectives sync it, not the plan
_PER_RANK_OPS = ("allreduce", "broadcast", "dgc_momentum",
                 "sync_batch_norm", "sync_batch_norm_grad")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How a program maps onto the ranks: ``mode`` single | gspmd (the
    data-parallel plan) | shard_map (the per-rank plan), the mesh's
    ``axes`` ((name, size) pairs; -1 is the rest of the world), the axis
    the batch splits over, and ``ring_axes`` (ring_id -> axis name)."""

    mode: str = "single"
    axes: Tuple[Tuple[str, int], ...] = ()
    data_axis: Optional[str] = None
    ring_axes: Any = dataclasses.field(default_factory=dict)

    def signature(self):
        return (self.mode, self.axes, self.data_axis,
                tuple(sorted(self.ring_axes.items())) if self.ring_axes
                else ())


def plan_for_program(program: Program, compiled=None) -> Optional[MeshPlan]:
    """The reference's ``plan_for_program``: ``with_data_parallel`` gives
    the data-parallel plan over ("dp", num_devices), or the per-rank plan
    when the program carries ``c_*``, ``allreduce``, ``broadcast``,
    ``dgc_momentum`` or ``sync_batch_norm`` ops; a program's
    ``_annotations["mesh"]`` ({mode, axes, data_axis, ring_axes}) gives
    its own; else None (one rank)."""
    if compiled is not None and compiled._is_data_parallel:
        has_collectives = any(
            op.type.startswith("c_") or op.type in _PER_RANK_OPS
            for op in program.global_block().ops)
        n = compiled.num_devices
        return MeshPlan(mode="shard_map" if has_collectives else "gspmd",
                        axes=(("dp", n),), data_axis="dp",
                        ring_axes=dict(compiled._mesh_axes) or {0: "dp"})
    m = program._annotations.get("mesh")
    if m is None:
        return None
    return MeshPlan(mode=m.get("mode", "gspmd"),
                    axes=tuple(tuple(a) for a in m.get("axes", ())),
                    data_axis=m.get("data_axis"),
                    ring_axes=dict(m.get("ring_axes", {})))


def resolve_axes(axes) -> Tuple[Tuple[str, int], ...]:
    """``axes`` with a -1 size resolved by the world size (1 without a
    world); raises when the product is not the world's size."""
    import torch.distributed as dist

    world = (dist.get_world_size() if dist.is_available()
             and dist.is_initialized() else 1)
    fixed = int(np.prod([s for _, s in axes if s != -1])) if axes else 1
    out = tuple((n, world // fixed if s == -1 else int(s)) for n, s in axes)
    total = int(np.prod([s for _, s in out])) if out else 1
    if total != world:
        raise ValueError(
            f"the mesh {list(out)} needs {total} ranks; the torch."
            f"distributed world has {world} (start one process a rank: "
            "parallel.launch, or places= of that length)")
    return out


def run_mesh(axes, exe: "Executor"):
    """The mesh of ``axes`` (resolved) over the world on ``exe``'s device,
    or None when the whole mesh is one rank."""
    axes = resolve_axes(axes)
    if int(np.prod([s for _, s in axes])) == 1:
        return None
    return exe._mesh(axes)


def _leading(value) -> Optional[int]:
    shape = getattr(value, "shape", None)
    return int(shape[0]) if shape is not None and len(shape) else None


def grad_vars(block, ops) -> Dict[str, str]:
    """Each trainable parameter's final gradient var among ``ops``'
    outputs (``<param>@GRAD`` or, after an accumulation, its ``@SUM``
    form): the last one written."""
    params = {p.name for p in block.all_parameters()
              if getattr(p, "trainable", True)}
    last: Dict[str, str] = {}
    for op in ops:
        for n in op.output_arg_names:
            head, sep, _ = n.partition(GRAD_SUFFIX)
            if sep and head in params:
                last[head] = n
    return last


def _is_backward(op) -> bool:
    return bool(int(op.attr("op_role", 0) or 0) & Program.OP_ROLE_BACKWARD)


def backward_end(ops) -> int:
    """Where the optimizer tail starts: the first ``__opt_tail__`` op, else
    the op after the last backward op (op_role BACKWARD), else the end."""
    for idx, op in enumerate(ops):
        if op.attr("__opt_tail__", 0):
            return idx
    end = 0
    for idx, op in enumerate(ops):
        if _is_backward(op):
            end = idx + 1
    return end or len(ops)


_MEAN_LOSS, _SUM_LOSS = ("mean", "reduce_mean"), ("reduce_sum", "sum")
# ops that work row by row on any batched input: each row of the output
# is made from the same row of the inputs, so a rank's rows give its rows
_ROW_WISE = frozenset((
    "assign", "cast", "cast_with_ptr", "clip", "cos", "dropout", "exp",
    "fill_zeros_like", "floor", "greater_than", "hard_sigmoid", "hard_swish",
    "less_than", "mish", "mse_loss", "pool2d", "recompute_barrier", "relu",
    "relu6", "scale", "sigmoid", "sign", "silu", "softplus", "sqrt",
    "square", "sum", "swish", "tanh", "where", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow"))
# ops that work row by row when only these input slots are batched (the
# others hold weights)
_ROW_SLOTS = {"mul": ("X",), "conv2d": ("Input",),
              "lookup_table": ("Ids",), "lookup_table_v2": ("Ids",),
              "multihead_matmul": ("Input", "BiasQK")}


def _rank_of(block, name) -> int:
    v = block.vars.get(name)
    return len(v.shape) if v is not None and v.shape is not None else 0


def _row_wise(op, block, batched) -> bool:
    """Whether ``op`` keeps a batched input's rows apart: in
    ``_ROW_WISE``, or batched only in its ``_ROW_SLOTS``, or one of the
    ops below with its batch dim outside the axes it mixes."""
    t = op.type
    if t in _ROW_WISE or t == "batch_norm":
        # batch norm takes the dp group's statistics (LowerCtx.batch_group)
        return True
    if t in _ROW_SLOTS:
        return not any(n in batched for slot, names in op.inputs.items()
                       if slot not in _ROW_SLOTS[t] for n in names)
    x = (op.input("X") or op.input("Logits") or op.input("Input")
         or [None])[0]
    nd = max(_rank_of(block, x), 1)
    if t in ("softmax", "softmax_with_cross_entropy"):
        return int(op.attr("axis", -1)) % nd != 0
    if t == "layer_norm":
        return int(op.attr("begin_norm_axis", 1)) >= 1
    if t in ("reduce_sum", "reduce_mean"):
        dims = op.attr("dim", [0])
        return not (op.attr("reduce_all", False) or not dims
                    or any(int(d) % nd == 0 for d in dims))
    if t == "slice":
        return all(int(a) % nd != 0 for a in op.attr("axes", []))
    if t == "reshape2":
        out = block.vars.get(op.output("Out")[0])
        shape = list(op.attr("shape", []))
        return not op.input("Shape") and bool(shape) and shape[0] in (0, -1) \
            and out is not None and bool(out.shape) and out.shape[0] == -1
    if t == "matmul":
        xs, ys = op.input("X")[0], op.input("Y")[0]
        rx, ry = _rank_of(block, xs), _rank_of(block, ys)
        ok = True
        if xs in batched:
            ok = rx >= 3 or (rx == 2 and not op.attr("transpose_X", False))
        if ys in batched:
            ok = ok and ry >= 3 and (xs not in batched or rx == ry)
        return ok
    return False


def loss_of(ops, loss_name: Optional[str]) -> Optional[str]:
    """``loss_name``, or the var the backward's seed op names
    (``<loss>@GRAD``)."""
    if loss_name:
        return loss_name
    for op in ops:
        if _is_backward(op) and op.type == "fill_constant":
            out = op.output_arg_names[0]
            if out.endswith(GRAD_SUFFIX):
                return out[: -len(GRAD_SUFFIX)]
    return None


def data_parallel_rule(program: Program, fwd_end: int,
                       loss_name: Optional[str]):
    """(the loss name, whether its gradients are averaged, the batched
    vars) of a program under the data-parallel plan, which reproduces the
    single-device run: the loss's producer among the first ``fwd_end``
    ops must be ``mean`` / ``reduce_mean`` (averaged over dp) or
    ``reduce_sum`` / ``sum`` (summed), and every other op that reads a
    batched var (one declared with a leading -1, from the data feeds on)
    must keep its rows apart (:func:`_row_wise`): either raises
    ``NotImplementedError`` naming the op, rather than differ from the
    single-device run."""
    block = program.global_block()
    ops = block.ops
    loss = loss_of(ops, loss_name)
    batched = {n for n, v in block.vars.items()
               if getattr(v, "is_data", False) and v.shape
               and v.shape[0] == -1}
    producer = crosser = None
    for op in ops[:fwd_end]:
        if op.type.endswith("_grad") or _is_backward(op):
            continue
        makes_loss = loss is not None and loss in op.output_arg_names
        if makes_loss:
            producer = op
        if not any(n in batched for n in op.input_arg_names):
            continue
        if crosser is None and not (
                makes_loss and op.type in _MEAN_LOSS + _SUM_LOSS) \
                and not _row_wise(op, block, batched):
            crosser = op
        for n in op.output_arg_names:
            v = block.vars.get(n)
            if v is not None and v.shape and v.shape[0] == -1:
                batched.add(n)
    mean = True
    if loss is not None:
        kind = producer.type if producer is not None else None
        if kind not in _MEAN_LOSS + _SUM_LOSS:
            raise NotImplementedError(
                f"with_data_parallel: the loss {loss!r} is made by op "
                f"{kind!r}; the data-parallel plan reduces the gradients of "
                "a loss made by mean or reduce_mean (averaged over dp) or "
                "reduce_sum or sum (summed) and refuses any other")
        mean = kind in _MEAN_LOSS
    if crosser is not None:
        raise NotImplementedError(
            f"with_data_parallel: op {crosser.type!r} (output "
            f"{crosser.output_arg_names}) reduces over the batch dim or "
            "mixes its rows, which the data-parallel plan splits over "
            "ranks; only the loss "
            "may reduce over the batch (mean, reduce_mean, reduce_sum or "
            "sum), and every other op reading a batched var must work row "
            "by row")
    return loss, mean, batched


def shard_feeds(feed, group, batched: Optional[set] = None
                ) -> Dict[str, Any]:
    """This rank's rows of each fed batch (``batched``: the vars whose
    leading dim is the batch, which the group must divide; None: any feed
    whose leading dim the group divides, as the reference's
    ``feed_dims``); the other feeds whole."""
    out = {}
    for name, value in (feed or {}).items():
        n = _leading(value)
        if batched is None:
            split = n is not None and n > 0 and n % group.size == 0
        else:
            split = name in batched and n is not None
            if split and n % group.size:
                raise ValueError(
                    f"batch {n} not divisible by {group.size} dp ranks "
                    f"(the fed batch {name!r})")
        rows = n // group.size if split else 0
        out[name] = (value[group.index * rows:(group.index + 1) * rows]
                     if split else value)
    return out


def reduce_over_dp(env, group, names, mean: bool) -> None:
    """The data-parallel plan's reduction, in ``env``, of ``names`` (the
    gradients and the loss) over ``group``: averaged for a mean loss,
    summed for a sum loss (:func:`data_parallel_rule`), one exchange a
    dtype."""
    from ..parallel.mesh import all_reduce_coalesced

    names = [n for n in names if n in env]
    with torch.no_grad():
        for n, t in zip(names, all_reduce_coalesced(
                group, [env[n] for n in names], mean=mean)):
            env[n] = t


def _feed_env(exe, block, env, feed) -> None:
    for name, value in (feed or {}).items():
        env[name] = _normalize_feed(block.vars.get(name), value, exe.device)


class DataParallelBlock:
    """The data-parallel plan (the reference's ``gspmd`` mode) for one
    program version and fetch list: the fwd/bwd region's plan and the
    optimizer tail's, the gradient all-reduce between them
    (:func:`data_parallel_rule` decides mean or sum; one exchange a
    dtype), ``batch_norm`` over the dp group (``LowerCtx.batch_group``),
    the loss reduced by the same rule and a fetched batch var gathered.
    On a world of one it is the plain run."""

    def __init__(self, program: Program, fetch_names, mesh_plan: MeshPlan,
                 loss_name: Optional[str] = None):
        block = program.global_block()
        ops = block.ops
        self.program = program
        self.mesh_plan = mesh_plan
        tail = backward_end(ops)
        self.loss_name, self.mean, self.batched = data_parallel_rule(
            program, tail, loss_name)
        self.grads = grad_vars(block, ops[:tail])
        tail_reads = {n for op in ops[tail:] for n in op.input_arg_names}
        keep = tail_reads | set(fetch_names) | set(self.grads.values())
        if self.loss_name:
            keep.add(self.loss_name)
        self.region = _Plan(program, (), hi=tail, keep=keep)
        self.tail = _Plan(program, fetch_names, lo=tail)

    def run(self, exe: "Executor", feed, fetch_names, scope: "Scope",
            return_numpy: bool):
        mesh = run_mesh(self.mesh_plan.axes, exe)
        group = None
        if mesh is not None:
            group = mesh.group(self.mesh_plan.data_axis)
            feed = shard_feeds(feed, group, self.batched)
        block = self.program.global_block()
        env = exe._read_scope(self.region, scope)
        _feed_env(exe, block, env, feed)
        self.region.run_ops(exe._ctx(self.region, batch_group=group), env,
                            exe.device)
        if group is not None:
            reduce_over_dp(env, group, [*self.grads.values(),
                                        self.loss_name], self.mean)
        self.tail.run_ops(exe._ctx(self.tail, batch_group=group), env,
                          exe.device)
        exe._write_scope(self.tail, env, scope)
        if group is not None:
            for n in fetch_names:
                if n in self.batched and n in env:
                    env[n] = group.all_gather(env[n].contiguous())
        return exe._fetch(env, fetch_names, return_numpy)


class PerRankBlock:
    """The per-rank plan (the reference's ``shard_map`` mode): every rank
    runs the whole program on its rows of each feed the data axis divides,
    its collective ops on the groups their ``ring_id``s name; a fetch is
    every rank's value (at least 1-d) concatenated along dim 0 over the
    data axis. Each rank keeps the persistables it wrote, as each of the
    reference's devices keeps its own buffer of a replicated output: the
    program's collectives keep the parameters equal, while a rank's own
    accumulators (``dgc_momentum``'s residuals) stay its own."""

    def __init__(self, program: Program, fetch_names, mesh_plan: MeshPlan):
        self.program = program
        self.mesh_plan = mesh_plan
        self.plan = _Plan(program, fetch_names)

    def run(self, exe: "Executor", feed, fetch_names, scope: "Scope",
            return_numpy: bool):
        from ..parallel.mesh import jit_shard_map, probe_produced_state

        def per_rank(rings, env):
            self.plan.run_ops(exe._ctx(self.plan, rings), env, exe.device)

        mesh = run_mesh(self.mesh_plan.axes, exe)
        block = self.program.global_block()
        group = None
        run = lambda env: per_rank(None, env)       # noqa: E731
        if mesh is not None:
            run = jit_shard_map(per_rank, mesh, self.mesh_plan.ring_axes)
            group = mesh.group(self.mesh_plan.data_axis)
            feed = shard_feeds(feed, group)
        env = exe._read_scope(self.plan, scope)
        _feed_env(exe, block, env, feed)
        run(env)
        for n in probe_produced_state(self.program, self.plan.written,
                                      scope):
            if n in env:
                scope.set_var(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise ValueError(f"fetch vars {missing} were not computed by "
                             "the program")
        for n in fetch_names:
            t = env[n].reshape(-1) if env[n].dim() == 0 else env[n]
            env[n] = group.all_gather(t.contiguous()) if group is not None \
                else t
        return exe._fetch(env, fetch_names, return_numpy)


def _report_name(program: Program, fetch_names) -> str:
    """The reference's report name (``executor.py:779-782``)."""
    named = getattr(program, "_annotations", {}).get("report_name")
    return str(named or f"{fetch_names[0] if fetch_names else 'main'}"
               f"#{len(program.global_block().ops)}ops")


class Executor:
    """Runs programs on ``place``'s device: ``CUDAPlace(0)`` when none is
    given, which raises without a card; ``CPUPlace()`` runs on the CPU."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        self._plans: Dict[Tuple, Tuple[Program, _Plan]] = {}
        self._gens: Dict[int, Tuple[Program, torch.Generator]] = {}
        # id(program) -> the build signatures of its plans, oldest first
        self._history: Dict[int, List[Dict[str, Any]]] = {}
        # (world, mesh axes) -> the mesh the rank plans run on
        self._meshes: Dict[Tuple, Any] = {}

    def _mesh(self, axes):
        """The mesh of ``axes`` over the ``torch.distributed`` world on
        this executor's device, built once: building one creates its
        groups, a collective call that every rank makes in the same order,
        each running the same programs in the same order."""
        import torch.distributed as dist

        from ..parallel.mesh import build_mesh

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"a mesh of {list(axes)} needs the torch.distributed world "
                "(parallel.env.init_distributed_env) on every rank")
        key = (id(dist.group.WORLD), tuple(axes))
        if key not in self._meshes:
            self._meshes[key] = build_mesh(list(axes), device=self.device)
        return self._meshes[key]

    def _plan(self, program: Program, fetch_names, compiled=None
              ) -> Tuple[Any, bool]:
        """(the plan for ``program``'s current version and the fetch list,
        whether it was built now). A new plan of a program that already
        has one is a rebuild: the recompile explainer names its cause
        against the program's sibling plans (``fetch_list`` or
        ``program_mutation``; the reference's feed causes never arise
        here, the plan being the same for any feed shape)."""
        mesh_plan = plan_for_program(program, compiled)
        key = (id(program), program._version_token(), tuple(fetch_names),
               mesh_plan.signature() if mesh_plan else None)
        hit = self._plans.get(key)
        if hit is not None:
            return hit[1], False
        mode = mesh_plan.mode if mesh_plan is not None else "single"
        if "pipeline" in program._annotations:
            from ..parallel.pipeline_program import PipelineBlock

            plan = PipelineBlock(program, fetch_names, mesh_plan=mesh_plan)
        elif "grad_merge" in program._annotations:
            from ..parallel.grad_merge import GradMergeBlock

            plan = GradMergeBlock(program, fetch_names, mesh_plan=mesh_plan,
                                  loss_name=getattr(compiled, "_loss_name",
                                                    None))
        elif mode == "gspmd":
            plan = DataParallelBlock(program, fetch_names, mesh_plan,
                                     getattr(compiled, "_loss_name", None))
        elif mode == "shard_map":
            plan = PerRankBlock(program, fetch_names, mesh_plan)
        else:
            plan = _Plan(program, fetch_names)
        hit = self._plans[key] = (program, plan)
        self._explain_rebuild(program, fetch_names)
        return hit[1], True

    def _explain_rebuild(self, program: Program, fetch_names) -> None:
        """As the reference's ``Executor._explain_rebuild``
        (``executor.py:905-917``): diff this build's signature against
        the program's earlier ones, count
        ``paddle_recompiles_total{cause=}`` and log the cause
        (rate-limited)."""
        from ..observability import program_report as _prep

        sig = _prep.make_sig((), fetch_names,
                             version=program._version_token())
        if len(self._history) > 256:
            self._history.clear()
        hist = self._history.setdefault(id(program), [])
        if hist:
            cause, detail = _prep.explain_recompile(sig, hist)
            _prep.note_recompile(_report_name(program, fetch_names), cause,
                                 detail)
        hist.append(sig)
        del hist[:-32]  # bound sibling history per program

    def _generator(self, program: Program) -> torch.Generator:
        hit = self._gens.get(id(program))
        if hit is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(program.random_seed or 0))
            hit = self._gens[id(program)] = (program, gen)
        return hit[1]

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        feed_var_name: str = "feed",
        fetch_var_name: str = "fetch",
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
    ):
        """Run block 0 of ``program`` once; returns the fetched values
        (numpy arrays unless ``return_numpy`` is False). The signature and
        its order are the reference's. ``feed_var_name`` and
        ``fetch_var_name`` name the reference's feed/fetch holder vars and
        ``use_program_cache`` its executable cache: they are accepted and
        change nothing here, where feeds bind by name, fetches are read
        from the environment and the op plan is always cached per
        (program, fetch list)."""
        del feed_var_name, fetch_var_name, use_program_cache
        from .compiler import CompiledProgram

        compiled = None
        if isinstance(program, CompiledProgram):
            compiled, program = program, program.program
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError(f"Executor.run takes a Program or a "
                            f"CompiledProgram, got {type(program).__name__}")
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        plan, built = self._plan(program, fetch_names, compiled)
        if built:
            # the plan's first run is its program report's call (the
            # reference reports a compile there)
            from ..observability import program_report as _prep

            with _prep.counted(self.device) as counts:
                fetches = plan.run(self, feed, fetch_names, scope,
                                   return_numpy)
            _prep.capture(_report_name(program, fetch_names), counts,
                          inputs=dict(feed or {}), outputs=fetches,
                          extra={"mode": "executor",
                                 "fetch": list(fetch_names)})
            return fetches
        return plan.run(self, feed, fetch_names, scope, return_numpy)

    def _read_scope(self, plan: _Plan, scope: Scope) -> Dict[str, Any]:
        env: Dict[str, Any] = {}
        for n in plan.read:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"persistable var {n!r} is not initialized in scope — "
                    "run the startup program first")
            env[n] = v
        return env

    def _ctx(self, plan: _Plan, mesh_axes=None, batch_group=None
             ) -> LowerCtx:
        return LowerCtx(self.device, self._generator(plan.program),
                        plan.replay, mesh_axes=mesh_axes,
                        batch_group=batch_group)

    @staticmethod
    def _write_scope(plan: _Plan, env, scope: Scope) -> None:
        for n in plan.written:
            if n in env:
                scope.set_var(n, env[n])

    @staticmethod
    def _fetch(env, fetch_names, return_numpy: bool):
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise ValueError(f"fetch vars {missing} were not computed by "
                             "the program")
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def run_startup(self, startup_program: Program,
                    scope: Optional[Scope] = None):
        """Convenience alias: startup programs run through the same path."""
        return self.run(program=startup_program, feed={}, fetch_list=[],
                        scope=scope)
