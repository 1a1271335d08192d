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
  by ``program.random_seed`` at its first run.

The JAX jit, its dispatch fast path, host ops, datasets and checkpoints
are still to be ported (ROADMAP A5). ``scope_from_numpy`` carries state
across: the JAX scope's persistables, as numpy arrays by name, become a
scope of this one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.graph import get_gradient_edge

from .core import CUDAPlace, Place, dtype_to_torch
from .program import Program, Variable, default_main_program
from .registry import (GRAD_SUFFIX, LowerCtx, bind_outputs, gather_inputs,
                       get_op_spec)

__all__ = ["Scope", "global_scope", "scope_guard", "Executor",
           "scope_from_numpy"]


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


def _out_key(outputs: Dict[str, List[str]]):
    return tuple(sorted((k, tuple(v)) for k, v in outputs.items()))


class _Plan:
    """What a run of (program version, fetch list) needs, computed once:
    each op's spec; which grad op runs which forward op's graph, and which
    input positions of that op it asks gradients for; the persistables
    read and written; the vars to drop after each op."""

    def __init__(self, program: Program, fetch_names: Sequence[str]):
        block = program.global_block()
        ops = block.ops
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
                    f"{op.type} (op {i}) has no forward op before it in "
                    "the block")
            self.grad_of[i] = j
            want = self.record.setdefault(j, {})
            for gslot, names in op.outputs.items():
                if gslot.endswith(GRAD_SUFFIX):
                    pos = [k for k, n in enumerate(names) if n != "@EMPTY@"]
                    if pos:
                        want[gslot[: -len(GRAD_SUFFIX)]] = pos
        self.read, self.written = _analyze_persistables(program)
        keep = {n for n, v in block.vars.items() if v.persistable}
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

    def _plan(self, program: Program, fetch_names) -> Tuple[_Plan, bool]:
        """(the plan for ``program``'s current version and the fetch list,
        whether it was built now). A new plan of a program that already
        has one is a rebuild: the recompile explainer names its cause
        against the program's sibling plans (``fetch_list`` or
        ``program_mutation``; the reference's feed causes never arise
        here, the plan being the same for any feed shape)."""
        key = (id(program), program._version_token(), tuple(fetch_names))
        hit = self._plans.get(key)
        if hit is not None:
            return hit[1], False
        hit = self._plans[key] = (program, _Plan(program, fetch_names))
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
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError(f"Executor.run takes a Program, got "
                            f"{type(program).__name__} (CompiledProgram is "
                            "not ported yet: ROADMAP A5)")
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        plan, built = self._plan(program, fetch_names)
        if built:
            # the plan's first run is its program report's call (the
            # reference reports a compile there)
            from ..observability import program_report as _prep

            with _prep.counted(self.device) as counts:
                fetches = self._run_plan(program, plan, feed, fetch_names,
                                         scope, return_numpy)
            _prep.capture(_report_name(program, fetch_names), counts,
                          inputs=dict(feed or {}), outputs=fetches,
                          extra={"mode": "executor",
                                 "fetch": list(fetch_names)})
            return fetches
        return self._run_plan(program, plan, feed, fetch_names, scope,
                              return_numpy)

    def _run_plan(self, program: Program, plan: _Plan, feed, fetch_names,
                  scope: Scope, return_numpy: bool):
        block = program.global_block()
        env: Dict[str, Any] = {}
        for n in plan.read:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"persistable var {n!r} is not initialized in scope — "
                    "run the startup program first")
            env[n] = v
        for name, value in (feed or {}).items():
            env[name] = _normalize_feed(block.vars.get(name), value,
                                        self.device)
        ctx = LowerCtx(self.device, self._generator(program))
        anchor = (torch.zeros((), device=self.device, requires_grad=True)
                  if plan.record else None)
        records: Dict[int, _Record] = {}
        with torch.no_grad():
            for i, op in enumerate(block.ops):
                j = plan.grad_of.get(i)
                if j is not None:
                    _run_grad(env, op, records.pop(j, None), self.device)
                elif i in plan.record:
                    records[i] = _run_recorded(ctx, env, op, plan.specs[i],
                                               plan.record[i], anchor)
                else:
                    bind_outputs(env, op, plan.specs[i].lower(
                        ctx, op, gather_inputs(env, op)))
                for n in plan.free_after[i]:
                    env.pop(n, None)
        for n in plan.written:
            if n in env:
                scope.set_var(n, env[n])
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
