"""Fluid-level pipeline parallelism — the port of
``paddle_tpu/parallel/pipeline_program.py``: a user Program's forward runs
as GPipe stages over the ranks of a ``pp`` mesh axis.

``PipelineOptimizer.minimize`` calls :func:`annotate_pipeline`, which cuts
the forward op list into S contiguous stages (at the user's cut vars, or
evenly), and ``Executor.run`` hands the program to :class:`PipelineBlock`.
Where the reference runs one ``shard_map`` program whose ``lax.scan``
permutes a packed carry between stages, here each rank is a
``torch.distributed`` process running its stage:

- stage s runs the forward ops ``stage_ranges[s]`` for each of the M
  microbatches (this rank's dp rows of the global batch, split in M),
  with autograd on; every var that crosses a cut travels by point-to-point
  send and receive inside autograd functions (:class:`_SendMany`,
  :class:`_RecvMany`, after ``parallelize._StageSend`` / ``_StageRecv``),
  packed into one vector a dtype, each var keeping its dtype; an integer
  var carries no gradient back;
- the program's own grad ops are skipped: the microbatches' backwards run
  last first on every stage, so each send meets its receive in order;
- the loss is the last stage's sum over M divided by M, summed over pp;
  the gradients are summed over pp; both are then averaged over dp
  (one all-reduce over the mesh);
- persistables the forward writes (batch norm's statistics) thread
  through the microbatches in order on their stage and reach every rank
  as the owner's update (a sum of deltas over pp, averaged over dp);
- then the optimizer tail runs unchanged on every rank, reading the
  gradients under the names its ops read.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework.executor import (_analyze_persistables, _normalize_feed,
                                  _Plan, resolve_axes, shard_feeds)
from ..framework.registry import bind_outputs, gather_inputs, get_op_spec
from . import remat as remat_mod
from .grad_merge import resolve_tail_start
from .mesh import dtype_groups, pack_by_dtype, unpack_by_dtype
from .parallelize import _StageLink

__all__ = ["annotate_pipeline", "PipelineBlock"]


def annotate_pipeline(program, loss, n_fwd: int, bwd_end: int,
                      num_stages: int, num_microbatches: int,
                      cut_list=None, trainable_params: Sequence[str] = (),
                      remat_policy: str = "none",
                      grad_names: Optional[Dict[str, str]] = None):
    """Record the stage split on ``program`` (the reference's rules: a cut
    var must be made by a forward op; cuts at or past the forward's end
    are dropped; no cut list splits the forward evenly), and anchor the
    backward and the optimizer tail on their ops (``__bwd_op__``,
    ``__opt_tail__``). ``grad_names``: param -> the gradient var the tail
    reads (``<param>@GRAD`` unless an accumulation renamed it)."""
    block = program.global_block()
    if cut_list:
        producer = {}
        for idx, op in enumerate(block.ops[:n_fwd]):
            for name in op.output_arg_names:
                producer[name] = idx
        bounds = []
        for cut in cut_list:
            vars_ = cut if isinstance(cut, (list, tuple)) else [cut]
            idxs = []
            for v in vars_:
                name = v.name if hasattr(v, "name") else v
                if name not in producer:
                    raise ValueError(
                        f"pipeline cut variable {name!r} must be produced "
                        "by a forward op (feeds and parameters cannot be "
                        "stage boundaries)")
                idxs.append(producer[name])
            bounds.append(max(idxs) + 1)
        bounds = sorted(set(bounds))
        if bounds and bounds[-1] >= n_fwd:
            bounds = [b for b in bounds if b < n_fwd]
        stage_bounds = [0] + bounds + [n_fwd]
    else:
        S = int(num_stages)
        per = max(1, n_fwd // S)
        stage_bounds = [min(i * per, n_fwd) for i in range(S)] + [n_fwd]
    stage_ranges = [(stage_bounds[i], stage_bounds[i + 1])
                    for i in range(len(stage_bounds) - 1)]
    for op in block.ops[n_fwd:bwd_end]:
        op._set_attr("__bwd_op__", 1)
    for op in block.ops[bwd_end:]:
        op._set_attr("__opt_tail__", 1)
    program._annotations["pipeline"] = {
        "stage_ranges": stage_ranges,
        "n_fwd": n_fwd,
        "bwd_end": bwd_end,
        "loss": loss.name,
        "microbatches": int(num_microbatches),
        "trainable": list(trainable_params),
        "remat": remat_mod.resolve(remat_policy).name,
        "grad_names": dict(grad_names or {}),
    }
    program._bump_version()


# ---------------------------------------------------------------------------
# The stage link: the cut's vars, one vector a dtype, both ways
# ---------------------------------------------------------------------------

_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_MAX_DIMS = 8
_HEADER_TAG = 1 << 20


class _SendMany(torch.autograd.Function):
    """Sends the cut's vectors to the next stage and returns a 0-d zero,
    this microbatch's backward root there; its backward receives the
    floating vectors' gradients from the next stage."""

    @staticmethod
    def forward(ctx, anchor, link, tag, *vecs):
        ctx.link, ctx.tag = link, tag
        ctx.specs = [(v.numel(), v.dtype, v.is_floating_point())
                     for v in vecs]
        for i, v in enumerate(vecs):
            link.send(v, link.stage + 1, tag + i)
        return anchor.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _g):
        link = ctx.link
        grads = [link.group.recv((n,), dt, _g.device, link.stage + 1,
                                 ctx.tag + i) if fl else None
                 for i, (n, dt, fl) in enumerate(ctx.specs)]
        return (None, None, None, *grads)


class _RecvMany(torch.autograd.Function):
    """The previous stage's vectors (and a 0-d zero, which puts this
    function in the microbatch's backward whether or not each vector
    reaches the loss); the backward sends the floating vectors'
    gradients back."""

    @staticmethod
    def forward(ctx, anchor, link, tag, specs):
        ctx.link, ctx.tag, ctx.specs = link, tag, specs
        vecs = [link.group.recv((n,), dt, anchor.device, link.stage - 1,
                                tag + i) for i, (n, dt) in enumerate(specs)]
        ctx.mark_non_differentiable(
            *[v for v in vecs if not v.is_floating_point()])
        return (anchor.new_zeros((), dtype=torch.float32), *vecs)

    @staticmethod
    def backward(ctx, _g, *grads):
        link = ctx.link
        for i, ((n, dt), g) in enumerate(zip(ctx.specs, grads)):
            if dt.is_floating_point:
                if g is None:
                    g = torch.zeros(n, dtype=dt, device=_g.device)
                link.send(g.to(dt), link.stage - 1, ctx.tag + i)
        return None, None, None, None


def _send_header(link, layout) -> None:
    """The cut's vars' dtypes and shapes, once a run: [dtype, ndim, dims]
    a var, in the layout's order."""
    head = torch.zeros((len(layout), 2 + _MAX_DIMS), dtype=torch.int64)
    for i, (_name, t) in enumerate(layout):
        head[i, 0] = _DTYPES.index(t.dtype)
        head[i, 1] = t.dim()
        head[i, 2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    link.send(head.reshape(-1), link.stage + 1, _HEADER_TAG)


def _recv_header(link, names) -> List[Tuple[torch.dtype, Tuple[int, ...]]]:
    head = link.group.recv((len(names) * (2 + _MAX_DIMS),), torch.int64,
                           torch.device("cpu"), link.stage - 1, _HEADER_TAG)
    head = head.reshape(len(names), 2 + _MAX_DIMS).tolist()
    return [(_DTYPES[r[0]], tuple(r[2:2 + r[1]])) for r in head]


# ---------------------------------------------------------------------------
# The executor's plan
# ---------------------------------------------------------------------------

class PipelineBlock:
    """The executor's plan for a pipeline-annotated program (one a program
    version, fetch list and mesh plan): the stage split, the cut's vars,
    the optimizer tail's plan; :meth:`run` is one step on this rank."""

    def __init__(self, program, fetch_names, mesh_plan=None):
        ann = program._annotations["pipeline"]
        block = program.global_block()
        ops = block.ops
        self.program = program
        self.stage_ranges: List[Tuple[int, int]] = [
            tuple(r) for r in ann["stage_ranges"]]
        self.S, self.M = len(self.stage_ranges), int(ann["microbatches"])
        self.loss_name = ann["loss"]
        self.n_fwd = ann["n_fwd"]
        n_fwd_now = next(
            (i for i, op in enumerate(ops)
             if op.attr("__bwd_op__", 0) or op.attr("__opt_tail__", 0)),
            self.n_fwd)
        if n_fwd_now != self.n_fwd:
            raise NotImplementedError(
                "ops were inserted into the forward region after "
                "PipelineOptimizer.minimize(); re-run minimize() after "
                "program surgery so stage boundaries are recomputed")
        tail = resolve_tail_start(ops, ann["bwd_end"])
        _, written = _analyze_persistables(program)
        self.persist = {n for n, v in block.vars.items() if v.persistable}
        names = ann.get("grad_names") or {}
        self.trainable = [n for n in ann["trainable"] if n in self.persist]
        self.grad_names = {p: names.get(p, p + "@GRAD")
                           for p in self.trainable}
        seen = set()
        self.fwd_written: List[str] = []
        for op in ops[:self.n_fwd]:
            for n in op.output_arg_names:
                if n in written and n not in seen:
                    seen.add(n)
                    self.fwd_written.append(n)

        # the vars each cut carries: made before it, read after it in the
        # forward, neither persistable nor fed
        producer: Dict[str, int] = {}
        for idx, op in enumerate(ops[:self.n_fwd]):
            for n in op.output_arg_names:
                producer[n] = idx
        self.iface: List[List[str]] = []
        for b in range(self.S - 1):
            bound = self.stage_ranges[b][1]
            cut = set()
            for op in ops[bound:self.n_fwd]:
                for n in op.input_arg_names:
                    p = producer.get(n)
                    if p is not None and p < bound and n not in self.persist \
                            and not getattr(block.vars.get(n), "is_data",
                                            False):
                        cut.add(n)
            self.iface.append(sorted(cut))

        # the mesh: (dp?, pp), as the reference composes with one data axis
        dp_axes: Tuple[Tuple[str, int], ...] = ()
        self.data_axis = None
        self.ring_axes: Dict[int, Any] = {}
        if mesh_plan is not None and mesh_plan.axes:
            dp_axes = tuple((n, s) for n, s in mesh_plan.axes if n != "pp")
            if len(dp_axes) > 1:
                raise NotImplementedError(
                    f"pipeline composes with a single data-parallel axis; "
                    f"mesh plan has extra axes {dp_axes}")
            self.data_axis = mesh_plan.data_axis
            self.ring_axes = dict(mesh_plan.ring_axes)
        if self.data_axis is None and dp_axes:
            self.data_axis = dp_axes[0][0]
        if dp_axes:
            # with_data_parallel's ("dp", world): the rest of the world
            # after the stages
            dp_axes = ((dp_axes[0][0], -1),)
        self.axes = dp_axes + (("pp", self.S),)
        has_collectives = any(op.type.startswith("c_") or
                              op.type in ("allreduce", "broadcast")
                              for op in ops)
        if has_collectives and not self.ring_axes:
            raise NotImplementedError(
                "pipeline program contains collective ops but no mesh plan "
                "maps their ring_ids to mesh axes; run it through "
                "CompiledProgram.with_data_parallel / a mesh annotation")
        self.remat = remat_mod.resolve(ann.get("remat", "none"))
        self.specs = [get_op_spec(op.type) for op in ops]
        self.tail = _Plan(program, fetch_names, lo=tail)

    # -- one step -----------------------------------------------------------

    def _batch(self, block, feeds, dp: int):
        batch = None
        for name, f in feeds.items():
            var = block.vars.get(name)
            if getattr(var, "is_data", False) and f.dim():
                batch = f.shape[0] if batch is None else batch
        if batch is None:
            raise ValueError("pipeline program has no batched data feeds")
        if batch % (self.M * dp) != 0:
            raise ValueError(
                f"batch {batch} not divisible by num_microbatches {self.M} "
                f"x dp {dp}")
        batched = {n for n, f in feeds.items()
                   if getattr(block.vars.get(n), "is_data", False)
                   and f.dim() and f.shape[0] == batch}
        return batched, batch // dp // self.M

    def run(self, exe, feed, fetch_names, scope, return_numpy):
        from ..parallel.mesh import all_reduce_coalesced, bind_rings

        for n in fetch_names:
            if n != self.loss_name and n not in self.persist and \
                    n not in self.tail_outputs():
                raise NotImplementedError(
                    f"pipeline fetch {n!r}: only the loss, persistables, "
                    "and optimizer-phase outputs are fetchable")
        mesh = exe._mesh(resolve_axes(self.axes))
        stage = mesh.axis_index("pp")
        dp = mesh.axis_size(self.data_axis) if self.data_axis else 1
        rings = bind_rings(mesh, self.ring_axes)
        block = self.program.global_block()
        dev = exe.device
        base = exe._read_scope(self.tail, scope)
        feeds = {n: _normalize_feed(block.vars.get(n), v, dev)
                 for n, v in (feed or {}).items()}
        batched, mb = self._batch(block, feeds, dp)
        local = shard_feeds(feeds, mesh.group(self.data_axis), batched) \
            if dp > 1 else feeds

        live = {n: base[n].detach().requires_grad_()
                for n in self.trainable if n in base}
        ctx = exe._ctx(self.tail, rings)
        link = _StageLink(mesh.group("pp"), stage, double_buffer=False)
        lo, hi = self.stage_ranges[stage]
        S, M = self.S, self.M
        state = {n: base[n] for n in self.fwd_written if n in base}
        roots, loss_sum = [], torch.zeros((), dtype=torch.float32,
                                          device=dev)
        metas = None
        for m in range(M):
            env = dict(base)
            env.update(live)
            env.update(state)
            for n, f in local.items():
                env[n] = f[m * mb:(m + 1) * mb] if n in batched else f
            root = []
            anchor = torch.empty(0, device=dev, requires_grad=True)
            if stage > 0:
                names = self.iface[stage - 1]
                if metas is None:
                    metas = _recv_header(link, names)
                specs = [(sum(int(np.prod(metas[i][1])) for i in idx), dt)
                         for dt, idx in dtype_groups(
                             [dt for dt, _ in metas]).items()]
                out = _RecvMany.apply(anchor, link, m * 64, specs)
                root.append(out[0])
                env.update(zip(names, unpack_by_dtype(out[1:], metas)))
            outs = self._stage(ctx, env, lo, hi)
            state.update((n, outs[n]) for n in self.fwd_written
                         if n in outs)
            if stage < S - 1:
                layout = [(n, outs[n]) for n in self.iface[stage]]
                if m == 0:
                    _send_header(link, layout)
                vecs = pack_by_dtype([t for _, t in layout])
                root.append(_SendMany.apply(anchor, link, m * 64, *vecs))
            else:
                loss = outs[self.loss_name].float().reshape(())
                loss_sum = loss_sum + loss.detach()
                root.append(loss / M)
            roots.append(root)
            del env, outs
        for root in reversed(roots):
            root = [r for r in root if r.requires_grad]
            if root:
                torch.autograd.backward(root)
        del roots

        # one all-reduce over the mesh: the loss and the gradients summed
        # over pp and averaged over dp; forward-written state as deltas
        everyone = mesh.group(*mesh.axis_names)
        with torch.no_grad():
            grads = [live[n].grad if live[n].grad is not None
                     else torch.zeros_like(live[n]) for n in live]
            deltas = [(state[n].float() - base[n].float())
                      for n in self.fwd_written if n in state]
            out = all_reduce_coalesced(everyone,
                                       [loss_sum / M, *grads, *deltas],
                                       mean=False)
            env = dict(base)
            env[self.loss_name] = (out[0] / dp).reshape(1)
            for n, g in zip(live, out[1:1 + len(grads)]):
                env[self.grad_names[n]] = (g / dp).to(base[n].dtype)
            for n, d in zip([n for n in self.fwd_written if n in state],
                            out[1 + len(grads):]):
                env[n] = (base[n].float() + d / dp).to(base[n].dtype)
            env.update({n: f for n, f in feeds.items() if n not in batched})
            self.tail.run_ops(ctx, env, dev)
        exe._write_scope(self.tail, env, scope)
        for n in fetch_names:
            if env[n].dim() == 0:
                env[n] = env[n].reshape(1)
        return exe._fetch(env, fetch_names, return_numpy)

    def tail_outputs(self) -> set:
        return {n for op in self.tail.ops for n in op.output_arg_names}

    def _stage(self, ctx, env, lo: int, hi: int) -> Dict[str, Any]:
        """The outputs of ops ``[lo, hi)`` run over ``env`` with autograd
        on (under the remat policy, whose recompute repeats each random
        op's draw and leaves the stream where the forward left it)."""
        ops = self.program.global_block().ops
        made = list(dict.fromkeys(n for op in ops[lo:hi]
                                  for n in op.output_arg_names))

        def body():
            local = dict(env)
            with torch.enable_grad():
                for i in range(lo, hi):
                    op = ops[i]
                    bind_outputs(local, op, self.specs[i].lower(
                        ctx, op, gather_inputs(local, op)))
            return {n: local[n] for n in made if n in local}

        if self.remat.is_none:
            return body()
        gen = ctx.generator
        first = {"state": gen.get_state() if gen is not None else None,
                 "keys": None}

        def replayed(_anchor):
            if first["keys"] is None:
                out = body()
                first["keys"] = [n for n, v in out.items()
                                 if isinstance(v, torch.Tensor)]
            else:
                after = gen.get_state() if gen is not None else None
                if gen is not None:
                    gen.set_state(first["state"])
                try:
                    out = body()
                finally:
                    if gen is not None:
                        gen.set_state(after)
            return tuple(out[n] for n in first["keys"])

        anchor = torch.zeros((), requires_grad=True, device=ctx.device)
        vals = self.remat.wrap(replayed)(anchor)
        return dict(zip(first["keys"], vals))
