"""Gradient merge (batch-merge) — the port of
``paddle_tpu/parallel/grad_merge.py``, the reference's
multi_batch_merge pass: the forward and backward region runs once for
each of k microbatch slices of the fed batch, the gradients the
optimizer tail reads accumulate, and the tail applies once on their
mean. With a mean loss that is the step of the whole batch fed at once;
the activations are a microbatch's.

``annotate_grad_merge`` marks the program (``GradientMergeOptimizer``
calls it) and ``Executor.run`` hands such a program to
:class:`GradMergeBlock`, with its mesh plan when it runs over ranks.
Where the reference scans the region under ``lax.scan``, this runs it k
times in a loop: each microbatch's recorded graphs are freed by its own
grad ops before the next one starts.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..framework.core import dtype_to_torch
from ..framework.executor import (_analyze_persistables, _normalize_feed,
                                  _Plan, data_parallel_rule, reduce_over_dp,
                                  run_mesh, shard_feeds)
from . import remat as remat_mod

__all__ = ["annotate_grad_merge", "resolve_tail_start", "GradMergeBlock"]


def annotate_grad_merge(program, loss, bwd_end, k_steps,
                        grad_names, avg=True, remat_policy="none",
                        acc_dtype="float32"):
    """Record the merge on ``program``: the ops from ``bwd_end`` on are
    the optimizer tail (each carries ``__opt_tail__``, so ops inserted
    into the region later do not move the boundary)."""
    block = program.global_block()
    for op in block.ops[bwd_end:]:
        op._set_attr("__opt_tail__", 1)
    program._annotations["grad_merge"] = {
        "bwd_end": bwd_end,
        "k": int(k_steps),
        "loss": loss.name,
        "grads": list(grad_names),
        "avg": bool(avg),
        "remat": remat_mod.resolve(remat_policy).name,
        "acc_dtype": str(acc_dtype),
    }
    program._bump_version()


def resolve_tail_start(ops, fallback):
    """Index of the first optimizer-tail op, else ``fallback``."""
    for idx, op in enumerate(ops):
        if op.attr("__opt_tail__", 0):
            return idx
    return fallback


class GradMergeBlock:
    """The executor's plan for a grad-merge-annotated program (one a
    program version and fetch list): the fwd/bwd region's plan, which
    keeps the gradients, the persistables it writes (batch norm's
    statistics, threaded through the microbatches in order), the loss
    and the forward fetches; and the tail's plan.

    The annotation's remat policy is recorded and changes nothing, as in
    the reference: the region carries its own grad ops and is never
    differentiated again.

    With a ``mesh_plan`` (the reference's data-parallel branch) each rank
    takes its rows of the global batch and splits them into the k
    microbatches: under the data-parallel plan the merged gradients and
    the loss are then reduced over dp by the plan's rule
    (``executor.data_parallel_rule``) before the tail, and batch norm
    takes the dp group's statistics; under the per-rank plan (a program
    with its own collectives, one data axis only) nothing is reduced for
    it, a fetch is every rank's value concatenated and each rank keeps
    the persistables it wrote."""

    def __init__(self, program, fetch_names, mesh_plan=None,
                 loss_name=None):
        self.mesh_plan = mesh_plan
        self.mode = mesh_plan.mode if mesh_plan is not None else "single"
        if self.mode == "shard_map" and (
                mesh_plan.data_axis is None or len(mesh_plan.axes) > 1):
            raise NotImplementedError(
                "gradient merge composes with a single data-parallel axis; "
                f"mesh plan has axes {mesh_plan.axes} "
                f"data_axis={mesh_plan.data_axis}")
        ann = program._annotations["grad_merge"]
        block = program.global_block()
        ops = block.ops
        self.program = program
        self.k = int(ann["k"])
        tail = resolve_tail_start(ops, ann["bwd_end"])
        self.loss_name = ann["loss"]
        self.grad_names = [g for g in ann["grads"] if g]
        self.avg = bool(ann["avg"])
        self.acc_dtype = dtype_to_torch(ann.get("acc_dtype", "float32"))
        _, written = _analyze_persistables(program)
        region_outs = {n for op in ops[:tail] for n in op.output_arg_names}
        self.fwd_written = [n for n in written if n in region_outs]
        self.fwd_fetch = [n for n in fetch_names
                          if n != self.loss_name
                          and n not in self.grad_names
                          and n in region_outs]
        keep = (set(self.grad_names) | set(self.fwd_written)
                | set(self.fwd_fetch) | {self.loss_name})
        self.region = _Plan(program, (), hi=tail, keep=keep)
        self.tail = _Plan(program, fetch_names, lo=tail)
        if self.mode == "gspmd":
            _, self.mean, _ = data_parallel_rule(
                program, tail, loss_name or self.loss_name)

    def _split(self, block, feeds: Dict[str, torch.Tensor]):
        """(the batched feed names, the microbatch rows), with the
        reference's checks: every data feed shares the batch dimension,
        which k divides."""
        batched, batch = set(), None
        for name, f in feeds.items():
            var = block.vars.get(name)
            if getattr(var, "is_data", False) and f.dim():
                if batch is None:
                    batch = f.shape[0]
                elif f.shape[0] != batch:
                    raise ValueError(
                        f"gradient merge: data feed {name!r} has leading "
                        f"dim {f.shape[0]} != batch {batch}; all data feeds "
                        "must share the batch dimension")
                batched.add(name)
        if batch is None:
            raise ValueError("gradient merge needs batched data feeds")
        if batch % self.k:
            raise ValueError(
                f"per-rank batch {batch} not divisible by k_steps {self.k}")
        return batched, batch // self.k

    def run(self, exe, feed, fetch_names, scope, return_numpy):
        from .mesh import bind_rings

        block = self.program.global_block()
        mesh = group = rings = None
        if self.mode != "single":
            mesh = run_mesh(self.mesh_plan.axes, exe)
        if mesh is not None:
            group = mesh.group(self.mesh_plan.data_axis)
            rings = bind_rings(mesh, self.mesh_plan.ring_axes)
        params = exe._read_scope(self.region, scope)
        feeds = {n: _normalize_feed(block.vars.get(n), v, exe.device)
                 for n, v in (feed or {}).items()}
        if group is not None:
            feeds = shard_feeds(feeds, group, {
                n for n, f in feeds.items() if f.dim()
                and getattr(block.vars.get(n), "is_data", False)})
        batched, mb = self._split(block, feeds)
        dp_group = group if self.mode == "gspmd" else None
        ctx = exe._ctx(self.region, rings, dp_group)
        acc: Dict[str, torch.Tensor] = {}
        grad_dtype: Dict[str, torch.dtype] = {}
        loss_sum: Any = None
        state: Dict[str, Any] = {}
        fetched: Dict[str, Any] = {}
        for i in range(self.k):
            env = dict(params)
            env.update(state)       # the persistables the last one wrote
            for n, f in feeds.items():
                env[n] = f[i * mb:(i + 1) * mb] if n in batched else f
            self.region.run_ops(ctx, env, exe.device)
            for g in self.grad_names:
                grad_dtype[g] = env[g].dtype
                if g in acc:
                    acc[g].add_(env[g].to(self.acc_dtype))
                else:
                    acc[g] = env[g].to(self.acc_dtype, copy=True)
            loss = env[self.loss_name].float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            state = {n: env[n] for n in self.fwd_written if n in env}
            fetched = {n: env[n] for n in self.fwd_fetch if n in env}
            del env
        env = dict(params)
        env.update({n: f for n, f in feeds.items() if n not in batched})
        env.update(state)
        env.update(fetched)
        scale = 1.0 / self.k if self.avg else 1.0
        for g in self.grad_names:
            # the tail reads each gradient in its unmerged dtype
            env[g] = (acc.pop(g) * scale).to(grad_dtype[g])
        env[self.loss_name] = loss_sum / self.k
        if dp_group is not None:
            reduce_over_dp(env, dp_group, self.grad_names + [self.loss_name],
                           self.mean)
        self.tail.run_ops(exe._ctx(self.tail, rings, dp_group), env,
                          exe.device)
        exe._write_scope(self.tail, env, scope)
        if group is not None and self.mode == "shard_map":
            for n in fetch_names:
                if n in env:
                    t = env[n].reshape(-1) if env[n].dim() == 0 else env[n]
                    env[n] = group.all_gather(t.contiguous())
        return exe._fetch(env, fetch_names, return_numpy)
