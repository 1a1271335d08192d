"""``CompiledProgram`` / ``BuildStrategy`` — the port of
``paddle_tpu/framework/compiler.py``.

``with_data_parallel`` annotates the program for execution over ranks:
``Executor.run`` takes the ``CompiledProgram`` and runs the program on
every rank of the ``torch.distributed`` world, each rank on its own rows
of the global batch it is fed (``executor.plan_for_program``). The
reference leaves the gradient all-reduce to GSPMD; here the executor
writes it after the backward region (``executor.DataParallelBlock``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["BuildStrategy", "ExecutionStrategy", "CompiledProgram",
           "rewrite_sync_batch_norm"]


@dataclasses.dataclass
class BuildStrategy:
    """The reference's knobs (``details/build_strategy.h``): every one is
    accepted and recorded; ``sync_batch_norm`` rewrites the program
    (:func:`rewrite_sync_batch_norm`), the rest change nothing here."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    reduce_strategy: int = 0
    gradient_scale_strategy: int = 0
    debug_graphviz_path: str = ""
    enable_sequential_execution: bool = False
    fuse_elewise_add_act_ops: bool = False
    fuse_bn_act_ops: bool = False
    fuse_relu_depthwise_conv: bool = False
    fuse_broadcast_ops: bool = False
    fuse_all_optimizer_ops: bool = False
    fuse_all_reduce_ops: bool = False
    enable_inplace: bool = True
    memory_optimize: bool = True
    sync_batch_norm: bool = False
    num_trainers: int = 1
    trainer_id: int = 0
    nccl_comm_num: int = 1
    use_hierarchical_allreduce: bool = False
    hierarchical_allreduce_inter_nranks: int = 0


@dataclasses.dataclass
class ExecutionStrategy:
    num_threads: int = 0
    num_iteration_per_drop_scope: int = 100
    num_iteration_per_run: int = 1
    use_thread_barrier: bool = False


def rewrite_sync_batch_norm(program) -> None:
    """Every ``batch_norm`` op (and its grad op, whose ``__fwd__`` desc
    names the forward) becomes ``sync_batch_norm``: statistics over the
    ranks of its ``ring_id``, local ones outside any mesh."""
    for op in program.global_block().ops:
        if op.type == "batch_norm":
            op.type = "sync_batch_norm"
        elif op.type == "batch_norm_grad":
            op.type = "sync_batch_norm_grad"
            fwd = op.attrs.get("__fwd__")
            if fwd:
                fwd["type"] = "sync_batch_norm"
    program._bump_version()


class CompiledProgram:
    """A program with its execution annotations; ``with_data_parallel``
    puts ``Executor.run`` into the data-parallel (or, for a program that
    carries collective ops, the per-rank) plan over the world."""

    def __init__(self, program_or_graph,
                 build_strategy: Optional[BuildStrategy] = None):
        self.program = program_or_graph
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = ExecutionStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._places = None
        # ring_id -> mesh axis name (collective ops lower over these)
        self._mesh_axes = {}

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """``share_vars_from`` is accepted and changes nothing: every
        program of an executor reads the scope it is run with."""
        del share_vars_from
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self.build_strategy = build_strategy
        if exec_strategy is not None:
            self.exec_strategy = exec_strategy
        self._places = places
        self._mesh_axes = {0: "dp"}
        if self.build_strategy.sync_batch_norm and \
                hasattr(self.program, "global_block"):
            rewrite_sync_batch_norm(self.program)
        return self

    @property
    def num_devices(self) -> int:
        """``len(places)`` when places were given, else the size of the
        ``torch.distributed`` world (1 without one)."""
        if self._places is not None:
            return len(self._places)
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1
