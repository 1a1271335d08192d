"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package holds
the same modules, slice by slice, written in PyTorch for one NVIDIA H100.
Every Pallas kernel on a ported path is a hand-written Hopper kernel here
(``ops/csrc``), each with a plain PyTorch version beside it
(``ops/cuda_kernels.py``).

This package imports torch, numpy and the standard library only — never
jax and never ``paddle_tpu``.

Slices ported so far: serving (slab KV layout) — ``models.gpt``,
``ops.decode_attention``, ``ops.cuda_kernels`` and ``serving``; training
on one device — ``models.gpt`` (``loss_fn``), ``ops.flash_attention``,
``ops.fused_ln``, ``ops.chunked_ce``, ``ops.cuda_kernels`` (the flat
AdamW sweep) and ``parallel``; paged serving — ``serving.paged_kv``;
ERNIE pretraining — ``models.ernie``; the fluid static-graph path —
``framework`` (Program IR, backward, Executor), ``layers`` (with the LR
schedules), the op lowerings ``ops.math``/``nn``/``tensor``/
``optimizer_ops``/``amp_ops``/``misc_extra2`` (the fused optimizers
through the sgd, momentum and adam sweeps of ``ops.cuda_kernels``;
``multihead_matmul`` through the flash bias kernels), ``optimizer``,
``clip``, ``regularizer``, ``contrib.mixed_precision`` (AMP),
``models.resnet`` and ``models.transformer_encoder``; training
over ranks — ``parallel`` (dp x pp x tp, the plans of ``sharding``,
elastic and sharded checkpoints) and ERNIE's (dp, tp) mesh step.

The fluid names (``Program``, ``program_guard``, ``layers``,
``optimizer``, ``Executor``, ...) load at first use, so importing the
package for serving stays light.
"""
import importlib

from .device import resolve_device

__all__ = ["resolve_device", "Program", "program_guard", "layers",
           "optimizer", "clip", "regularizer", "contrib", "Executor",
           "Scope", "CPUPlace", "CUDAPlace",
           "set_flags", "get_flags", "append_backward", "scope_from_numpy",
           "ParamAttr", "global_scope", "scope_guard", "unique_name",
           "default_main_program", "default_startup_program", "Parameter",
           "Variable", "CompiledProgram", "BuildStrategy",
           "ExecutionStrategy"]

_FRAMEWORK_NAMES = {"Program", "program_guard", "Executor", "Scope",
                    "CPUPlace", "CUDAPlace", "set_flags", "get_flags",
                    "append_backward", "scope_from_numpy", "ParamAttr",
                    "global_scope", "scope_guard", "unique_name",
                    "default_main_program", "default_startup_program",
                    "Parameter", "Variable", "CompiledProgram",
                    "BuildStrategy", "ExecutionStrategy"}


def __getattr__(name):
    if name in ("layers", "optimizer", "framework", "clip", "regularizer",
                "contrib"):
        return importlib.import_module(f"{__name__}.{name}")
    if name in _FRAMEWORK_NAMES:
        return getattr(importlib.import_module(f"{__name__}.framework"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
