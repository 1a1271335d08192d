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
AdamW sweep) and ``parallel``; paged serving — ``serving.paged_kv``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
