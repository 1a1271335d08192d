"""Operators of the port: plain-PyTorch decode attention
(``decode_attention``) and the hand-written Hopper kernels with their
plain versions (``cuda_kernels``; for training ``flash_attention``,
``fused_ln`` and ``chunked_ce``), sources in ``csrc/``, built by
``_build``; and the fluid op lowerings (``math``, ``nn``, ``tensor``,
``optimizer_ops``), which ``framework/registry.py`` loads at its first
lookup."""
