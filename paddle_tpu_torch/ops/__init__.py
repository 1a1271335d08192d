"""Operators of the port: plain-PyTorch decode attention
(``decode_attention``) and the hand-written Hopper kernels with their
plain versions (``cuda_kernels``; ``flash_attention`` for the training
slice's attention), sources in ``csrc/``, built by ``_build``."""
