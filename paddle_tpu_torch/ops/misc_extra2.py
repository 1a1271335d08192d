"""``multihead_matmul`` — the port of ``paddle_tpu/ops/misc_extra2.py:25-69``
(the reference's operators/fused/multihead_matmul_op.cc): the fused QKV
projection and scaled-dot attention of the static-graph transformer
encoder. The rest of that module's ops are still to be ported (ROADMAP
A5).

On CUDA tensors the attention runs through the hand-written flash
kernels (``ops/flash_attention.flash_attention``; with a bias, their
bias forms ``flash_fwd_bias``, ``flash_bwd_dq_bias`` and
``flash_bwd_dkv_bias``) whenever the bias is flashable: none, or 4-D with
batch B and 1 or nh heads. A kernel that cannot take its call raises; no
other path hides it. On CPU tensors, and for a bias the kernels cannot
take on either device, it is the reference's naive einsum-softmax path,
the kernels' plain version. The reference also gates its flash path on
``S % 128 == 0 and hd % 64 == 0`` (Mosaic's tiling); the port's flash
takes every S and head dim, so the card takes the kernels for every
flashable bias (ROADMAP C, "Differences by design").
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op


@register_op("multihead_matmul", diff_inputs=("Input", "W", "Bias"))
def multihead_matmul(ctx, op, ins):
    """Input [B, S, H]; W [H, 3, nh, hd] (any shape of H x 3H elements);
    Bias [3, nh, hd]; BiasQK optional, an additive logit mask broadcast
    to [B, nh, S, S]. Out [B, S, H]."""
    x = ins["Input"][0]
    w = ins["W"][0]
    bias = ins["Bias"][0]
    nh = int(op.attr("head_number"))
    alpha = float(op.attr("alpha", 1.0))
    B, S, H = x.shape
    hd = H // nh
    bias_qk = ins["BiasQK"][0] if ins.get("BiasQK") else None
    # the projection in the operands' promoted dtype, as JAX's einsum
    ct = torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                             bias.dtype)
    x, w, bias = x.to(ct), w.to(ct), bias.to(ct)
    # [B, S, 3, nh, hd]: q, k and v are strided views with one layout
    qkv = (torch.matmul(x, w.reshape(H, 3 * H))
           + bias.reshape(3 * H)).reshape(B, S, 3, nh, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]      # [B, S, nh, hd]
    flashable = bias_qk is None or (
        bias_qk.dim() == 4 and bias_qk.shape[0] == B
        and bias_qk.shape[1] in (1, nh))
    if x.device.type == "cuda" and flashable:
        from .flash_attention import flash_attention

        out = flash_attention(q, k, v, causal=False, sm_scale=alpha,
                              bias=bias_qk)
        return {"Out": out.reshape(B, S, H)}
    logits = torch.einsum("bsnd,btnd->bnst", q, k) * alpha
    if bias_qk is not None:
        logits = logits + bias_qk
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bnst,btnd->bsnd", probs.to(v.dtype), v)
    return {"Out": out.reshape(B, S, H)}
