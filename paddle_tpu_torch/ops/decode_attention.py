"""Decode-path attention over a preallocated KV cache, in plain PyTorch.

The port of ``paddle_tpu/ops/decode_attention.py`` for the slab layout:
``cache_update`` (``:32``), ``decode_attention`` (``:63``) and
``prefill_attention`` (``:234``). The paged and speculative-window helpers
belong to the next serving slice.

``cache_update`` writes in place: JAX returned a new slab and relied on
buffer donation to make that an in-place HBM write; here the caller's
tensor is the cache. The engine's default decode tick replaces
``cache_update`` + ``decode_attention`` with the one-launch kernel in
``ops/cuda_kernels.py``; these functions are the unfused path and the
reference it is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["cache_update", "decode_attention", "prefill_attention"]


def cache_update(cache, new, positions, active=None):
    """Write one row per sequence into ``cache`` IN PLACE and return it.

    cache:     [B, S, nh, hd]  (one layer's K or V slab, slot-major)
    new:       [B, nh, hd]     (cast to the cache dtype)
    positions: [B] integer     (row to write per slot)
    active:    [B] optional write mask — inactive lanes keep the row that
               was already there (a live slot riding a partial batch as a
               masked lane must not have its row 0 clobbered)
    """
    idx = torch.arange(cache.shape[0], device=cache.device)
    pos = positions.to(device=cache.device, dtype=torch.long)
    val = new.to(cache.dtype)
    if active is not None:
        live = (active != 0).to(cache.device)[:, None, None]
        val = torch.where(live, val, cache[idx, pos])
    cache[idx, pos] = val
    return cache


def decode_attention(q, k_cache, v_cache, lengths,
                     sm_scale: Optional[float] = None):
    """One-token attention over the cache.

    q: [B, nh, hd]; k_cache/v_cache: [B, S, nh, hd]; lengths: [B] valid
    prefix per slot INCLUDING the current token. Scores and softmax run in
    float32; rows at or past ``lengths`` are masked; an empty lane
    (length 0) yields zeros, not NaNs. Returns [B, nh, hd] in q.dtype.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    S = k_cache.shape[1]
    scores = torch.einsum("bnh,bsnh->bns", q.float(),
                          k_cache.float()) * sm_scale
    lengths = lengths.to(device=q.device)
    valid = (torch.arange(S, device=q.device)[None, None, :]
             < lengths[:, None, None])
    scores = scores.masked_fill(~valid, -math.inf)
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    probs = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bns,bsnh->bnh", probs, v_cache.float())
    return out.to(q.dtype)


def prefill_attention(q, k, v, sm_scale: Optional[float] = None):
    """Causal self-attention for prefill, [B, T, nh, hd] all around, in the
    same float32 contraction order as :func:`decode_attention`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    T = q.shape[1]
    scores = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * sm_scale
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -math.inf)
    m = scores.amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    probs = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bnqk,bknh->bqnh", probs, v.float())
    return out.to(q.dtype)
