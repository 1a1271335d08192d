"""Decode-path attention over a preallocated KV cache, in plain PyTorch.

The port of ``paddle_tpu/ops/decode_attention.py`` for the slab and the
paged layouts: ``cache_update`` (``:32``), ``decode_attention`` (``:63``),
``paged_gather`` (``:97``), ``paged_cache_update`` (``:120``),
``paged_page_write`` (``:134``), ``paged_prefill_attention`` (``:144``),
``prefill_attention`` (``:234``) and the speculative-verify window's
``window_cache_update`` (``:176``) and ``window_attention`` (``:205``).
The reference computes the window without a Pallas kernel, so the port's
verify forward runs these plain functions on the card too.

The cache and pool writers update in place: JAX returned a new slab or
pool and relied on buffer donation to make that an in-place HBM write;
here the caller's tensor is the cache. The engine's default decode tick
replaces the update + gather + ``decode_attention`` with one-launch
kernels in ``ops/cuda_kernels.py``; these functions are the unfused path
and the reference it is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["cache_update", "decode_attention", "prefill_attention",
           "paged_gather", "paged_cache_update", "paged_page_write",
           "paged_prefill_attention", "window_cache_update",
           "window_attention"]


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


def paged_gather(pool, tables):
    """Per-slot contiguous views of a page pool.

    pool: [P, page, nh, hd] (one layer's K or V pool); tables: [B, M]
    integer (physical page per logical page; unmapped entries point at
    scratch page 0, whose rows the callers' lengths always mask).
    Returns [B, M * page, nh, hd], a copy."""
    B, M = tables.shape
    g = pool[tables.long()]                       # [B, M, page, nh, hd]
    return g.reshape(B, M * pool.shape[1], pool.shape[2], pool.shape[3])


def paged_cache_update(pool, new, phys_pages, rows):
    """Write one row per sequence into the pool IN PLACE and return it.

    pool: [P, page, nh, hd]; new: [B, nh, hd] (cast to the pool dtype);
    phys_pages, rows: [B] integer (the page and the row within it; dead
    lanes point at scratch page 0, the only page where indices collide,
    and it is never read back)."""
    pool[phys_pages.long(), rows.long()] = new.to(pool.dtype)
    return pool


def paged_page_write(pool, pages_data, phys_pages):
    """Write whole pages into the pool IN PLACE (the prefill path).

    pool: [P, page, nh, hd]; pages_data: [n, page, nh, hd]; phys_pages:
    [n] integer (unmapped pages of a bucket point at scratch page 0)."""
    pool[phys_pages.long()] = pages_data.to(pool.dtype)
    return pool


def paged_prefill_attention(q, k_all, v_all, prefix_len: int,
                            sm_scale: Optional[float] = None):
    """Suffix prefill over a gathered paged view (prefix-cache capable).

    q: [1, T, nh, hd], the suffix queries at global positions
    ``prefix_len + i``; k_all/v_all: [1, S, nh, hd], the slot's whole view
    (cached prefix rows and this call's suffix rows already written).
    Query i attends key j iff ``j <= prefix_len + i``; the softmax guards
    and float32 contraction order are :func:`decode_attention`'s, so a
    decode replay of the same positions agrees to float rounding."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    T, S = q.shape[1], k_all.shape[1]
    scores = torch.einsum("bqnh,bknh->bnqk", q.float(),
                          k_all.float()) * sm_scale
    mask = (torch.arange(S, device=q.device)[None, :]
            <= prefix_len + torch.arange(T, device=q.device)[:, None])
    scores = scores.masked_fill(~mask, -math.inf)
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    probs = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bnqk,bknh->bqnh", probs, v_all.float())
    return out.to(q.dtype)


def window_cache_update(cache, new, starts, active=None):
    """Write a W-token window per sequence into the slab cache IN PLACE
    and return it.

    cache: [B, S, nh, hd]; new: [B, W, nh, hd] (the verify window's K or
    V, cast to the cache dtype); starts: [B] integer (first row written
    per slot; the window must fit, rows starts..starts+W-1 < S); active:
    [B] optional write mask, as in :func:`cache_update` — an inactive
    lane keeps every row."""
    B, W = new.shape[:2]
    rows = (starts.to(device=cache.device, dtype=torch.long)[:, None]
            + torch.arange(W, device=cache.device))          # [B, W]
    idx = torch.arange(B, device=cache.device)[:, None]
    val = new.to(cache.dtype)
    if active is not None:
        live = (active != 0).to(cache.device)[:, None, None, None]
        val = torch.where(live, val, cache[idx, rows])
    cache[idx, rows] = val
    return cache


def window_attention(q, k_cache, v_cache, starts,
                     sm_scale: Optional[float] = None):
    """W-query attention over the cache (the speculative-verify window).

    q: [B, W, nh, hd], query w at global position ``starts[b] + w``;
    k_cache/v_cache: [B, S, nh, hd] with the window rows written; starts:
    [B] integer. Query w attends keys ``j <= starts + w``. Float32 scores,
    the ``-inf`` mask, a row max of 0 where no key is visible and the sum
    floored at 1e-30, as :func:`decode_attention`; returns [B, W, nh, hd]
    in q's dtype. W = 1 is :func:`decode_attention` with lengths =
    starts + 1."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    W, S = q.shape[1], k_cache.shape[1]
    scores = torch.einsum("bwnh,bsnh->bnws", q.float(),
                          k_cache.float()) * sm_scale
    st = starts.to(device=q.device, dtype=torch.long)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= st[:, None, None]
            + torch.arange(W, device=q.device)[None, :, None])[:, None]
    scores = scores.masked_fill(~mask, -math.inf)
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    probs = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bnws,bsnh->bwnh", probs, v_cache.float())
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
