"""The port's Hopper kernels, each beside its plain PyTorch version — the
port of ``paddle_tpu/ops/pallas_kernels.py``: the serving slice's decode
kernels, the training slice's flat AdamW sweep and the fluid optimizer
sweeps (sgd, momentum, adam) here; the
flash-attention kernels in ``ops/flash_attention.py``, the fused-layernorm
forward and backward in ``ops/fused_ln.py`` and the vocab-chunked CE
forward in ``ops/chunked_ce.py``, which share this module's routing
helpers, ``KERNELS`` and ``LAUNCHES``.

Each public function routes by the device its tensors lie on:

- CPU tensors take the plain version (``*_plain``), the same arithmetic
  in PyTorch ops — that is what the CPU tests hold against JAX;
- CUDA tensors launch the hand-written kernel (``ops/csrc``, built by
  ``ops/_build.py``) or raise. There is no fallback: a kernel that cannot
  take its inputs raises instead of quietly running the plain version.

``LAUNCHES[name]`` counts kernel launches, one per call that launched
(a decode call enqueues its split pass and its merge: one launch).
JAX's ``_count_launch`` (``pallas_kernels.py:853``) ticks once per TRACE —
once per compiled executable, however often it runs; eager PyTorch has no
trace, so the port counts every launch. A decode tick of the engine
launches ``fused_ln`` 2·L times, ``decode_slab`` (slab layout) or
``decode_paged`` (paged layout) L times and ``logits_head`` once. A GPT
train step under ``dots`` remat launches ``flash_fwd`` 2·L times,
``flash_bwd_dq`` and ``flash_bwd_dkv`` L times each and
``opt_adamw_flat`` once; with ``fused_ln=True`` also ``fused_ln`` 4·L + 1
times (2·L in the forward, 2·L recomputed, the final LN) and
``fused_ln_bwd`` 2·L + 1 times; with ``ce_vocab_chunk`` > 0 also
``ce_fwd`` once a row chunk (B·T / ``ce_chunk``). A flash call with a bias
counts under ``flash_fwd_bias``, ``flash_bwd_dq_bias`` and
``flash_bwd_dkv_bias``: an ERNIE pretrain step without remat launches
each L times. A fluid step with a fused optimizer launches one of
``opt_sgd``, ``opt_momentum``, ``opt_adam`` or ``opt_adamw`` a parameter
group (ResNet-50's f32 parameters are one group).
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
import threading
from typing import Dict, Tuple

import torch

from . import kernel_costs as _kc
from .decode_attention import (cache_update, decode_attention,
                               paged_cache_update, paged_gather)

__all__ = ["fused_ln", "fused_ln_plain", "fused_decode_attention",
           "fused_decode_attention_plain", "fused_paged_decode_attention",
           "fused_paged_decode_attention_plain", "fused_logits_head",
           "fused_logits_head_plain", "megakernel_adamw_flat",
           "megakernel_adamw_flat_plain", "megakernel_sgd",
           "megakernel_sgd_plain", "megakernel_momentum",
           "megakernel_momentum_plain", "megakernel_adam",
           "megakernel_adam_plain", "LAUNCHES", "KERNELS",
           "kernel_entries", "reset_launches"]

# the flash kernels' device symbols: the instances up to hd 128 and the
# split route's (``fwide``); a bias form is the same symbol, its launches
# told apart by launch order (utils/device_trace.py)
_FLASH_FWD = ("flash_fwd_kernel", "fwide+fwd_kernel")
_FLASH_DQ = ("flash_bwd_dq_kernel", "flash_bwd_dq_kernel_f32",
             "fwide+dq_kernel")
_FLASH_DKV = ("flash_bwd_dkv_kernel", "flash_bwd_dkv_kernel_f32",
              "fwide+dkv_kernel")

# name -> where its source lives, which TPU kernel it replaces, and the
# device kernels of one launch in a profiler trace: ``symbols``, one of
# which each launch runs once, and ``parts``, the kernels a launch runs
# after it (a split pass's merge, the LN backward's column sums). Each
# pattern is identifiers joined by "+", all of which a demangled kernel
# name must hold as whole identifiers (:func:`kernel_entries`).
KERNELS: Dict[str, Dict[str, object]] = {
    "fused_ln": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/fused_ln.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:894",
        "symbols": ("fused_ln_fwd_kernel", "fused_ln_fwd_kernel_rowblock",
                    "fused_ln_fwd_kernel_twopass"),
    },
    "decode_slab": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/decode_slab.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1338",
        "symbols": ("decode_split_kernel+SlabRows",
                    "decode_wide_kernel+SlabRows"),
        "parts": ("decode_merge_kernel+SlabRows",),
    },
    "decode_paged": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/decode_paged.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1431",
        "symbols": ("decode_split_kernel+PagedRows",
                    "decode_wide_kernel+PagedRows"),
        "parts": ("decode_merge_kernel+PagedRows",),
    },
    "logits_head": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/logits_head.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1544",
        "symbols": ("logits_head_kernel",),
    },
    "flash_fwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:74",
        "symbols": _FLASH_FWD,
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_bwd_dq.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:205",
        "symbols": _FLASH_DQ,
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:261",
        "symbols": _FLASH_DKV,
    },
    "opt_adamw_flat": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/opt_megakernel.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1209",
        "symbols": ("adamw_flat_kernel",),
    },
    "fused_ln_bwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/ln_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:931",
        "symbols": ("ln_bwd_kernel", "ln_bwd_kernel_rowblock",
                    "ln_bwd_kernel_rowloop"),
        "parts": ("ln_bwd_kernel_finalize",),
    },
    "ce_fwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/ce_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:537",
        "symbols": ("ce_fwd_f32_kernel", "ce_fwd_wgmma_kernel"),
        "parts": ("ce_fwd_merge_kernel",),
    },
    # the additive-bias forms of the three flash kernels: the same
    # sources, counted apart
    "flash_fwd_bias": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:74",
        "symbols": _FLASH_FWD,
    },
    "flash_bwd_dq_bias": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_bwd_dq.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:205",
        "symbols": _FLASH_DQ,
    },
    "flash_bwd_dkv_bias": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:261",
        "symbols": _FLASH_DKV,
    },
    # the fluid optimizer kinds of _opt_kernel (one source with
    # opt_adamw_flat); fused_adamw's launches count under opt_adamw
    "opt_sgd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/opt_megakernel.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1178",
        "symbols": ("sgd_kernel",),
    },
    "opt_momentum": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/opt_megakernel.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1183",
        "symbols": ("momentum_kernel",),
    },
    "opt_adam": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/opt_megakernel.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1194",
        "symbols": ("adam_kernel",),
    },
    "opt_adamw": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/opt_megakernel.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1204",
        "symbols": ("adam_kernel",),
    },
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# the armed launch-cost capture (``kernel_costs.arm``), or None: each
# wrapper adds its launch's cost to it after the launch
CAPTURE = None


def _tokens(name: str) -> frozenset:
    return frozenset(_IDENT.findall(name))


_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def kernel_entries(device_name: str) -> Tuple[Tuple[str, ...], bool]:
    """(the ``KERNELS`` entries whose patterns match a device kernel's
    demangled name, whether it matched as a ``part``); ((), False) for a
    kernel of no entry. Entries sharing a symbol (a flash kernel and its
    bias form, ``opt_adam`` and ``opt_adamw``) all come back."""
    toks = _tokens(device_name)
    for key in ("symbols", "parts"):
        hit = tuple(name for name, meta in KERNELS.items()
                    if any(all(t in toks for t in pat.split("+"))
                           for pat in meta.get(key, ())))
        if hit:
            return hit, key == "parts"
    return (), False

# dtype codes of ops/csrc/common.cuh (enum DType)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# dynamic shared memory a block may take without the opt-in attribute,
# and the most it may take with it (H100: 227 KB)
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 227 * 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(*tensors) -> bool:
    """False when every tensor lies on the CPU, True when all lie on one
    CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    raise ValueError("tensors on mixed or unsupported devices: "
                     f"{sorted(str(d) for d in devices)}")


def _dtype_code(t: torch.Tensor, what: str) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} is not taken by the "
                        "kernel (float32 or bfloat16)")
    return code


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES[name] += 1


_SMS: Dict[int, int] = {}     # device index -> multiprocessor count


def _num_sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _lib():
    from . import _build

    return _build.load()


# ---------------------------------------------------------------------------
# fused layernorm (replaces _ln_fwd_kernel; ops/fused_ln.py has every form
# and the backward)
# ---------------------------------------------------------------------------


def fused_ln_plain(x, scale, bias, eps: float = 1e-5):
    """y = (x - mu) * rsqrt(var + eps) * scale + bias over the last axis,
    float32 statistics with the population variance, y in x.dtype: the
    plain form of :func:`ops.fused_ln.fused_ln_fwd_plain`."""
    from .fused_ln import fused_ln_fwd_plain

    d = x.shape[-1]
    y = fused_ln_fwd_plain(x.reshape(-1, d), scale, bias, eps=eps)[0]
    return y.reshape(x.shape)


def fused_ln(x, scale, bias, residual=None, bias_add=None, *,
             eps: float = 1e-5, dropout_rate: float = 0.0,
             return_residual: bool = False):
    """LayerNorm of ``s = x + residual + bias_add`` over the last axis with
    float32 ``scale``/``bias`` [D]: :func:`ops.fused_ln.fused_ln` without
    a dropout key, so ``dropout_rate`` > 0 raises ``ValueError`` as JAX's
    does without one. One kernel launch on the card; differentiable."""
    from .fused_ln import fused_ln as _fused_ln

    return _fused_ln(x, scale, bias, residual, bias_add, eps=eps,
                     dropout_rate=dropout_rate,
                     return_residual=return_residual)


# ---------------------------------------------------------------------------
# one-launch slab decode step (replaces _decode_slab_kernel)
# ---------------------------------------------------------------------------


def fused_decode_attention_plain(q, k_cache, v_cache, new_k, new_v,
                                 positions, active=None, sm_scale=None):
    """The kernel's arithmetic in PyTorch ops: write-guarded row update
    (in place) and one-query attention over rows ``0..positions[b]``."""
    if active is None:
        active = torch.ones(q.shape[0], dtype=torch.int32, device=q.device)
    cache_update(k_cache, new_k, positions, active)
    cache_update(v_cache, new_v, positions, active)
    out = decode_attention(q, k_cache, v_cache, positions + 1, sm_scale)
    return out, k_cache, v_cache


def fused_decode_attention(q, k_cache, v_cache, new_k, new_v, positions,
                           active=None, sm_scale=None):
    """Write-guarded KV row update + masked one-token attention.

    q/new_k/new_v: [B, nh, hd]; k_cache/v_cache: [B, S, nh, hd], updated
    IN PLACE (only row ``positions[b]`` of slot b, and only where
    ``active[b] != 0``); positions/active: [B] int32 (``active`` None =
    every lane writes). Attention covers rows ``0..positions[b]``.
    Positions must lie in [0, S); on the card a lane outside answers zeros
    and writes nothing. The kernel takes any hd (an instance up to 128,
    the split route past it).

    Returns (out [B, nh, hd] in q.dtype, k_cache, v_cache) — the caches
    are the tensors passed in, returned for the JAX signature's sake.
    """
    B, S, nh, hd = k_cache.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if active is None:
        active = torch.ones(B, dtype=torch.int32, device=q.device)
    if not _on_card(q, k_cache, v_cache, new_k, new_v, positions, active):
        return fused_decode_attention_plain(q, k_cache, v_cache, new_k,
                                            new_v, positions, active,
                                            sm_scale)
    fn = "fused_decode_attention"
    q_code, c_code = _check_decode_inputs(fn, q, new_k, new_v, k_cache,
                                          v_cache, (B, S, nh, hd), B)
    _check_ints(fn, "positions", positions, (B,))
    _check_ints(fn, "active", active, (B,))
    out = torch.empty((B, nh, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out, k_cache, v_cache
    chunk, nsplit = _decode_split(S, hd, k_cache.element_size())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib()
    with _WORKSPACE_LOCK:
        ws = _workspace(q.device, stream, B * nh * nsplit * (hd + 2))
        err = lib.ptt_decode_slab(
            q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), q.stride(0),
            k_cache.data_ptr(), v_cache.data_ptr(), positions.data_ptr(),
            active.data_ptr(), out.data_ptr(), ws.data_ptr(), B, S, nh, hd,
            chunk, nsplit, float(sm_scale), q_code, c_code, stream)
    _check_launch(lib, err, "decode_slab")
    if CAPTURE is not None:
        CAPTURE.add("decode_slab", _kc.decode_slab, positions, active, nh,
                    hd, k_cache.element_size())
    return out, k_cache, v_cache


# The decode kernels' split pass (ops/csrc/decode_attention.cuh): 128
# threads a block, each loading 4 rows' 16 bytes of K and of V a tile.
# Instances at head widths 8..128 (powers of two) take the true hd at run
# time: lanes past it load zeros and store nothing. Past 128 the split
# route: column blocks of 128 over any hd, a warp a row.
_DECODE_HDS = (8, 16, 32, 64, 128)
_DECODE_MAX_SPLITS = 64     # chunks a lane at most: the merge's serial loop
_DECODE_STAGING = 32 * 1024   # bytes of a paged chunk's staged rows (int32)
# (device index, stream) -> the float32 partials of the split pass
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}
# held from taking a workspace to the return of the one C call that queues
# the split pass (which writes the partials) and the merge (which reads
# them): that call releases the GIL, and another thread's split queued on
# the same stream between the two would overwrite the partials the merge
# reads (two engines' loop threads on one card share the default stream)
_WORKSPACE_LOCK = threading.Lock()


@functools.lru_cache(maxsize=64)
def _decode_instance(hd: int, cache_esz: int) -> Tuple[int, bool]:
    """(HD, vec): the decode kernels' instance for a head of ``hd``
    elements — the power of two at or above it, 8 at least — and whether
    its rows are whole 16-byte vectors of the cache's ``cache_esz``-byte
    elements (else the instance loads one element at a time). The caches
    keep their true width. Past 128, (128, False): the split route, whose
    blocks each take 128 output columns and load one element a lane."""
    if hd < 1:
        raise ValueError(f"decode attention: head_dim {hd} < 1")
    if hd > _DECODE_HDS[-1]:
        return _DECODE_HDS[-1], False
    return (next(h for h in _DECODE_HDS if h >= hd),
            hd * cache_esz % 16 == 0)


@functools.lru_cache(maxsize=64)
def _decode_split(rows: int, hd: int, cache_esz: int,
                  page: int = 1) -> Tuple[int, int]:
    """(chunk, nsplit): the rows of a lane's chunk in the decode kernels'
    split pass and the number of chunks that cover ``rows``. A chunk is
    whole tiles — 4 x 128 threads' 16-byte loads over the instance's
    width, so 64 rows at bf16 and hd 64 — at most 64 chunks a lane,
    rounded up to whole pages. It comes from the shapes alone: the host
    never reads the positions."""
    tile = 4 * 128 * (16 // cache_esz) // _decode_instance(hd, cache_esz)[0]
    chunk = tile * -(-rows // (tile * _DECODE_MAX_SPLITS))
    chunk = -(-chunk // page) * page
    return chunk, -(-rows // chunk)


def _workspace(dev, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` float32 elements of scratch for (device, stream),
    kept across calls: calls on one stream run in order, so one buffer
    serves them all, and a call allocates only when it needs more. Taken
    and used under ``_WORKSPACE_LOCK``."""
    key = (dev.index, stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < n:
        buf = _WORKSPACE[key] = torch.empty(n, dtype=torch.float32,
                                            device=dev)
    return buf


def _check_decode_inputs(fn, q, new_k, new_v, k_cache, v_cache, cache_shape,
                         B):
    """The decode kernels' shared checks: dtypes, the caches' shape,
    contiguity and 16-byte alignment, q/new_k/new_v as [B, nh, hd] with
    contiguous heads and one batch stride, and hd >= 1. Returns the
    dtype codes of q and the cache. A message is built only when a check
    fails: the engine calls this L times a tick."""
    nh, hd = cache_shape[-2:]
    _decode_instance(hd, k_cache.element_size())   # raises below 1
    q_code = _dtype_code(q, f"{fn} q")
    c_code = _dtype_code(k_cache, f"{fn} cache")
    if not (k_cache.shape == cache_shape and v_cache.shape == cache_shape
            and v_cache.dtype == k_cache.dtype):
        raise ValueError(f"{fn}: the V cache must match the K cache "
                         f"{tuple(cache_shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{fn}: caches must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{fn}: caches must be 16-byte aligned")
    bs = q.stride(0)
    for name, t in (("q", q), ("new_k", new_k), ("new_v", new_v)):
        if not (t.shape == (B, nh, hd) and t.dtype == q.dtype):
            raise ValueError(f"{fn}: {name} must be [{B}, {nh}, {hd}] "
                             f"{q.dtype}, got {tuple(t.shape)} {t.dtype}")
        if not (t.stride(2) == 1 and t.stride(1) == hd
                and t.stride(0) == bs):
            raise ValueError(f"{fn}: {name} needs contiguous heads and the "
                             "same batch stride as q")
    return q_code, c_code


def _check_ints(fn, name, t, shape):
    if t.dtype != torch.int32:
        raise TypeError(f"{fn}: {name} must be int32")
    if not (t.shape == shape and t.is_contiguous()):
        raise ValueError(f"{fn}: {name} must be {list(shape)} contiguous")


# ---------------------------------------------------------------------------
# one-launch paged decode step (replaces _decode_paged_kernel)
# ---------------------------------------------------------------------------


def fused_paged_decode_attention_plain(q, k_pool, v_pool, new_k, new_v,
                                      tables, positions, sm_scale=None):
    """The unfused paged tick in PyTorch ops, as the JAX reference runs it
    (tests/test_pallas_fused.py:565-573): the row scatter into both pools
    (in place), the page-table gathers, and one-query attention over rows
    ``0..positions[b]`` of the gathered views."""
    page = k_pool.shape[1]
    pos = positions.long()
    phys = tables.long().gather(1, (pos // page)[:, None])[:, 0]
    rows = pos % page
    paged_cache_update(k_pool, new_k, phys, rows)
    paged_cache_update(v_pool, new_v, phys, rows)
    out = decode_attention(q, paged_gather(k_pool, tables),
                           paged_gather(v_pool, tables), positions + 1,
                           sm_scale)
    return out, k_pool, v_pool


def fused_paged_decode_attention(q, k_pool, v_pool, new_k, new_v, tables,
                                 positions, sm_scale=None):
    """Paged KV row write + masked one-token attention through the page
    table, in one call.

    q/new_k/new_v: [B, nh, hd]; k_pool/v_pool: [P, page, nh, hd], updated
    IN PLACE (row ``positions[b] % page`` of page
    ``tables[b, positions[b] // page]``; a dead lane's all-zero table row
    writes scratch page 0); tables: [B, M] int32; positions: [B] int32.
    Attention covers logical rows ``0..positions[b]``. On the card a lane
    whose position lies outside [0, M * page) or whose table reaches a
    page outside [0, P) answers zeros and writes nothing. The kernel takes
    any hd (an instance up to 128, the split route past it) and pages of
    up to 8,192 rows.

    Returns (out [B, nh, hd] in q.dtype, k_pool, v_pool) — the pools are
    the tensors passed in, returned for the JAX signature's sake.
    """
    B, M = tables.shape
    P, page, nh, hd = k_pool.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_card(q, k_pool, v_pool, new_k, new_v, tables, positions):
        return fused_paged_decode_attention_plain(
            q, k_pool, v_pool, new_k, new_v, tables, positions, sm_scale)
    fn = "fused_paged_decode_attention"
    q_code, c_code = _check_decode_inputs(fn, q, new_k, new_v, k_pool,
                                          v_pool, (P, page, nh, hd), B)
    _check_ints(fn, "tables", tables, (B, M))
    _check_ints(fn, "positions", positions, (B,))
    chunk, nsplit = _decode_split(M * page, hd, k_pool.element_size(), page)
    if chunk * 4 > _DECODE_STAGING or P * page >= 2 ** 31:
        raise ValueError(f"{fn}: a chunk of {chunk} rows (page {page}) "
                         f"exceeds the kernel's {_DECODE_STAGING // 4} "
                         f"staged rows, or the pool's {P} x {page} rows "
                         "reach 2^31")
    out = torch.empty((B, nh, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out, k_pool, v_pool
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib()
    with _WORKSPACE_LOCK:
        ws = _workspace(q.device, stream, B * nh * nsplit * (hd + 2))
        err = lib.ptt_decode_paged(
            q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), q.stride(0),
            k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(), ws.data_ptr(), B, M, page,
            P, nh, hd, chunk, nsplit, float(sm_scale), q_code, c_code,
            stream)
    _check_launch(lib, err, "decode_paged")
    if CAPTURE is not None:
        CAPTURE.add("decode_paged", _kc.decode_paged, tables, positions, nh,
                    hd, k_pool.element_size(), page)
    return out, k_pool, v_pool


# ---------------------------------------------------------------------------
# final layernorm + LM head (replaces _logits_head_kernel)
# ---------------------------------------------------------------------------


def fused_logits_head_plain(x, scale, bias, lm_head, *, eps: float = 1e-5):
    """LN(x) rounded to x.dtype, times ``lm_head`` with float32
    accumulation, rounded to x.dtype."""
    y = fused_ln_plain(x, scale, bias, eps)
    return torch.matmul(y.float(), lm_head.float()).to(x.dtype)


# ops/csrc/logits_head.cu: 128 vocab columns a tile, a 4-stage ring of
# [32, 128] weight slabs, rows padded by 16 bytes; batch groups of at most
# 48 rows (3 m-tiles of 16)
_LH_BN, _LH_BK, _LH_STAGES, _LH_MAX_BM = 128, 32, 4, 48
_SM_SMEM = 228 * 1024      # shared memory an SM holds, 1 KB a block reserved


@functools.lru_cache(maxsize=64)
def logits_head_plan(B: int, D: int, V: int, esz: int,
                     sms: int = 132) -> Dict[str, object]:
    """The logits-head kernel's launch plan for x [B, D] and a [D, V]
    weight of ``esz``-byte elements on a card of ``sms`` SMs.

    ``bm`` rows a batch group (16, 32 or 48): ``groups`` = ceil(B / bm)
    groups cover every row once, as even as 16-row m-tiles allow; past
    one group the weight is read once per group. ``smem`` is a block's
    bytes (the group's normed rows, D padded to 32, and the weight ring),
    ``bps`` the blocks an SM holds (at most 4). ``gy`` blocks a group
    share the 128-column vocab tiles (block y takes tiles y, y + gy, ...),
    as few tiles a block as fill one wave of ``sms`` x ``bps`` blocks;
    ``grid`` is (groups, gy). Where not even 16 normed rows fit beside the
    ring in 227 KB (D past about 6,000 at bf16), ``stream_rows``: the rows
    are normalised once (a launch of the fused-LN kernel) and each ring
    stage carries the group's [bm, 32] slab of them beside the weight
    slab, so the block's bytes no longer grow with D."""
    pad = 16 // esz
    ring = _LH_STAGES * _LH_BK * (_LH_BN + pad) * esz
    row = (-(-D // _LH_BK) * _LH_BK + pad) * esz
    cap = min(_LH_MAX_BM, (_SMEM_MAX - ring) // row // 16 * 16)
    stream = cap < 16
    if stream:
        cap = _LH_MAX_BM
    per = -(-B // -(-B // cap))          # rows a group, as even as may be
    bm = 16 * -(-per // 16)
    groups = -(-B // bm)
    if stream:
        smem = ring + _LH_STAGES * bm * (_LH_BK + pad) * esz
    else:
        smem = bm * row + ring
    bps = min(4, _SM_SMEM // (smem + 1024))
    ntiles = -(-V // _LH_BN)
    k = -(-ntiles * groups // (sms * bps))          # tiles a block
    gy = -(-ntiles // k)
    return {"bm": bm, "groups": groups, "gy": gy, "bps": bps,
            "grid": (groups, gy), "smem": smem, "stream_rows": stream}


def fused_logits_head(x, scale, bias, lm_head, *, eps: float = 1e-5):
    """Final layernorm + LM-head projection in one launch.

    x [B, D]; scale/bias [D] float32; lm_head [D, V] in x.dtype ->
    logits [B, V] in x.dtype, for any B >= 1 (batch groups of
    :func:`logits_head_plan`)."""
    if not _on_card(x, scale, bias, lm_head):
        return fused_logits_head_plain(x, scale, bias, lm_head, eps=eps)
    code = _dtype_code(x, "fused_logits_head x")
    _require(x.dim() == 2 and lm_head.dim() == 2
             and lm_head.shape[0] == x.shape[1],
             f"fused_logits_head: x [B, D] and lm_head [D, V] expected, "
             f"got {tuple(x.shape)} and {tuple(lm_head.shape)}")
    B, D = x.shape
    V = lm_head.shape[1]
    if lm_head.dtype != x.dtype:
        raise TypeError(f"fused_logits_head: lm_head is {lm_head.dtype}, "
                        f"the kernel takes it in x's dtype {x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("fused_logits_head: scale and bias must be float32")
    _require(tuple(scale.shape) == (D,) and tuple(bias.shape) == (D,),
             f"fused_logits_head: scale/bias must be [{D}]")
    _require(all(t.is_contiguous() for t in (x, scale, bias, lm_head)),
             "fused_logits_head: inputs must be contiguous")
    out = torch.empty((B, V), dtype=x.dtype, device=x.device)
    if B == 0 or V == 0:
        return out
    plan = logits_head_plan(B, D, V, x.element_size(), _num_sms(x.device))
    _require(plan["gy"] <= 65535,
             f"fused_logits_head: V = {V} needs more than the grid's 65,535 "
             "blocks a batch group")
    if plan["stream_rows"]:
        # the streamed instance takes the rows normalised (one launch of
        # the fused-LN kernel's plain form)
        from .fused_ln import fused_ln_fwd

        x = fused_ln_fwd(x, scale, bias, eps=eps, stats=False)[0]
    lib = _lib()
    err = lib.ptt_logits_head(x.data_ptr(), scale.data_ptr(),
                              bias.data_ptr(), lm_head.data_ptr(),
                              out.data_ptr(), B, D, V, plan["bm"],
                              plan["gy"], float(eps),
                              int(plan["stream_rows"]), code, _stream(x))
    _check_launch(lib, err, "logits_head")
    if CAPTURE is not None:
        CAPTURE.add("logits_head", _kc.logits_head, B, D, V,
                    x.element_size())
    return out


# ---------------------------------------------------------------------------
# flat AdamW sweep (replaces _opt_kernel, kind "adamw_mask")
# ---------------------------------------------------------------------------


def _scalars(dev, *vals) -> torch.Tensor:
    """float32 [len(vals)] on ``dev``; Python floats round to float32 as
    ``jnp.asarray(x, jnp.float32)`` does, tensors are taken as they are
    (no host sync)."""
    return torch.stack([
        x.to(device=dev, dtype=torch.float32).reshape(())
        if isinstance(x, torch.Tensor)
        else torch.full((), float(x), dtype=torch.float32, device=dev)
        for x in vals])


def megakernel_adamw_flat_plain(p, g, m, v, wd_mask, lr, scale, c1, c2, *,
                                b1: float = 0.9, b2: float = 0.95,
                                eps: float = 1e-8,
                                weight_decay: float = 0.1):
    """The sweep in PyTorch ops, expression for expression as
    ``parallelize._adamw_update_fused``'s plain branch; ``p``, ``m``, ``v``
    are updated IN PLACE and returned. ``lr``/``scale``/``c1``/``c2`` are
    float32 scalars (0-d tensors or Python floats)."""
    lr, scale, c1, c2 = _scalars(p.device, lr, scale, c1, c2).unbind()
    gf = g.float() * scale
    mf = b1 * m.float() + (1 - b1) * gf
    vf = b2 * v.float() + (1 - b2) * gf * gf
    u = (mf / c1) / (torch.sqrt(vf / c2) + eps)
    p.copy_(p - lr * (u + weight_decay * wd_mask * p))
    m.copy_(mf)
    v.copy_(vf)
    return p, m, v


def megakernel_adamw_flat(p, g, m, v, wd_mask, lr, scale, c1, c2, *,
                          b1: float = 0.9, b2: float = 0.95,
                          eps: float = 1e-8, weight_decay: float = 0.1):
    """One launch of the flat AdamW sweep over megabuffers: ``p``, ``g``,
    ``wd_mask`` float32 [n]; ``m``, ``v`` [n] float32 or bfloat16; scalars
    as :func:`megakernel_adamw_flat_plain`. ``p``, ``m``, ``v`` are updated
    IN PLACE (JAX donates them) and returned. Bitwise equal to the plain
    version at float32 moments."""
    if not _on_card(p, g, m, v, wd_mask):
        return megakernel_adamw_flat_plain(
            p, g, m, v, wd_mask, lr, scale, c1, c2, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay)
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("wd_mask", wd_mask)):
        if t.dtype != torch.float32:
            raise TypeError(f"megakernel_adamw_flat: {name} must be float32")
    code = _dtype_code(m, "megakernel_adamw_flat m")
    _require(v.dtype == m.dtype, "megakernel_adamw_flat: m and v must share "
             "a dtype")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v),
                    ("wd_mask", wd_mask)):
        _require(t.dim() == 1 and t.numel() == n and t.is_contiguous(),
                 f"megakernel_adamw_flat: {name} must be a contiguous [{n}]")
    scal = _scalars(p.device, lr, scale, c1, c2)
    lib = _lib()
    err = lib.ptt_adamw_flat(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        wd_mask.data_ptr(), scal.data_ptr(), n, float(b1), float(1 - b1),
        float(b2), float(1 - b2), float(eps), float(weight_decay), code,
        _aligned16(p, g, m, v, wd_mask), _stream(p))
    _check_launch(lib, err, "opt_adamw_flat")
    if CAPTURE is not None:
        CAPTURE.add("opt_adamw_flat", _kc.opt_adamw_flat, n,
                    m.element_size())
    return p, m, v


# ---------------------------------------------------------------------------
# the fluid optimizer sweeps (replace _opt_kernel, kinds "sgd", "momentum"
# and "adam"; fluid's fused_sgd, fused_momentum, fused_adam/fused_adamw)
# ---------------------------------------------------------------------------


def _check_flat(fn: str, n: int, dtypes, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{fn}: {name} is {t.dtype}; the kernel takes "
                            f"{' or '.join(str(d) for d in dtypes)}")
        _require(t.dim() == 1 and t.numel() == n and t.is_contiguous(),
                 f"{fn}: {name} must be a contiguous [{n}]")


def _aligned16(*tensors) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def megakernel_sgd_plain(p, g, lr):
    """``p - lr.astype(p.dtype) * g`` in p's dtype (float32 or bfloat16:
    lr, the product and the difference each rounded to it), the
    reference's expression; ``p`` is updated IN PLACE and returned. ``lr``
    is a float32 scalar (0-d tensor or Python float)."""
    lr = _scalars(p.device, lr)[0]
    p.copy_(p - lr.to(p.dtype) * g)
    return p


def megakernel_sgd(p, g, lr):
    """One launch of the flat SGD sweep: ``p``, ``g`` contiguous [n] of one
    dtype (float32 or bfloat16), ``lr`` as :func:`megakernel_sgd_plain`;
    ``p`` is updated IN PLACE (the reference aliases it) and returned.
    Bitwise equal to the plain version."""
    if not _on_card(p, g):
        return megakernel_sgd_plain(p, g, lr)
    n = p.numel()
    _check_flat("megakernel_sgd", n, (torch.float32, torch.bfloat16), p=p,
                g=g)
    _require(g.dtype == p.dtype, "megakernel_sgd: p and g must share a dtype")
    if n == 0:
        return p
    scal = _scalars(p.device, lr)
    lib = _lib()
    err = lib.ptt_opt_sgd(p.data_ptr(), g.data_ptr(), scal.data_ptr(), n,
                          _DTYPE_CODES[p.dtype], _aligned16(p, g), _stream(p))
    _check_launch(lib, err, "opt_sgd")
    if CAPTURE is not None:
        CAPTURE.add("opt_sgd", _kc.opt_sgd, n, p.element_size())
    return p


def megakernel_momentum_plain(p, g, v, lr, *, mu: float = 0.9,
                              nesterov: bool = False):
    """``v' = mu * v + g``; ``p' = p - lr * v'`` or, Nesterov,
    ``p - (g + mu * v') * lr``, float32 — the reference's expression;
    ``p`` and ``v`` are updated IN PLACE and returned."""
    lr = _scalars(p.device, lr)[0]
    gf = g.float()
    v_new = mu * v.float() + gf
    if nesterov:
        p_new = p.float() - (gf + mu * v_new) * lr
    else:
        p_new = p.float() - lr * v_new
    p.copy_(p_new)
    v.copy_(v_new)
    return p, v


def megakernel_momentum(p, g, v, lr, *, mu: float = 0.9,
                        nesterov: bool = False):
    """One launch of the flat momentum sweep: ``p``, ``g``, ``v``
    contiguous float32 [n]; ``lr`` as :func:`megakernel_sgd_plain`. ``p``
    and ``v`` are updated IN PLACE and returned. Bitwise equal to the
    plain version."""
    if not _on_card(p, g, v):
        return megakernel_momentum_plain(p, g, v, lr, mu=mu,
                                         nesterov=nesterov)
    n = p.numel()
    _check_flat("megakernel_momentum", n, (torch.float32,), p=p, g=g, v=v)
    if n == 0:
        return p, v
    scal = _scalars(p.device, lr)
    lib = _lib()
    err = lib.ptt_opt_momentum(p.data_ptr(), g.data_ptr(), v.data_ptr(),
                               scal.data_ptr(), n, float(mu), int(nesterov),
                               _aligned16(p, g, v), _stream(p))
    _check_launch(lib, err, "opt_momentum")
    if CAPTURE is not None:
        CAPTURE.add("opt_momentum", _kc.opt_momentum, n)
    return p, v


def megakernel_adam_plain(p, g, m, v, lr, b1p, b2p, *, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8,
                          coeff: float = 0.0):
    """fluid fused_adam / fused_adamw over a flat group, float32 — the
    reference's expression:
    ``m' = b1 * m + (1 - b1) * g``, ``v' = b2 * v + (1 - b2) * g * g``,
    ``lr_t = lr * sqrt(1 - b2p * b2) / (1 - b1p * b1)``,
    ``p' = p - lr_t * m' / (sqrt(v') + eps)``, and ``- lr * coeff * p``
    when ``coeff`` is not 0 (AdamW). ``p``, ``m``, ``v`` are updated IN
    PLACE and returned; ``lr``, ``b1p``, ``b2p`` are float32 scalars (the
    Beta1Pow/Beta2Pow updates stay with the op)."""
    lr, b1p, b2p = _scalars(p.device, lr, b1p, b2p).unbind()
    gf = g.float()
    pf = p.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    lr_t = lr * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    p_new = pf - lr_t * m_new / (torch.sqrt(v_new) + eps)
    if coeff:
        p_new = p_new - lr * coeff * pf
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    return p, m, v


def megakernel_adam(p, g, m, v, lr, b1p, b2p, *, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8,
                    coeff: float = 0.0):
    """One launch of the flat Adam sweep (AdamW when ``coeff`` is not 0):
    ``p``, ``g``, ``m``, ``v`` contiguous float32 [n]; the scalars as
    :func:`megakernel_adam_plain`. ``p``, ``m``, ``v`` are updated IN
    PLACE and returned. Bitwise equal to the plain version."""
    if not _on_card(p, g, m, v):
        return megakernel_adam_plain(p, g, m, v, lr, b1p, b2p, b1=b1, b2=b2,
                                     eps=eps, coeff=coeff)
    n = p.numel()
    _check_flat("megakernel_adam", n, (torch.float32,), p=p, g=g, m=m, v=v)
    if n == 0:
        return p, m, v
    scal = _scalars(p.device, lr, b1p, b2p)
    lib = _lib()
    err = lib.ptt_opt_adam(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        scal.data_ptr(), n, float(b1), float(1 - b1), float(b2),
        float(1 - b2), float(eps), float(coeff), _aligned16(p, g, m, v),
        _stream(p))
    _check_launch(lib, err, "opt_adamw" if coeff else "opt_adam")
    if CAPTURE is not None:
        CAPTURE.add("opt_adamw" if coeff else "opt_adam", _kc.opt_adam, n,
                    bool(coeff))
    return p, m, v
