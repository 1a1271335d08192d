"""The port's Hopper kernels, each beside its plain PyTorch version — the
port of ``paddle_tpu/ops/pallas_kernels.py``: the serving slice's decode
kernels and the training slice's flat AdamW sweep here, the flash-attention
kernels in ``ops/flash_attention.py`` (which shares this module's routing
helpers, ``KERNELS`` and ``LAUNCHES``).

Each public function routes by the device its tensors lie on:

- CPU tensors take the plain version (``*_plain``), the same arithmetic
  in PyTorch ops — that is what the CPU tests hold against JAX;
- CUDA tensors launch the hand-written kernel (``ops/csrc``, built by
  ``ops/_build.py``) or raise. There is no fallback: a kernel that cannot
  take its inputs raises instead of quietly running the plain version.

``LAUNCHES[name]`` counts kernel launches, one per call that launched.
JAX's ``_count_launch`` (``pallas_kernels.py:853``) ticks once per TRACE —
once per compiled executable, however often it runs; eager PyTorch has no
trace, so the port counts every launch. A decode tick of the engine
launches ``fused_ln`` 2·L times, ``decode_slab`` L times and
``logits_head`` once; a GPT train step under ``dots`` remat launches
``flash_fwd`` 2·L times, ``flash_bwd_dq`` and ``flash_bwd_dkv`` L times
each and ``opt_adamw_flat`` once.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from .decode_attention import cache_update, decode_attention

__all__ = ["fused_ln", "fused_ln_plain", "fused_decode_attention",
           "fused_decode_attention_plain", "fused_logits_head",
           "fused_logits_head_plain", "megakernel_adamw_flat",
           "megakernel_adamw_flat_plain", "LAUNCHES", "KERNELS",
           "reset_launches"]

# name -> where its source lives and which TPU kernel it replaces
KERNELS: Dict[str, Dict[str, str]] = {
    "fused_ln": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/fused_ln.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:894",
    },
    "decode_slab": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/decode_slab.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1338",
    },
    "logits_head": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/logits_head.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1544",
    },
    "flash_fwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:74",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:205",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:261",
    },
    "opt_adamw_flat": {
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/opt_megakernel.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1209",
    },
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

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


def _lib():
    from . import _build

    return _build.load()


# ---------------------------------------------------------------------------
# fused layernorm (replaces _ln_fwd_kernel, plain form)
# ---------------------------------------------------------------------------


def fused_ln_plain(x, scale, bias, eps: float = 1e-5):
    """y = (x - mu) * rsqrt(var + eps) * scale + bias over the last axis,
    float32 statistics with the population variance, y in x.dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_ln(x, scale, bias, residual=None, bias_add=None, *,
             eps: float = 1e-5, dropout_rate: float = 0.0,
             return_residual: bool = False):
    """LayerNorm of ``x`` [..., D] with float32 ``scale``/``bias`` [D].

    The residual / bias-add / dropout / ``return_residual`` forms of the
    JAX ``fused_ln`` come with the training slice, together with the
    backward kernel."""
    if (residual is not None or bias_add is not None or dropout_rate
            or return_residual):
        raise NotImplementedError(
            "fused_ln residual/bias_add/dropout/return_residual come with "
            "the training slice (ROADMAP.md, queue B)")
    if not _on_card(x, scale, bias):
        return fused_ln_plain(x, scale, bias, eps)
    D = x.shape[-1]
    code = _dtype_code(x, "fused_ln x")
    _require(x.is_contiguous(), "fused_ln: x must be contiguous")
    _require(tuple(scale.shape) == (D,) and tuple(bias.shape) == (D,),
             f"fused_ln: scale/bias must be [{D}], got "
             f"{tuple(scale.shape)}/{tuple(bias.shape)}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("fused_ln: scale and bias must be float32")
    _require(scale.is_contiguous() and bias.is_contiguous(),
             "fused_ln: scale/bias must be contiguous")
    _require(D * 4 <= _SMEM_DEFAULT, f"fused_ln: D={D} exceeds the "
             f"kernel's row buffer ({_SMEM_DEFAULT // 4} floats)")
    y = torch.empty_like(x)
    R = x.numel() // D if D else 0
    if R == 0:
        return y
    lib = _lib()
    err = lib.ptt_fused_ln(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                           y.data_ptr(), R, D, float(eps), code, _stream(x))
    _check_launch(lib, err, "fused_ln")
    return y


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
    Positions must lie in [0, S).

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
    q_code = _dtype_code(q, "fused_decode_attention q")
    c_code = _dtype_code(k_cache, "fused_decode_attention k_cache")
    _require(v_cache.dtype == k_cache.dtype
             and tuple(v_cache.shape) == (B, S, nh, hd),
             "fused_decode_attention: v_cache must match k_cache")
    _require(k_cache.is_contiguous() and v_cache.is_contiguous(),
             "fused_decode_attention: caches must be contiguous")
    for name, t in (("q", q), ("new_k", new_k), ("new_v", new_v)):
        _require(tuple(t.shape) == (B, nh, hd) and t.dtype == q.dtype,
                 f"fused_decode_attention: {name} must be [{B}, {nh}, "
                 f"{hd}] {q.dtype}, got {tuple(t.shape)} {t.dtype}")
        _require(t.stride(2) == 1 and t.stride(1) == hd
                 and t.stride(0) == q.stride(0),
                 f"fused_decode_attention: {name} needs contiguous heads "
                 "and the same batch stride as q")
    for name, t in (("positions", positions), ("active", active)):
        if t.dtype != torch.int32:
            raise TypeError(f"fused_decode_attention: {name} must be int32")
        _require(tuple(t.shape) == (B,) and t.is_contiguous(),
                 f"fused_decode_attention: {name} must be [{B}] contiguous")
    _require(hd <= 128 and 128 % hd == 0,
             f"fused_decode_attention: head_dim {hd} must divide 128")
    _require((hd + S + 128) * 4 <= _SMEM_DEFAULT,
             f"fused_decode_attention: max_seq {S} exceeds the kernel's "
             "score buffer")
    out = torch.empty((B, nh, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out, k_cache, v_cache
    lib = _lib()
    err = lib.ptt_decode_slab(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), q.stride(0),
        k_cache.data_ptr(), v_cache.data_ptr(), positions.data_ptr(),
        active.data_ptr(), out.data_ptr(), B, S, nh, hd, float(sm_scale),
        q_code, c_code, _stream(q))
    _check_launch(lib, err, "decode_slab")
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# final layernorm + LM head (replaces _logits_head_kernel)
# ---------------------------------------------------------------------------


def fused_logits_head_plain(x, scale, bias, lm_head, *, eps: float = 1e-5):
    """LN(x) rounded to x.dtype, times ``lm_head`` with float32
    accumulation, rounded to x.dtype."""
    y = fused_ln_plain(x, scale, bias, eps)
    return torch.matmul(y.float(), lm_head.float()).to(x.dtype)


def fused_logits_head(x, scale, bias, lm_head, *, eps: float = 1e-5):
    """Final layernorm + LM-head projection in one launch.

    x [B, D]; scale/bias [D] float32; lm_head [D, V] in x.dtype ->
    logits [B, V] in x.dtype. The kernel takes 1 <= B <= 64."""
    if not _on_card(x, scale, bias, lm_head):
        return fused_logits_head_plain(x, scale, bias, lm_head, eps=eps)
    code = _dtype_code(x, "fused_logits_head x")
    _require(x.dim() == 2 and lm_head.dim() == 2
             and lm_head.shape[0] == x.shape[1],
             f"fused_logits_head: x [B, D] and lm_head [D, V] expected, "
             f"got {tuple(x.shape)} and {tuple(lm_head.shape)}")
    B, D = x.shape
    V = lm_head.shape[1]
    _require(lm_head.dtype == x.dtype,
             "fused_logits_head: lm_head must be in x's dtype")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("fused_logits_head: scale and bias must be float32")
    _require(tuple(scale.shape) == (D,) and tuple(bias.shape) == (D,),
             f"fused_logits_head: scale/bias must be [{D}]")
    _require(all(t.is_contiguous() for t in (x, scale, bias, lm_head)),
             "fused_logits_head: inputs must be contiguous")
    _require(1 <= B <= 64, f"fused_logits_head: batch {B} outside 1..64")
    _require(B * D * x.element_size() <= _SMEM_MAX,
             f"fused_logits_head: {B}x{D} rows exceed the kernel's shared "
             "memory")
    out = torch.empty((B, V), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.ptt_logits_head(x.data_ptr(), scale.data_ptr(),
                              bias.data_ptr(), lm_head.data_ptr(),
                              out.data_ptr(), B, D, V, float(eps), code,
                              _stream(x))
    _check_launch(lib, err, "logits_head")
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
        _stream(p))
    _check_launch(lib, err, "opt_adamw_flat")
    return p, m, v
