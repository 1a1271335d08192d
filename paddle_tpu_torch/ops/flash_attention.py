"""FlashAttention-2 for the training slice — the port of
``paddle_tpu/ops/pallas_kernels.py:74-478`` (``_fwd_kernel``,
``_bwd_dq_kernel``, ``_bwd_dkv_kernel``, the ``_flash`` custom_vjp and
``flash_attention``).

Three hand-written kernels (the forward in ``ops/csrc/flash_fwd.cu``, dQ
and dK/dV in ``ops/csrc/flash_attention.cu``) each sit beside a plain
PyTorch version: :func:`flash_fwd` / :func:`flash_fwd_plain`,
:func:`flash_bwd_dq` / :func:`flash_bwd_dq_plain` and :func:`flash_bwd_dkv`
/ :func:`flash_bwd_dkv_plain`. As in ``ops/cuda_kernels.py``, CPU tensors
take the plain version and CUDA tensors launch the kernel or raise.

The kernels read q, k and v in the public ``[B, T, nh, hd]`` layout through
their strides (no transpose to ``[BH, T, hd]`` as JAX does), so slices of
one packed qkv tensor are taken as they are; lse is ``[B, nh, T]`` float32,
one value per row where the TPU kept 128 replicated lanes. The kernels
are compiled for head_dim 16, 32, 64 and 128; head_dim 8 runs the 16
instance on inputs padded with zero columns (:func:`pad_head_dim`), which
add nothing to any dot product, and the outputs are sliced back.

The forward is registered as the dispatcher op
``paddle_tpu_torch::flash_fwd`` so that a selective-checkpoint policy sees
it: ``save_only_flash`` keeps its outputs, ``dots`` recomputes it (the 2·L
forward launches of a remat step, as in JAX, where a ``pallas_call`` is
not a saveable dot).
"""
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_kernels as _ck

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain",
           "flash_bwd_dq", "flash_bwd_dq_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "pad_head_dim", "FLASH_FWD_OP"]

_NEG_INF = -0.7 * float(np.finfo(np.float32).max)
_HEAD_DIMS = (16, 32, 64, 128)
# head_dim -> the compiled instance it runs on, padded with zero columns
_PADDED_HEAD_DIMS = {8: 16}


def pad_head_dim(x: torch.Tensor, hd: int) -> torch.Tensor:
    """x [..., d] -> a contiguous [..., hd] with zero columns d..hd-1."""
    return F.pad(x, (0, hd - x.shape[-1]))


def _bh(x: torch.Tensor) -> torch.Tensor:
    """[B, T, nh, hd] -> [B, nh, T, hd] float32."""
    return x.float().transpose(1, 2)


def _scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """q.k^T * scale in float32 [B, nh, T, Tk], causal entries masked to
    ``_NEG_INF`` as the kernels mask them."""
    s = torch.matmul(_bh(q), _bh(k).transpose(-1, -2)) * sm_scale
    if causal:
        T, Tk = s.shape[-2:]
        keep = torch.ones((T, Tk), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None):
    """The forward kernel's arithmetic in PyTorch ops: f32 scores, softmax
    with P rounded to v's dtype before P.V, o = acc * (1/l) in q's dtype
    and lse = m + log(l) ``[B, nh, T]`` float32, with the ``l == 0``
    guards of the reference."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), _bh(v))
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc * (1.0 / l_safe)).to(q.dtype).transpose(1, 2).contiguous()
    return o, (m + torch.log(l_safe)).squeeze(-1)


def _probs(q, k, v, o, lse, do, causal, sm_scale):
    """(P, dS) of the backward in float32 [B, nh, T, Tk]."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse.unsqueeze(-1))
    dp = torch.matmul(_bh(do), _bh(v).transpose(-1, -2))
    di = (_bh(do) * _bh(o)).sum(-1, keepdim=True)
    return p, p * (dp - di) * sm_scale


def flash_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = True,
                       sm_scale: Optional[float] = None):
    """dQ = round(dS).K with f32 sums, in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _p, ds = _probs(q, k, v, o, lse, do, causal, sm_scale)
    dq = torch.matmul(ds.to(k.dtype).float(), _bh(k))
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def flash_bwd_dkv_plain(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: Optional[float] = None):
    """dK = dS^T.Q with dS in float32, as the reference keeps it (the bf16
    kernel rounds dS to bf16 once), dV = round(P)^T.dO; (dk, dv) in k's
    and v's dtypes."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _probs(q, k, v, o, lse, do, causal, sm_scale)
    dk = torch.matmul(ds.transpose(-1, -2), _bh(q))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), _bh(do))
    return (dk.to(k.dtype).transpose(1, 2).contiguous(),
            dv.to(v.dtype).transpose(1, 2).contiguous())


def _check_qkv(q, k, v, what: str):
    """The kernels' contract on q, k, v; returns (B, T, nh, hd, dtype code,
    strides)."""
    _ck._require(q.dim() == 4 and q.shape == k.shape == v.shape,
                 f"{what}: q, k, v must be [B, T, nh, hd] of one shape, got "
                 f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, nh, hd = q.shape
    code = _ck._dtype_code(q, what)
    _ck._require(k.dtype == q.dtype and v.dtype == q.dtype,
                 f"{what}: q, k, v must share a dtype")
    _ck._require(hd in _HEAD_DIMS,
                 f"{what}: head_dim {hd} not in {_HEAD_DIMS} (or 8, "
                 "padded to 16)")
    _ck._require(q.stride() == k.stride() == v.stride(),
                 f"{what}: q, k, v must share strides")
    _ck._require(q.stride(3) == 1, f"{what}: head_dim must be unit-stride")
    esz = q.element_size()
    _ck._require(all(t.data_ptr() % 16 == 0 for t in (q, k, v))
                 and all(s * esz % 16 == 0 for s in q.stride()[:3]),
                 f"{what}: q, k, v need 16-byte aligned rows")
    _ck._require(0 < B * nh <= 65535, f"{what}: B*nh={B * nh} outside "
                 "1..65535")
    return B, T, nh, hd, code, q.stride()[:3]


def flash_fwd(q, k, v, causal: bool = True,
              sm_scale: Optional[float] = None):
    """(o [B, T, nh, hd] in q's dtype, lse [B, nh, T] float32) for q, k, v
    [B, T, nh, hd] float32 or bfloat16 (hd in 8/16/32/64/128) — one launch
    of the forward kernel on the card."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _ck._on_card(q, k, v):
        return flash_fwd_plain(q, k, v, causal, sm_scale)
    hd = q.shape[-1]
    if hd in _PADDED_HEAD_DIMS:
        to = _PADDED_HEAD_DIMS[hd]
        o, lse = flash_fwd(*(pad_head_dim(x, to) for x in (q, k, v)),
                           causal, sm_scale)
        return o[..., :hd].contiguous(), lse
    B, T, nh, hd, code, (sb, st, sh) = _check_qkv(q, k, v, "flash_fwd")
    o = torch.empty((B, T, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=q.device)
    if T == 0:
        return o, lse
    lib = _ck._lib()
    err = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), B, T, nh, hd, sb,
                            st, sh, float(sm_scale), int(bool(causal)), code,
                            _ck._stream(q))
    _ck._check_launch(lib, err, "flash_fwd")
    return o, lse


def _bwd_inputs(q, k, v, o, lse, do, what):
    dims = _check_qkv(q, k, v, what)
    B, T, nh, hd = dims[:4]
    o, do = o.contiguous(), do.contiguous()
    for name, t in (("o", o), ("do", do)):
        _ck._require(tuple(t.shape) == (B, T, nh, hd) and t.dtype == q.dtype,
                     f"{what}: {name} must be [{B}, {T}, {nh}, {hd}] "
                     f"{q.dtype}")
    _ck._require(tuple(lse.shape) == (B, nh, T)
                 and lse.dtype == torch.float32 and lse.is_contiguous(),
                 f"{what}: lse must be a contiguous float32 [{B}, {nh}, {T}]")
    return dims, o, do


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = True,
                 sm_scale: Optional[float] = None):
    """dq [B, T, nh, hd] in q's dtype from the forward's (o, lse) and the
    output cotangent ``do`` — one launch of the dQ kernel on the card."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _ck._on_card(q, k, v, o, lse, do):
        return flash_bwd_dq_plain(q, k, v, o, lse, do, causal, sm_scale)
    hd = q.shape[-1]
    if hd in _PADDED_HEAD_DIMS:
        to = _PADDED_HEAD_DIMS[hd]
        q, k, v, o, do = (pad_head_dim(x, to) for x in (q, k, v, o, do))
        return flash_bwd_dq(q, k, v, o, lse, do, causal,
                            sm_scale)[..., :hd].contiguous()
    (B, T, nh, hd, code, (sb, st, sh)), o, do = _bwd_inputs(
        q, k, v, o, lse, do, "flash_bwd_dq")
    dq = torch.empty((B, T, nh, hd), dtype=q.dtype, device=q.device)
    lib = _ck._lib()
    err = lib.ptt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               dq.data_ptr(), B, T, nh, hd, sb, st, sh,
                               float(sm_scale), int(bool(causal)), code,
                               _ck._stream(q))
    _ck._check_launch(lib, err, "flash_bwd_dq")
    return dq


def flash_bwd_dkv(q, k, v, o, lse, do, causal: bool = True,
                  sm_scale: Optional[float] = None):
    """(dk, dv) [B, T, nh, hd] — one launch of the dK/dV kernel on the
    card; arguments as :func:`flash_bwd_dq`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _ck._on_card(q, k, v, o, lse, do):
        return flash_bwd_dkv_plain(q, k, v, o, lse, do, causal, sm_scale)
    hd = q.shape[-1]
    if hd in _PADDED_HEAD_DIMS:
        to = _PADDED_HEAD_DIMS[hd]
        q, k, v, o, do = (pad_head_dim(x, to) for x in (q, k, v, o, do))
        return tuple(x[..., :hd].contiguous() for x in flash_bwd_dkv(
            q, k, v, o, lse, do, causal, sm_scale))
    (B, T, nh, hd, code, (sb, st, sh)), o, do = _bwd_inputs(
        q, k, v, o, lse, do, "flash_bwd_dkv")
    dk = torch.empty((B, T, nh, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _ck._lib()
    err = lib.ptt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), B, T, nh, hd,
                                sb, st, sh, float(sm_scale),
                                int(bool(causal)), code, _ck._stream(q))
    _ck._check_launch(lib, err, "flash_bwd_dkv")
    return dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal, sm_scale)


# the forward as the dispatcher sees it (remat policies match on it)
FLASH_FWD_OP = torch.ops.paddle_tpu_torch.flash_fwd.default


class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp: saves (q, k, v, o, lse); the backward
    launches dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = FLASH_FWD_OP(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq = flash_bwd_dq(q, k, v, o, lse, do, ctx.causal, ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, block_q: int = 512,
                    block_k: int = 512, bias=None):
    """FlashAttention-2: q, k, v [B, T, nh, hd] -> [B, T, nh, hd],
    differentiable through the hand-written backward kernels.

    ``block_q``/``block_k`` are kept for the JAX signature; the kernels
    pick their own tiles, and since the causal block skip is exact the
    result does not depend on them. The additive ``bias`` belongs to
    the ERNIE slice and raises."""
    del block_q, block_k
    if bias is not None:
        raise NotImplementedError(
            "flash_attention bias= (padding / attention masks) comes with "
            "the ERNIE slice of the port (ROADMAP.md, queue A, item A1)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, bool(causal), float(sm_scale))
