"""FlashAttention-2 for the training slice — the port of
``paddle_tpu/ops/pallas_kernels.py:74-478`` (``_fwd_kernel``,
``_bwd_dq_kernel``, ``_bwd_dkv_kernel``, the ``_flash`` custom_vjp and
``flash_attention``), in both forms of the reference: bias-free, and with
an additive float32 logit bias.

Three hand-written kernels each sit beside a plain PyTorch version:
:func:`flash_fwd` / :func:`flash_fwd_plain` (``ops/csrc/flash_fwd.cu``,
replacing ``_fwd_kernel`` :74), :func:`flash_bwd_dq` /
:func:`flash_bwd_dq_plain` (``ops/csrc/flash_bwd_dq.cu``, replacing
``_bwd_dq_kernel`` :205) and :func:`flash_bwd_dkv` /
:func:`flash_bwd_dkv_plain` (``ops/csrc/flash_bwd_dkv.cu``, replacing
``_bwd_dkv_kernel`` :261). As in ``ops/cuda_kernels.py``, CPU tensors take
the plain version and CUDA tensors launch the kernel or raise.

The two backward kernels are FlashAttention-2's backward on ``mma.sync``
(``ops/csrc/flash_bwd.cuh`` holds what they share). At the GPT training
shape ([16, 1024, 12, 64], causal) the pair does 90.3 GFLOP on 177 MB, so
the tensor cores bound it; the design keeps P, P^T and dS in registers
(their C fragments packed into A fragments), reads every tile's fragments
by ``ldmatrix`` (transposed operands by ``ldmatrix.trans``), streams the
walked tiles through a ``cp.async`` ring, and computes D = rowsum(dO * o)
once a query row: dQ computes it (``return_di=True``) and dK/dV reads it
(``di=``), so dK/dV never touches o. :class:`_Flash`'s backward launches
dQ, then dK/dV with dQ's D.

The kernels read q, k and v in the public ``[B, T, nh, hd]`` layout through
their strides (no transpose to ``[BH, T, hd]`` as JAX does), so slices of
one packed qkv tensor are taken as they are; lse is ``[B, nh, T]`` float32,
one value per row where the TPU kept 128 replicated lanes. The kernels
are compiled for head_dim 16, 32, 64 and 128; any other head_dim up to
128 (8, 24, 48, 80, 96, ...) runs the next instance on inputs padded with
zero columns (:func:`pad_head_dim`), which add nothing to any dot
product, and the outputs are sliced back. Past 128 every head_dim runs
the split route (``ops/csrc/flash_wide.cuh``): a grid dimension walks the
output columns in blocks of 64, the reductions over hd loop over 64-column
slabs, so one instance a dtype takes any hd as it is (no padding, no
alignment).

The bias, as the kernels take it, is float32 ``[BB, SQ, T]``: BB = B
shares one bias among a batch row's heads (head ``bh`` reads row
``bh // nh``), BB = B·nh is one bias a head; SQ = 1 is a row-broadcast
padding mask (the [T, T] square never materialises), SQ = T a full mask.
Every kernel adds it to the scaled scores, ``s = q.k^T * scale + bias``,
before the causal mask replaces entries with ``_NEG_INF``.
:func:`flash_attention` takes the public ``[B, nh | 1, SQ, T]`` form and
folds it as ``pallas_kernels.py:466-474`` does. The bias gets no gradient.

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


def _wide(hd: int) -> bool:
    """Whether a head_dim runs the split route (past the widest
    instance)."""
    return hd > _HEAD_DIMS[-1]


def _padded_hd(hd: int) -> Optional[int]:
    """The compiled instance a head_dim up to 128 that has none runs on,
    padded with zero columns (exact: the padded columns add 0 to every
    q·k and give zero output columns, and the scale stays 1/sqrt(true
    hd)); None for an instance and for the split route past 128, which
    takes any hd as it is."""
    if hd < 1:
        raise ValueError(f"flash attention: head_dim {hd} < 1")
    if hd in _HEAD_DIMS or _wide(hd):
        return None
    return next(h for h in _HEAD_DIMS if h >= hd)


def pad_head_dim(x: torch.Tensor, hd: int) -> torch.Tensor:
    """x [..., d] -> a contiguous [..., hd] with zero columns d..hd-1."""
    return F.pad(x, (0, hd - x.shape[-1]))


def _bh(x: torch.Tensor) -> torch.Tensor:
    """[B, T, nh, hd] -> [B, nh, T, hd] float32."""
    return x.float().transpose(1, 2)


def _bias_bh(bias, B: int, nh: int) -> torch.Tensor:
    """A kernel-form bias [BB, SQ, Tk] -> float32 [B, nh | 1, SQ, Tk],
    which broadcasts against the scores."""
    BB, SQ, Tk = bias.shape
    return bias.float().reshape(B, BB // B, SQ, Tk)


def _scores(q, k, causal: bool, sm_scale: float, bias=None) -> torch.Tensor:
    """q.k^T * scale (+ bias) in float32 [B, nh, T, Tk], causal entries
    then replaced by ``_NEG_INF`` as the kernels mask them."""
    s = torch.matmul(_bh(q), _bh(k).transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + _bias_bh(bias, q.shape[0], q.shape[2])
    if causal:
        T, Tk = s.shape[-2:]
        keep = torch.ones((T, Tk), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, bias=None):
    """The forward kernel's arithmetic in PyTorch ops: f32 scores, softmax
    with P rounded to v's dtype before P.V, o = acc * (1/l) in q's dtype
    and lse = m + log(l) ``[B, nh, T]`` float32, with the ``l == 0``
    guards of the reference."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, sm_scale, bias)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), _bh(v))
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc * (1.0 / l_safe)).to(q.dtype).transpose(1, 2).contiguous()
    return o, (m + torch.log(l_safe)).squeeze(-1)


def _di(o, do) -> torch.Tensor:
    """D = rowsum(dO * o) in float32, a contiguous [B, nh, T]."""
    return (_bh(do) * _bh(o)).sum(-1).contiguous()


def _probs(q, k, v, di, lse, do, causal, sm_scale, bias):
    """(P, dS) of the backward in float32 [B, nh, T, Tk], from D."""
    p = torch.exp(_scores(q, k, causal, sm_scale, bias) - lse.unsqueeze(-1))
    dp = torch.matmul(_bh(do), _bh(v).transpose(-1, -2))
    return p, p * (dp - di.unsqueeze(-1)) * sm_scale


def flash_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = True,
                       sm_scale: Optional[float] = None, bias=None,
                       return_di: bool = False):
    """dQ = round(dS).K with f32 sums, in q's dtype; with ``return_di``
    also D = rowsum(dO * o), float32 [B, nh, T], for
    :func:`flash_bwd_dkv_plain`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    di = _di(o, do)
    _p, ds = _probs(q, k, v, di, lse, do, causal, sm_scale, bias)
    dq = torch.matmul(ds.to(k.dtype).float(), _bh(k))
    dq = dq.to(q.dtype).transpose(1, 2).contiguous()
    return (dq, di) if return_di else dq


def flash_bwd_dkv_plain(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: Optional[float] = None, bias=None,
                        di=None):
    """dK = dS^T.Q with dS in float32, as the reference keeps it (the bf16
    kernel carries dS as two bf16 parts, about 2^-17 of it), dV =
    round(P)^T.dO; (dk, dv) in k's and v's dtypes. ``di`` is D =
    rowsum(dO * o) from :func:`flash_bwd_dq_plain`; without it D is
    computed from o."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if di is None:
        di = _di(o, do)
    p, ds = _probs(q, k, v, di, lse, do, causal, sm_scale, bias)
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
    _ck._require(hd in _HEAD_DIMS or _wide(hd),
                 f"{what}: head_dim {hd} not in {_HEAD_DIMS} nor past 128 "
                 "(the wrappers pad any other hd <= 128 to the next)")
    _ck._require(q.stride() == k.stride() == v.stride(),
                 f"{what}: q, k, v must share strides")
    _ck._require(q.stride(3) == 1, f"{what}: head_dim must be unit-stride")
    esz = q.element_size()
    _ck._require(_wide(hd) or (
        all(t.data_ptr() % 16 == 0 for t in (q, k, v))
        and all(s * esz % 16 == 0 for s in q.stride()[:3])),
                 f"{what}: q, k, v need 16-byte aligned rows")
    _ck._require(0 < B * nh <= 65535, f"{what}: B*nh={B * nh} outside "
                 "1..65535")
    return B, T, nh, hd, code, q.stride()[:3]


def _name(kernel: str, bias) -> str:
    """The launch count a call ticks: the bias form counts apart."""
    return kernel if bias is None else kernel + "_bias"


def _check_bias(bias, B: int, T: int, nh: int, what: str):
    """The kernels' contract on a bias: float32, contiguous, 16-byte
    aligned, [BB, SQ, T] with BB in {B, B·nh} and SQ in {1, T}. Returns
    (pointer, heads that share one bias row, SQ); (None, 1, 1) for none."""
    if bias is None:
        return None, 1, 1
    if bias.dtype != torch.float32:
        raise TypeError(f"{what}: bias must be float32, got {bias.dtype}")
    _ck._require(bias.dim() == 3 and bias.shape[0] in (B, B * nh)
                 and bias.shape[1] in (1, T) and bias.shape[2] == T,
                 f"{what}: bias must be [B or B*nh, 1 or T, T] = "
                 f"[{B} or {B * nh}, 1 or {T}, {T}], got "
                 f"{tuple(bias.shape)}")
    _ck._require(bias.is_contiguous() and bias.data_ptr() % 16 == 0,
                 f"{what}: bias must be contiguous and 16-byte aligned")
    heads = nh if bias.shape[0] == B else 1
    return bias.data_ptr(), heads, bias.shape[1]


def flash_fwd(q, k, v, causal: bool = True,
              sm_scale: Optional[float] = None, bias=None):
    """(o [B, T, nh, hd] in q's dtype, lse [B, nh, T] float32) for q, k, v
    [B, T, nh, hd] float32 or bfloat16 (any hd: 16, 32, 64 and 128 are
    instances, any other up to 128 pads to the next, past 128 the split
    route) and an
    optional float32 ``bias`` [B or B·nh, 1 or T, T] — one launch of the
    forward kernel on the card."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ts = (q, k, v) if bias is None else (q, k, v, bias)
    if not _ck._on_card(*ts):
        return flash_fwd_plain(q, k, v, causal, sm_scale, bias)
    hd = q.shape[-1]
    to = _padded_hd(hd)
    if to is not None:
        o, lse = flash_fwd(*(pad_head_dim(x, to) for x in (q, k, v)),
                           causal, sm_scale, bias)
        return o[..., :hd].contiguous(), lse
    B, T, nh, hd, code, (sb, st, sh) = _check_qkv(q, k, v, "flash_fwd")
    bptr, bheads, brows = _check_bias(bias, B, T, nh, "flash_fwd")
    o = torch.empty((B, T, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=q.device)
    if T == 0:
        return o, lse
    lib = _ck._lib()
    err = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), bptr, B, T, nh, hd,
                            sb, st, sh, float(sm_scale), int(bool(causal)),
                            bheads, brows, code, _ck._stream(q))
    _ck._check_launch(lib, err, _name("flash_fwd", bias))
    return o, lse


def _bwd_inputs(q, k, v, o, lse, do, bias, what):
    """The backward kernels' contract on their inputs: returns the
    ``_check_qkv`` dims and the ``_check_bias`` triple. The wrappers make
    do (and dQ's o) contiguous; ``_Flash.backward`` makes do so once for
    both kernels."""
    dims = _check_qkv(q, k, v, what)
    B, T, nh, hd = dims[:4]
    for name, t in (("o", o), ("do", do)):
        _ck._require(tuple(t.shape) == (B, T, nh, hd) and t.dtype == q.dtype,
                     f"{what}: {name} must be [{B}, {T}, {nh}, {hd}] "
                     f"{q.dtype}")
    _ck._require(tuple(lse.shape) == (B, nh, T)
                 and lse.dtype == torch.float32 and lse.is_contiguous(),
                 f"{what}: lse must be a contiguous float32 [{B}, {nh}, {T}]")
    return dims, _check_bias(bias, B, T, nh, what)


def _check_di(di, B: int, nh: int, T: int, what: str) -> None:
    """The dK/dV kernel's contract on D: float32, contiguous, [B, nh, T]."""
    if di.dtype != torch.float32:
        raise TypeError(f"{what}: di must be float32, got {di.dtype}")
    _ck._require(tuple(di.shape) == (B, nh, T) and di.is_contiguous(),
                 f"{what}: di must be a contiguous float32 [{B}, {nh}, {T}],"
                 f" got {tuple(di.shape)}")


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = True,
                 sm_scale: Optional[float] = None, bias=None,
                 return_di: bool = False):
    """dq [B, T, nh, hd] in q's dtype from the forward's (o, lse) and the
    output cotangent ``do``, with the forward's ``bias`` — one launch of
    the dQ kernel on the card. With ``return_di``, ``(dq, di)``: di is D =
    rowsum(dO * o), float32 [B, nh, T], which the kernel computes on the
    way and :func:`flash_bwd_dkv` takes."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ts = (q, k, v, o, lse, do) + (() if bias is None else (bias,))
    if not _ck._on_card(*ts):
        return flash_bwd_dq_plain(q, k, v, o, lse, do, causal, sm_scale,
                                  bias, return_di)
    hd = q.shape[-1]
    to = _padded_hd(hd)
    if to is not None:
        q, k, v, o, do = (pad_head_dim(x, to) for x in (q, k, v, o, do))
        out = flash_bwd_dq(q, k, v, o, lse, do, causal, sm_scale, bias,
                           return_di)
        if return_di:
            return out[0][..., :hd].contiguous(), out[1]
        return out[..., :hd].contiguous()
    o, do = o.contiguous(), do.contiguous()
    ((B, T, nh, hd, code, (sb, st, sh)),
     (bptr, bheads, brows)) = _bwd_inputs(q, k, v, o, lse, do, bias,
                                          "flash_bwd_dq")
    dq = torch.empty((B, T, nh, hd), dtype=q.dtype, device=q.device)
    di = (torch.empty((B, nh, T), dtype=torch.float32, device=q.device)
          if return_di else None)
    lib = _ck._lib()
    err = lib.ptt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               bptr, dq.data_ptr(),
                               None if di is None else di.data_ptr(), B, T,
                               nh, hd, sb, st, sh, float(sm_scale),
                               int(bool(causal)), bheads, brows, code,
                               _ck._stream(q))
    _ck._check_launch(lib, err, _name("flash_bwd_dq", bias))
    return (dq, di) if return_di else dq


def flash_bwd_dkv(q, k, v, o, lse, do, causal: bool = True,
                  sm_scale: Optional[float] = None, bias=None, di=None):
    """(dk, dv) [B, T, nh, hd] — one launch of the dK/dV kernel on the
    card; arguments as :func:`flash_bwd_dq`, and ``di``, D from
    ``flash_bwd_dq(..., return_di=True)``. The kernel reads D, never o:
    called on the card without ``di``, it takes D from a launch of the dQ
    kernel first."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ts = (q, k, v, o, lse, do) + (() if bias is None else (bias,))
    if not _ck._on_card(*ts + (() if di is None else (di,))):
        return flash_bwd_dkv_plain(q, k, v, o, lse, do, causal, sm_scale,
                                   bias, di)
    do = do.contiguous()
    if di is None:
        _dq, di = flash_bwd_dq(q, k, v, o, lse, do, causal, sm_scale, bias,
                               return_di=True)
    hd = q.shape[-1]
    to = _padded_hd(hd)
    if to is not None:
        q, k, v, o, do = (pad_head_dim(x, to) for x in (q, k, v, o, do))
        return tuple(x[..., :hd].contiguous() for x in flash_bwd_dkv(
            q, k, v, o, lse, do, causal, sm_scale, bias, di))
    ((B, T, nh, hd, code, (sb, st, sh)),
     (bptr, bheads, brows)) = _bwd_inputs(q, k, v, o, lse, do, bias,
                                          "flash_bwd_dkv")
    _check_di(di, B, nh, T, "flash_bwd_dkv")
    dk = torch.empty((B, T, nh, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _ck._lib()
    err = lib.ptt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                                bptr, dk.data_ptr(), dv.data_ptr(), B, T, nh,
                                hd, sb, st, sh, float(sm_scale),
                                int(bool(causal)), bheads, brows, code,
                                _ck._stream(q))
    _ck._check_launch(lib, err, _name("flash_bwd_dkv", bias))
    return dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], causal: bool,
                  sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal, sm_scale, bias)


# the forward as the dispatcher sees it (remat policies match on it)
FLASH_FWD_OP = torch.ops.paddle_tpu_torch.flash_fwd.default


class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp: saves (q, k, v, o, lse, bias); the
    backward launches dQ, which also gives D = rowsum(dO * o), then dK/dV
    with that D. The bias is a constant mask: its
    cotangent is zero (``_flash_bwd`` :428-431), given as zeros only when
    the bias asks for a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool, sm_scale: float):
        o, lse = FLASH_FWD_OP(q, k, v, bias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias = ctx.saved_tensors
        do = do.contiguous()      # once, for both kernels
        dq, di = flash_bwd_dq(q, k, v, o, lse, do, ctx.causal, ctx.sm_scale,
                              bias, return_di=True)
        dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, ctx.causal,
                               ctx.sm_scale, bias, di)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, block_q: int = 512,
                    block_k: int = 512, bias=None):
    """FlashAttention-2: q, k, v [B, T, nh, hd] -> [B, T, nh, hd],
    differentiable through the hand-written backward kernels.

    ``bias`` is an optional additive logit bias (padding or attention
    mask), ``[B, nh, SQ, T]`` or ``[B, 1, SQ, T]`` with SQ = T or SQ = 1
    (the O(B·T) padding form, broadcast inside the kernels, so a row mask
    never materialises the [T, T] square). Any other head dim raises
    ``ValueError``, as JAX's does. It is cast to float32 and is not
    differentiated: its gradient is zero (None unless it requires one).

    ``block_q``/``block_k`` are kept for the JAX signature; the kernels
    pick their own tiles, and since the causal block skip is exact the
    result does not depend on them."""
    del block_q, block_k
    b, t, nh, hd = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if bias is not None:
        if bias.dim() != 4:
            raise ValueError(f"bias must be [B, nh | 1, SQ, Tk], got "
                             f"{tuple(bias.shape)}")
        bb, bn, sq, tk = bias.shape
        if bn not in (1, nh):
            raise ValueError(f"bias head dim {bn} must be 1 or {nh}")
        if bb != b or sq not in (1, t) or tk != t:
            raise ValueError(f"bias {tuple(bias.shape)} must be [{b}, "
                             f"{bn}, 1 or {t}, {t}]")
        bias = bias.reshape(b * bn, sq, tk).to(torch.float32).contiguous()
    return _Flash.apply(q, k, v, bias, bool(causal), float(sm_scale))
