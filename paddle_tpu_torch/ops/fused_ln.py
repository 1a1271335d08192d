"""Fused layernorm (+ residual + bias-add + dropout) — the port of
``paddle_tpu/ops/pallas_kernels.py:871-1154`` (``_ln_fwd_kernel``,
``_ln_bwd_kernel``, the ``_fused_ln`` custom_vjp and ``fused_ln``).

Two hand-written kernels each sit beside a plain PyTorch version:
:func:`fused_ln_fwd` / :func:`fused_ln_fwd_plain` (``ops/csrc/fused_ln.cu``)
and :func:`fused_ln_bwd` / :func:`fused_ln_bwd_plain`
(``ops/csrc/ln_bwd.cu``). As in ``ops/cuda_kernels.py``, CPU tensors take
the plain version and CUDA tensors launch the kernel or raise.

The forward computes, over rows ``[R, D]``,

    s = dropout(x) + residual + bias_add   (in x's dtype, rounded after
                                            each step, as JAX computes it)
    y = (s - mu) * rsqrt(var + eps) * scale + bias

with float32 statistics ``mu``/``rstd`` ``[R]`` (one value a row; the TPU
kept 128 replicated lanes). The dropout mask is drawn outside the kernel,
as JAX draws it, from a ``torch.Generator``; :func:`fused_ln_masked` takes
a mask directly (the tests pass JAX's bernoulli mask across).

The forward is registered as the dispatcher op
``paddle_tpu_torch::fused_ln_fwd`` so that a selective-checkpoint policy
sees one op: ``dots`` and ``save_only_flash`` recompute it, as in JAX,
where a ``pallas_call`` is not a saveable dot.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_kernels as _ck
from . import kernel_costs as _kc

__all__ = ["fused_ln", "fused_ln_masked", "fused_ln_fwd",
           "fused_ln_fwd_plain", "fused_ln_bwd", "fused_ln_bwd_plain",
           "fused_ln_plan", "ln_bwd_plan", "ln_bwd_grid", "FUSED_LN_FWD_OP"]

# The kernels' instances (ops/csrc/fused_ln.cu, ln_bwd.cu): one warp a row,
# WARPS rows a block, each lane holding `lane_elems` columns of the row in
# chunks of one 16-byte vector (8 bf16 or 4 float32 elements), accessed as
# one vector where every operand is aligned to it and D is a multiple of
# it (the kernel's entry point tests the pointers), else one element at a
# time; past the register path, one block a row (ROW_SMEM), and past that
# a block a row that keeps no row (ROW_TWO_PASS).
WARPS = 4
_FWD_ELEMS = (8, 16, 24, 32, 64)          # D <= 2048
_BWD_ELEMS = (8, 16, 24, 32)              # D <= 1024
ROW_SMEM = 0        # forward: the float32 row in shared memory; backward:
                    # eight columns a thread in registers (D <= 2048)
ROW_TWO_PASS = -1   # forward: s recomputed in each pass; backward: the row
                    # walked in chunks, s and dy read again in pass 2
# the forward's float32 row beside its scratch in a block's 227 KB
_FWD_SMEM_MAX = _ck._SMEM_MAX - 1024
_MAX_D = 2048           # the backward's block a row: 8 columns a thread


def _lane_elems(D: int, elems) -> int:
    """The fewest elements a lane holds with 32 lanes covering D, 0 past
    the set (one block a row)."""
    return next((e for e in elems if 32 * e >= D), 0)


@functools.lru_cache(maxsize=None)
def fused_ln_plan(D: int) -> int:
    """The forward kernel's instance for rows of D: the elements a lane
    holds (8, 16, 24, 32 or 64: the fewest with 32 x lane_elems >= D), or
    past 2048 one 256-thread block a row: ``ROW_SMEM`` while its float32
    row fits a block's shared memory (opted in past 48 KB: D up to about
    57,000), ``ROW_TWO_PASS`` past that. Any D has an instance."""
    lane = _lane_elems(D, _FWD_ELEMS)
    if lane:
        return lane
    return ROW_SMEM if D * 4 <= _FWD_SMEM_MAX else ROW_TWO_PASS


@functools.lru_cache(maxsize=None)
def ln_bwd_plan(D: int) -> int:
    """The backward kernel's instance, as :func:`fused_ln_plan`: 8-32
    elements a lane (D <= 1024), else one 256-thread block a row:
    ``ROW_SMEM`` (eight columns a thread in registers) up to 2048 columns,
    ``ROW_TWO_PASS`` (the row walked in chunks) past it. Any D has an
    instance."""
    lane = _lane_elems(D, _BWD_ELEMS)
    if lane:
        return lane
    return ROW_SMEM if D <= _MAX_D else ROW_TWO_PASS


def ln_bwd_grid(R: int, lane_elems: int, sms: int, bps: int) -> int:
    """The backward kernel's blocks for R rows: one wave of ``sms`` x
    ``bps`` blocks (``bps`` the blocks an SM holds of the instance), fewer
    where R leaves some without a row. Each block has WARPS row walkers
    (one on the block-a-row instances, ``lane_elems`` <= 0); walker w of
    W takes rows w, w + W, w + 2W, ..."""
    walkers = WARPS if lane_elems > 0 else 1
    return max(1, min(-(-R // walkers), sms * bps))


@functools.lru_cache(maxsize=None)
def _bwd_blocks_per_sm(D: int, lane_elems: int, has_dsx: bool,
                       has_mask: bool, code: int) -> int:
    """The blocks an SM holds of the backward's (16-byte vector) instance,
    from the occupancy API; the scalar-access instance is sized the same."""
    lib = _ck._lib()
    out = ctypes.c_int(0)
    err = lib.ptt_ln_bwd_blocks_per_sm(D, lane_elems, int(has_dsx),
                                       int(has_mask), code,
                                       ctypes.byref(out))
    if err != 0:
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f"fused_ln_bwd: occupancy query failed: CUDA "
                           f"error {err} ({msg})")
    return max(1, out.value)


@functools.lru_cache(maxsize=None)
def _round_to(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (as ``jnp.asarray(value, dtype)``);
    cached, since building the tensor costs more host time than a
    kernel launch."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def fused_ln_fwd_plain(x, scale, bias, residual=None, bias_add=None,
                       mask=None, eps: float = 1e-5, inv_keep: float = 1.0):
    """The forward kernel's arithmetic in PyTorch ops on rows ``x`` [R, D].
    ``inv_keep`` is 1/keep rounded to x's dtype. Returns (y, s or None
    when no residual/bias_add/mask, mu [R], rstd [R])."""
    s = x
    if mask is not None:
        s = s * mask.to(s.dtype) * inv_keep
    if residual is not None:
        s = residual + s
    if bias_add is not None:
        s = s + bias_add
    s32 = s.float()
    mu = s32.mean(-1)
    var = s32.var(-1, correction=0)
    rstd = torch.rsqrt(var + eps)
    y = (s32 - mu[:, None]) * rstd[:, None]
    y = (y * scale.float() + bias.float()).to(x.dtype)
    emit = residual is not None or bias_add is not None or mask is not None
    return y, (s if emit else None), mu, rstd


def _check_rows(what, t, shape, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.shape != shape or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {list(shape)}, got "
                         f"{tuple(t.shape)}")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_ln_fwd(x, scale, bias, residual=None, bias_add=None, mask=None,
                 eps: float = 1e-5, inv_keep: float = 1.0,
                 stats: bool = True):
    """One launch of the forward kernel on the card (the plain version on
    CPU tensors): rows ``x`` [R, D] float32 or bfloat16; ``scale``/``bias``
    [D] float32; optional ``residual`` [R, D] and ``bias_add`` [D] in x's
    dtype and ``mask`` [R, D] bool. Returns (y, s or None, mu, rstd);
    ``stats=False`` skips writing mu/rstd on the card (None then)."""
    # the serving decode tick calls this 2·L times a tick: the checks
    # format their messages only when they fail
    opt = [t for t in (residual, bias_add, mask) if t is not None]
    if not _ck._on_card(x, scale, bias, *opt):
        return fused_ln_fwd_plain(x, scale, bias, residual, bias_add, mask,
                                  eps, inv_keep)
    if x.dim() != 2:
        raise ValueError(f"fused_ln: x must be [R, D], got {tuple(x.shape)}")
    R, D = x.shape
    code = _ck._dtype_code(x, "fused_ln x")
    _check_rows("fused_ln x", x, (R, D), x.dtype)
    _check_rows("fused_ln scale", scale, (D,), torch.float32)
    _check_rows("fused_ln bias", bias, (D,), torch.float32)
    if residual is not None:
        _check_rows("fused_ln residual", residual, (R, D), x.dtype)
    if bias_add is not None:
        _check_rows("fused_ln bias_add", bias_add, (D,), x.dtype)
    if mask is not None:
        _check_rows("fused_ln mask", mask, (R, D), torch.bool)
    lane_elems = fused_ln_plan(D)
    y = torch.empty_like(x)
    s = torch.empty_like(x) if opt else None
    mu = rstd = None
    if stats:
        mu = torch.empty(R, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    if R == 0:
        return y, s, mu, rstd
    lib = _ck._lib()
    err = lib.ptt_fused_ln(x.data_ptr(), _ptr(residual), _ptr(bias_add),
                           _ptr(mask), scale.data_ptr(), bias.data_ptr(),
                           y.data_ptr(), _ptr(s), _ptr(mu), _ptr(rstd), R, D,
                           float(eps), float(inv_keep), lane_elems, code,
                           _ck._stream(x))
    _ck._check_launch(lib, err, "fused_ln")
    if _ck.CAPTURE is not None:
        _ck.CAPTURE.add("fused_ln", _kc.fused_ln, R, D, x.element_size(),
                        residual is not None, bias_add is not None,
                        mask is not None, stats)
    return y, s, mu, rstd


def fused_ln_bwd_plain(sx, mu, rstd, scale, dy, dsx=None, mask=None,
                       inv_keep: float = 1.0):
    """The backward kernel's arithmetic in PyTorch ops. ``sx`` [R, D] is
    the forward's s (x for the plain form), ``inv_keep`` 1/keep in float32.
    Returns (ds in sx's dtype, dx = ds·mask·inv_keep in sx's dtype or None
    without a mask, dscale [D] float32, dbias [D] float32)."""
    xhat = (sx.float() - mu[:, None]) * rstd[:, None]
    dy32 = dy.float()
    g = dy32 * scale.float()
    gm = g.mean(-1, keepdim=True)
    gxm = (g * xhat).mean(-1, keepdim=True)
    ds = rstd[:, None] * (g - gm - xhat * gxm)
    if dsx is not None:
        ds = ds + dsx.float()
    dx = None if mask is None else (ds * mask.float() * inv_keep).to(
        sx.dtype)
    return ds.to(sx.dtype), dx, (dy32 * xhat).sum(0), dy32.sum(0)


def fused_ln_bwd(sx, mu, rstd, scale, dy, dsx=None, mask=None,
                 inv_keep: float = 1.0):
    """One launch of the backward kernel on the card (the plain version on
    CPU tensors); arguments and results as :func:`fused_ln_bwd_plain`. The
    kernel writes per-block partial sums of dscale and dbias, added here."""
    if not _ck._on_card(*(t for t in (sx, mu, rstd, scale, dy, dsx, mask)
                          if t is not None)):
        return fused_ln_bwd_plain(sx, mu, rstd, scale, dy, dsx, mask,
                                  inv_keep)
    _ck._require(sx.dim() == 2, f"fused_ln_bwd: sx must be [R, D], got "
                 f"{tuple(sx.shape)}")
    R, D = sx.shape
    code = _ck._dtype_code(sx, "fused_ln_bwd sx")
    dy = dy.contiguous()
    dsx = None if dsx is None else dsx.contiguous()
    for name, t in (("sx", sx), ("dy", dy), ("dsx", dsx)):
        if t is not None:
            _check_rows(f"fused_ln_bwd {name}", t, (R, D), sx.dtype)
    for name, t in (("mu", mu), ("rstd", rstd)):
        _check_rows(f"fused_ln_bwd {name}", t, (R,), torch.float32)
    _check_rows("fused_ln_bwd scale", scale, (D,), torch.float32)
    if mask is not None:
        _check_rows("fused_ln_bwd mask", mask, (R, D), torch.bool)
    lane_elems = ln_bwd_plan(D)
    ds = torch.empty_like(sx)
    dx = None if mask is None else torch.empty_like(sx)
    if R == 0:
        zero = torch.zeros(D, dtype=torch.float32, device=sx.device)
        return ds, dx, zero, zero.clone()
    blocks = ln_bwd_grid(R, lane_elems, _ck._num_sms(sx.device),
                         _bwd_blocks_per_sm(D, lane_elems, dsx is not None,
                                            mask is not None, code))
    # the blocks' partial rows, and their sums in a fixed order (the
    # kernel's second pass): dscale, dbias
    parts = torch.empty((2, blocks, D), dtype=torch.float32,
                        device=sx.device)
    dscale, dbias = torch.empty((2, D), dtype=torch.float32,
                                device=sx.device)
    lib = _ck._lib()
    err = lib.ptt_ln_bwd(sx.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                         scale.data_ptr(), dy.data_ptr(), _ptr(dsx),
                         _ptr(mask), ds.data_ptr(), _ptr(dx),
                         parts[0].data_ptr(), parts[1].data_ptr(),
                         dscale.data_ptr(), dbias.data_ptr(), R, D,
                         lane_elems, blocks, float(inv_keep), code,
                         _ck._stream(sx))
    _ck._check_launch(lib, err, "fused_ln_bwd")
    if _ck.CAPTURE is not None:
        _ck.CAPTURE.add("fused_ln_bwd", _kc.fused_ln_bwd, R, D,
                        sx.element_size(), dsx is not None, mask is not None)
    return ds, dx, dscale, dbias


@torch.library.custom_op("paddle_tpu_torch::fused_ln_fwd", mutates_args=())
def _fused_ln_fwd_op(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, residual: Optional[torch.Tensor],
                     bias_add: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], eps: float,
                     inv_keep: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    y, s, mu, rstd = fused_ln_fwd(x, scale, bias, residual, bias_add, mask,
                                  eps, inv_keep)
    # an op's outputs cannot be None: the plain form returns an empty s
    return y, (x.new_empty(0) if s is None else s), mu, rstd


# the forward as the dispatcher sees it (remat policies match on it)
FUSED_LN_FWD_OP = torch.ops.paddle_tpu_torch.fused_ln_fwd.default


class _FusedLN(torch.autograd.Function):
    """The ``_fused_ln`` custom_vjp: saves (s or x, mu, rstd, scale, mask);
    the backward launches the backward kernel once."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, bias_add, mask, eps: float,
                keep: float, return_residual: bool):
        y, s, mu, rstd = FUSED_LN_FWD_OP(x, scale, bias, residual, bias_add,
                                         mask, eps,
                                         _round_to(1.0 / keep, x.dtype))
        emit = residual is not None or bias_add is not None \
            or mask is not None
        ctx.save_for_backward(s if emit else x, mu, rstd, scale, mask)
        ctx.keep, ctx.return_residual = keep, return_residual
        ctx.dtypes = (None if residual is None else residual.dtype,
                      None if bias_add is None else bias_add.dtype,
                      bias.dtype)
        return (y, s) if return_residual else y

    @staticmethod
    def backward(ctx, dy, dsx=None):
        sx, mu, rstd, scale, mask = ctx.saved_tensors
        res_dt, badd_dt, bias_dt = ctx.dtypes
        ds, dx, dscale, dbias = fused_ln_bwd(
            sx, mu, rstd, scale, dy, dsx if ctx.return_residual else None,
            mask, _round_to(1.0 / ctx.keep, torch.float32))
        if dx is None:
            dx = ds
        dres = None if res_dt is None else ds.to(res_dt)
        # JAX sums ds in its own dtype (accumulating in float32)
        dbadd = None if badd_dt is None \
            else ds.float().sum(0).to(ds.dtype).to(badd_dt)
        return (dx, dscale.to(scale.dtype), dbias.to(bias_dt), dres, dbadd,
                None, None, None, None)


def fused_ln_masked(x, scale, bias, residual=None, bias_add=None, mask=None,
                    *, eps: float = 1e-5, keep: float = 1.0,
                    return_residual: bool = False):
    """:func:`fused_ln` with the dropout mask given: ``mask`` bool [..., D]
    (None = no dropout) keeps each element of ``x`` with probability
    ``keep`` and scales it by 1/keep."""
    d = x.shape[-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, d)
    r = x2.shape[0]
    res2 = None if residual is None else residual.reshape(r, d)
    badd = None if bias_add is None else bias_add.reshape(d)
    mask2 = None if mask is None else mask.reshape(r, d)
    tensors = [t for t in (x2, scale, bias, res2, badd) if t is not None]
    # without a graph to build (serving's decode tick) the kernel runs
    # directly: no autograd node, dispatcher op or statistics
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out = _FusedLN.apply(x2, scale, bias, res2, badd, mask2, float(eps),
                             float(keep), bool(return_residual))
        y, s = out if return_residual else (out, None)
    else:
        y, s, _mu, _rstd = fused_ln_fwd(
            x2, scale, bias, res2, badd, mask2, eps,
            _round_to(1.0 / keep, x.dtype), stats=False)
    if x2 is not x:
        y = y.reshape(x.shape)
        s = None if s is None else s.reshape(x.shape)
    return (y, s) if return_residual else y


def fused_ln(x, scale, bias, residual=None, bias_add=None, *,
             eps: float = 1e-5, dropout_rate: float = 0.0,
             dropout_key: Optional[torch.Generator] = None,
             return_residual: bool = False, block_rows: int = 128):
    """Fused layernorm(+residual+bias-add+dropout) block, as JAX's
    ``fused_ln``: ``s = dropout(x) + residual + bias_add`` in x's dtype,
    then a layernorm over the last axis with float32 statistics — one
    kernel launch forward and one backward on the card.

    x [..., D]; scale, bias [D] float32; residual [..., D] and bias_add
    [D] optional, in x's dtype; ``dropout_rate`` > 0 draws a keep mask
    from ``dropout_key`` (a ``torch.Generator`` on x's device). Returns
    ``y`` or, with ``return_residual``, ``(y, s)``. ``block_rows`` is kept
    for the JAX signature: the kernels pick their own row tiles, and no
    result depends on it."""
    del block_rows
    mask, keep = None, 1.0
    if dropout_rate:
        if dropout_key is None:
            raise ValueError("dropout_rate > 0 requires dropout_key")
        keep = 1.0 - float(dropout_rate)
        mask = torch.rand(x.shape, generator=dropout_key,
                          device=x.device) < keep
    return fused_ln_masked(x, scale, bias, residual, bias_add, mask, eps=eps,
                           keep=keep, return_residual=return_residual)
