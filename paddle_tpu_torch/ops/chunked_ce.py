"""Vocab-chunked cross-entropy fused with the vocab projection — the port
of ``paddle_tpu/ops/pallas_kernels.py:481-777`` (``_ce_chunk_logits``,
``_ce_fwd_lax``, ``_ce_fwd_kernel``, the ``_chunked_ce`` custom_vjp and
``chunked_lm_loss``).

``chunked_softmax_ce_from_logits`` is the port of
``pallas_kernels.py:788-845``: the CE over logits that already exist
(``softmax_with_cross_entropy(vocab_chunk=)``), an online-logsumexp
chunk loop forward and a chunk loop writing dLogits backward, so the
float32 softmax never materialises at [rows, V]. The reference's is a
``lax.scan`` under ``custom_vjp``, not a Pallas kernel: plain torch ops
are its port.

The forward statistics (per-row logsumexp and gold logit) are one
hand-written kernel on the card, :func:`ce_fwd` (``ops/csrc/ce_fwd.cu``),
beside its plain version :func:`ce_fwd_plain`, the online-logsumexp sweep
over vocab chunks. As in ``ops/cuda_kernels.py``, CPU tensors take the
plain version and CUDA tensors launch the kernel or raise. The backward is
the reference's chunk sweep in plain PyTorch (JAX leaves it to XLA): each
chunk's logits are recomputed from (x, head, lse), so no more than
``[row_chunk, vocab_chunk]`` logits are live at once.
"""
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_kernels as _ck
from . import kernel_costs as _kc

__all__ = ["chunked_lm_loss", "ce_fwd", "ce_fwd_plain", "ce_chunk_logits",
           "ce_fwd_plan", "chunked_softmax_ce_from_logits", "CE_BWD_RANGE"]

_NEG_INF = -0.7 * float(np.finfo(np.float32).max)
_LAYOUTS = ("dv", "vd")
_BM = 128               # rows of a block of the kernel (ops/csrc/ce_fwd.cu)
_BN = {2: 256, 4: 128}  # vocab columns of one of its tiles, by element size
CE_BWD_RANGE = "chunked_ce_bwd"   # the profiler range of the backward sweep


def _head_width(head, layout: str) -> int:
    return head.shape[1] if layout == "dv" else head.shape[0]


def ce_chunk_logits(x, head, bias, i: int, v_chunk: int, vocab: int,
                    layout: str):
    """Logits of vocab chunk ``i`` in float32 (products accumulated in
    float32 from the operands' values; ``x`` float32), columns >=
    ``vocab`` masked to a large negative; returns (logits [n, v_chunk],
    columns, head chunk)."""
    lo = i * v_chunk
    if layout == "dv":
        h = head[:, lo:lo + v_chunk]
        lg = torch.matmul(x, h.float())
    else:
        h = head[lo:lo + v_chunk]
        lg = torch.matmul(x, h.float().t())
    if bias is not None:
        lg = lg + bias[lo:lo + v_chunk].float()
    col = lo + torch.arange(v_chunk, device=x.device)
    lg = torch.where(col[None, :] < vocab, lg, _NEG_INF)
    return lg, col, h


def ce_fwd_plain(x, head, bias, labels, v_chunk: int, vocab: int,
                 layout: str = "dv"):
    """(lse, gold) float32 [n] by the online-logsumexp sweep over vocab
    chunks (``_ce_fwd_lax``); the head's width must be a multiple of
    ``v_chunk``."""
    n = x.shape[0]
    m = torch.full((n,), -float("inf"), dtype=torch.float32, device=x.device)
    s = torch.zeros((n,), dtype=torch.float32, device=x.device)
    gold = torch.zeros((n,), dtype=torch.float32, device=x.device)
    labels = labels.long()
    x32 = x.float()
    for i in range(_head_width(head, layout) // v_chunk):
        lg, col, _h = ce_chunk_logits(x32, head, bias, i, v_chunk, vocab,
                                      layout)
        m_new = torch.maximum(m, lg.amax(1))
        s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[:, None]).sum(1)
        gold = gold + torch.where(col[None, :] == labels[:, None], lg,
                                  0.0).sum(1)
        m = m_new
    return m + torch.log(s), gold


def ce_fwd_plan(n: int, vp: int, esz: int, sms: int = 132) -> dict:
    """The CE kernel's launch plan for ``n`` rows against ``vp`` head
    columns of ``esz``-byte elements on a card of ``sms`` SMs: ``bn``
    columns a vocab tile (256 at bf16, 128 at float32), ``row_tiles``
    blocks of 128 rows, and the vocab cut into ``nsplit`` ranges of
    ``tiles_per_split`` tiles, none empty, so that row_tiles x nsplit
    blocks (one an SM: the kernel's shared memory and registers) make
    about one wave; the row tile is the grid's fast axis. Any D."""
    bn = _BN[esz]
    row_tiles, vtiles = -(-n // _BM), -(-vp // bn)
    nsplit = max(1, min(vtiles, sms // row_tiles))
    per = -(-vtiles // nsplit)
    return {"bn": bn, "row_tiles": row_tiles, "nsplit": -(-vtiles // per),
            "tiles_per_split": per}


def ce_fwd(x, head, bias, labels, v_chunk: int, vocab: int,
           layout: str = "dv"):
    """(lse, gold) float32 [n] for rows ``x`` [n, D] against ``head``
    ("dv": [D, Vp]; "vd": [Vp, D]) with optional ``bias`` [Vp] and int
    ``labels`` [n] in [0, vocab) — one launch of the kernel on the card
    (the plain sweep on CPU tensors). The kernel walks its own vocab tiles
    (:func:`ce_fwd_plan`), masks columns >= ``vocab`` and reads the head
    through its row stride (any D, any stride); ``v_chunk`` is the plain
    sweep's chunk, and only float32 summation order depends on it."""
    if layout not in _LAYOUTS:
        raise ValueError(f"head layout {layout!r} not in {_LAYOUTS}")
    if not _ck._on_card(*(t for t in (x, head, bias, labels)
                          if t is not None)):
        return ce_fwd_plain(x, head, bias, labels, v_chunk, vocab, layout)
    _ck._require(x.dim() == 2 and head.dim() == 2,
                 f"ce_fwd: x [n, D] and a 2-D head expected, got "
                 f"{tuple(x.shape)} and {tuple(head.shape)}")
    n, D = x.shape
    code = _ck._dtype_code(x, "ce_fwd x")
    _ck._require(head.dtype == x.dtype, "ce_fwd: head must be in x's dtype")
    vp = _head_width(head, layout)
    depth = head.shape[0] if layout == "dv" else head.shape[1]
    _ck._require(depth == D, f"ce_fwd: head {tuple(head.shape)} does not "
                 f"match D={D} in layout {layout!r}")
    _ck._require(0 < vocab <= vp, f"ce_fwd: vocab {vocab} outside 1..{vp}")
    _ck._require(x.is_contiguous() and head.stride(1) == 1,
                 "ce_fwd: x must be contiguous and the head's rows "
                 "unit-stride")
    ldh = head.stride(0) if head.shape[0] > 1 else head.shape[1]
    _ck._require(tuple(labels.shape) == (n,),
                 f"ce_fwd: labels must be [{n}], got {tuple(labels.shape)}")
    labels = labels.to(torch.int32).contiguous()
    if bias is not None:
        _ck._require(tuple(bias.shape) == (vp,),
                     f"ce_fwd: bias must be [{vp}], got {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    gold = torch.empty_like(lse)
    if n == 0:
        return lse, gold
    plan = ce_fwd_plan(n, vp, x.element_size(), _ck._num_sms(x.device))
    nsplit = plan["nsplit"]
    scratch = torch.empty(3 * nsplit * n, dtype=torch.float32,
                          device=x.device)
    lib = _ck._lib()
    err = lib.ptt_ce_fwd(x.data_ptr(), head.data_ptr(),
                         None if bias is None else bias.data_ptr(),
                         labels.data_ptr(), lse.data_ptr(), gold.data_ptr(),
                         scratch.data_ptr(), n, D, vp, ldh, int(vocab),
                         int(layout == "vd"), nsplit, plan["bn"], code,
                         _ck._stream(x))
    _ck._check_launch(lib, err, "ce_fwd")
    if _ck.CAPTURE is not None:
        _ck.CAPTURE.add("ce_fwd", _kc.ce_fwd, n, D, int(vocab),
                        x.element_size(), bias is not None)
    return lse, gold


class _ChunkedCE(torch.autograd.Function):
    """The ``_chunked_ce`` custom_vjp: per-row CE [n] float32 from rows
    ``x`` [n, D] and the (padded) head; saves (x, head, bias, labels,
    valid, lse) and recomputes each chunk's logits in the backward."""

    @staticmethod
    def forward(ctx, x, head, bias, labels, valid, v_chunk: int, vocab: int,
                layout: str, use_pallas: Optional[bool]):
        fwd = ce_fwd_plain if use_pallas is False else ce_fwd
        lse, gold = fwd(x, head, bias, labels, v_chunk, vocab, layout)
        ce = lse - gold
        if valid is not None:
            ce = torch.where(valid, ce, 0.0)
        ctx.save_for_backward(x, head, bias, labels, valid, lse)
        ctx.v_chunk, ctx.vocab, ctx.layout = v_chunk, vocab, layout
        return ce

    @staticmethod
    def backward(ctx, ct):
        # a named range, so a trace can add up the sweep's kernels
        with torch.profiler.record_function(CE_BWD_RANGE):
            return _ChunkedCE._sweep(ctx, ct)

    @staticmethod
    def _sweep(ctx, ct):
        x, head, bias, labels, valid, lse = ctx.saved_tensors
        v_chunk, vocab, layout = ctx.v_chunk, ctx.vocab, ctx.layout
        n, d = x.shape
        vp = _head_width(head, layout)
        g = ct.float()
        if valid is not None:
            g = torch.where(valid, g, 0.0)
        x32 = x.float()
        dx = torch.zeros((n, d), dtype=torch.float32, device=x.device)
        dhead = torch.zeros(tuple(head.shape), dtype=torch.float32,
                            device=x.device)
        dbias = None if bias is None else torch.zeros(
            (vp,), dtype=torch.float32, device=x.device)
        labels = labels.long()
        for i in range(vp // v_chunk):
            lo = i * v_chunk
            lg, col, h = ce_chunk_logits(x32, head, bias, i, v_chunk, vocab,
                                         layout)
            p = torch.exp(lg - lse[:, None])          # masked columns -> 0
            onehot = (col[None, :] == labels[:, None]).float()
            dl = (p - onehot) * g[:, None]
            if layout == "dv":
                dx = dx + torch.matmul(dl, h.float().t())
                dhead[:, lo:lo + v_chunk] = torch.matmul(x32.t(), dl)
            else:
                dx = dx + torch.matmul(dl, h.float())
                dhead[lo:lo + v_chunk] = torch.matmul(dl.t(), x32)
            if bias is not None:
                dbias[lo:lo + v_chunk] = dl.sum(0)
        return (dx.to(x.dtype), dhead.to(head.dtype),
                None if bias is None else dbias.to(bias.dtype), None, None,
                None, None, None, None)


def chunked_lm_loss(x, head, labels, bias=None, valid=None,
                    vocab_chunk: int = 1024, row_chunk: int = 0,
                    head_layout: str = "dv",
                    use_pallas: Optional[bool] = None):
    """Summed token cross-entropy from hidden states, fused with the vocab
    projection and blocked over rows and vocab, as JAX's
    ``chunked_lm_loss``.

    ``x`` [..., D]; ``head`` [D, V] (``head_layout="dv"``) or a tied
    embedding table [V, D] (``"vd"``); ``labels`` int [...] matching x's
    leading dims, clipped to [0, V); ``bias`` optional [V]; ``valid``
    optional bool [...] masks rows out of the sum. The vocab pads to a
    multiple of ``vocab_chunk`` (masked columns), the rows to a multiple of
    ``row_chunk`` (masked rows); the row chunks' sums are added in order.

    ``use_pallas``: None or True = the forward kernel on the card (its
    plain sweep on CPU tensors); False = the plain sweep on any device.
    """
    if head_layout not in _LAYOUTS:
        raise ValueError(f"head_layout {head_layout!r} not in {_LAYOUTS}")
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    labs = labels.reshape(-1).long()
    n = rows.shape[0]
    v = _head_width(head, head_layout)
    labs = labs.clamp(0, v - 1)
    vmask = None if valid is None else valid.reshape(-1)
    vc = max(1, min(int(vocab_chunk) or v, v))
    pad_v = (-v) % vc
    if pad_v:
        head = F.pad(head, (0, pad_v) if head_layout == "dv"
                     else (0, 0, 0, pad_v))
        if bias is not None:
            bias = F.pad(bias, (0, pad_v))
    rc = max(1, min(int(row_chunk) or n, n))
    pad_r = (-n) % rc
    if pad_r:
        rows = torch.cat([rows, rows.new_zeros((pad_r, d))])
        labs = torch.cat([labs, labs.new_zeros((pad_r,))])
        vmask = torch.cat([
            torch.ones((n,), dtype=torch.bool, device=rows.device)
            if vmask is None else vmask,
            torch.zeros((pad_r,), dtype=torch.bool, device=rows.device)])
    total = torch.zeros((), dtype=torch.float32, device=rows.device)
    for j in range(0, n + pad_r, rc):
        vm = None if vmask is None else vmask[j:j + rc]
        ce = _ChunkedCE.apply(rows[j:j + rc], head, bias, labs[j:j + rc], vm,
                              vc, v, head_layout, use_pallas)
        total = total + ce.sum()
    return total


class _LogitsCE(torch.autograd.Function):
    """The ``chunked_softmax_ce_from_logits`` custom_vjp: per-row CE [n]
    float32 of logits [n, V] (V a multiple of ``v_chunk``: pad with -inf
    columns), labels int [n] in [0, V). Saves (logits, labels, lse); the
    backward recomputes each chunk's softmax from them."""

    @staticmethod
    def forward(ctx, logits, labels, v_chunk: int):
        n, vp = logits.shape
        labels = labels.long()
        m = torch.full((n,), -float("inf"), dtype=torch.float32,
                       device=logits.device)
        s = torch.zeros((n,), dtype=torch.float32, device=logits.device)
        gold = torch.zeros((n,), dtype=torch.float32, device=logits.device)
        for i in range(vp // v_chunk):
            lo = i * v_chunk
            lg = logits[:, lo:lo + v_chunk].float()
            col = lo + torch.arange(v_chunk, device=logits.device)
            m_new = torch.maximum(m, lg.amax(1))
            s = s * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(1)
            gold = gold + torch.where(col[None, :] == labels[:, None], lg,
                                      0.0).sum(1)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(logits, labels, lse)
        ctx.v_chunk = v_chunk
        return lse - gold

    @staticmethod
    def backward(ctx, ct):
        logits, labels, lse = ctx.saved_tensors
        v_chunk = ctx.v_chunk
        g = ct.float()
        dlogits = torch.zeros_like(logits)
        for i in range(logits.shape[1] // v_chunk):
            lo = i * v_chunk
            lg = logits[:, lo:lo + v_chunk].float()
            col = lo + torch.arange(v_chunk, device=logits.device)
            p = torch.exp(lg - lse[:, None])
            onehot = (col[None, :] == labels[:, None]).float()
            dlogits[:, lo:lo + v_chunk] = ((p - onehot) * g[:, None]).to(
                logits.dtype)
        return dlogits, None, None


def chunked_softmax_ce_from_logits(logits, labels, v_chunk: int):
    """Per-row CE [n] float32 for logits [n, V], blockwise over ``v_chunk``
    columns (V divisible by ``v_chunk``; pad with -inf columns otherwise),
    labels int [n] in [0, V): the loss and its Logits gradient with no
    [n, V] float32 intermediate."""
    return _LogitsCE.apply(logits, labels, int(v_chunk))
