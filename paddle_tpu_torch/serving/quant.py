"""Serving weights in fewer bytes: int8 and bf16 storage for the decode
engine — the port of ``paddle_tpu/serving/quant.py``.

int8 storage per floating leaf: the leaf is flattened, zero-padded to a
whole number of chunks and quantized symmetric per chunk — an ``int8 [n]``
payload and ``float32 [n / chunk]`` scales (absmax / 127 a chunk, round
half to even, clipped to +-127), a 3.97x cut of the float32 bytes at
chunk 256. bf16 is a plain cast. The chunk-scaled pair
(:func:`quantize_chunked` / :func:`dequantize_chunked`) is the port's own
copy of the int8 half of ``paddle_tpu/parallel/comm_opt.py:266-291``.

The engine keeps only payloads and scales on the card and dequantizes
one layer's leaves at a time, for the time that layer runs
(``serving/engine.py``), as the reference dequantizes inside its jitted
functions. The quality bars of the reference hold: int8 decode logits
within :data:`INT8_LOGIT_TOL` of the float32 engine's (max |d logit| over
the row's max |logit|, worst row) and perplexity within
:data:`INT8_PPL_REL_TOL` over a token stream.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = [
    "QuantizedLeaf", "quantize_chunked", "dequantize_chunked",
    "quantize_params", "dequantize_params", "quantized_nbytes",
    "logit_error_stats", "perplexity", "INT8_LOGIT_TOL",
    "INT8_PPL_REL_TOL", "WEIGHT_DTYPES",
]

WEIGHT_DTYPES = ("f32", "bf16", "int8")

# max |logit_int8 - logit_f32| / (max |logit_f32| over the row), worst row
INT8_LOGIT_TOL = 0.06
# relative perplexity drift |ppl_q / ppl_f32 - 1| over the eval stream
INT8_PPL_REL_TOL = 0.02


def quantize_chunked(x: torch.Tensor, chunk: int):
    """float32 [n] -> (int8 payload [n], float32 scales [n / chunk]):
    chunk-scaled symmetric, one scale = absmax / 127 a ``chunk`` elements
    (1 for an all-zero chunk); ``n`` must be a whole number of chunks."""
    xr = x.reshape(-1, chunk)
    scale = xr.abs().amax(1, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xr / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def dequantize_chunked(payload: torch.Tensor, scales: torch.Tensor,
                       chunk: int, dtype=torch.float32) -> torch.Tensor:
    """The inverse of :func:`quantize_chunked`: one product of the payload
    and the scales, computed in float32 and written in ``dtype`` (float32,
    or the float32 values rounded once)."""
    q = payload.view(-1, chunk)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    torch.mul(q, scales[:, None], out=out)
    return out.view(-1)


class QuantizedLeaf:
    """One int8 parameter leaf: payload, scales and the leaf's shape."""

    __slots__ = ("payload", "scales", "shape", "pad", "chunk")

    def __init__(self, payload, scales, shape, pad: int, chunk: int):
        self.payload = payload        # int8 [numel + pad]
        self.scales = scales          # float32 [(numel + pad) / chunk]
        self.shape = tuple(shape)
        self.pad = int(pad)
        self.chunk = int(chunk)

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return (self.payload.numel() * self.payload.element_size()
                + self.scales.numel() * self.scales.element_size())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """The whole leaf in its shape: float32, or the float32 values
        rounded once to ``dtype``."""
        return self.dequantize_range(0, self.numel, dtype).reshape(
            self.shape)

    def dequantize_range(self, start: int, n: int,
                         dtype=torch.float32) -> torch.Tensor:
        """Flat elements [start, start + n): only the chunks that hold
        them are dequantized, by one product of the int8 payload and the
        float32 scales (computed in float32, written in ``dtype``: the
        float32 dequantization rounded once, as the reference's
        ``.astype``)."""
        c = self.chunk
        c0, c1 = start // c, -(-(start + n) // c)
        flat = dequantize_chunked(self.payload[c0 * c:c1 * c],
                                  self.scales[c0:c1], c, dtype)
        return flat[start - c0 * c:start - c0 * c + n]

    def layer(self, i: int, dtype=torch.float32) -> torch.Tensor:
        """Slice ``i`` of a leaf stacked on its first axis ([L, ...]) in
        the slice's shape (``dtype`` as :meth:`dequantize_range`)."""
        per = self.numel // self.shape[0]
        return self.dequantize_range(i * per, per, dtype).reshape(
            self.shape[1:])

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of a 2-D leaf [R, D], float32 [..., D]. With D a
        whole number of chunks only the gathered rows' chunks are
        dequantized; otherwise the whole leaf is. The values are the
        same."""
        R, D = self.shape
        if D % self.chunk:
            return self.dequantize()[idx]
        q = self.payload[:R * D].view(R, D)[idx]
        s = self.scales[:R * D // self.chunk].view(R, D // self.chunk)[idx]
        return (q.view(*q.shape[:-1], D // self.chunk, self.chunk)
                * s[..., None]).reshape(q.shape)


def _quantize_leaf(leaf: torch.Tensor, chunk: int) -> QuantizedLeaf:
    flat = leaf.float().reshape(-1)
    pad = (-flat.shape[0]) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    payload, scales = quantize_chunked(flat, chunk)
    return QuantizedLeaf(payload, scales, leaf.shape, pad, chunk)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quantize_params(params, weight_dtype: str, chunk: int = 256):
    """float32 parameter tree -> serving storage tree: "f32" unchanged,
    "bf16" floating leaves cast to bf16, "int8" every floating leaf a
    :class:`QuantizedLeaf` (integer leaves pass through)."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype {weight_dtype!r}: expected one of "
                         f"{WEIGHT_DTYPES}")
    if weight_dtype == "f32":
        return params
    if weight_dtype == "bf16":
        return _tree_map(lambda x: x.to(torch.bfloat16)
                         if x.is_floating_point() else x, params)
    return _tree_map(lambda x: _quantize_leaf(x, chunk)
                     if x.is_floating_point() else x, params)


def dequantize_params(qparams):
    """Serving storage tree -> float32 tree (bf16 leaves widened)."""
    return _tree_map(
        lambda x: x.dequantize() if isinstance(x, QuantizedLeaf)
        else (x.float() if x.dtype == torch.bfloat16 else x), qparams)


def quantized_nbytes(qparams) -> int:
    """Bytes of the serving weight set (payloads and scales for int8)."""
    return sum(x.nbytes if isinstance(x, QuantizedLeaf)
               else x.numel() * x.element_size() for x in _leaves(qparams))


def logit_error_stats(ref_logits, q_logits) -> Dict[str, float]:
    """Quality of quantized against reference logits [..., V]: max and
    mean absolute error, the spread-relative max error (the
    :data:`INT8_LOGIT_TOL` bar) and top-1 agreement."""
    ref = np.asarray(ref_logits, np.float64)
    q = np.asarray(q_logits, np.float64)
    if ref.shape != q.shape:
        raise ValueError(f"shape mismatch {ref.shape} vs {q.shape}")
    err = np.abs(ref - q)
    rows = ref.reshape(-1, ref.shape[-1])
    qrows = q.reshape(-1, q.shape[-1])
    spread = np.max(np.abs(rows), axis=1)
    spread = np.where(spread > 0, spread, 1.0)
    rel = np.max(err.reshape(rows.shape), axis=1) / spread
    return {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "max_rel_err": float(rel.max()),
        "top1_agreement": float(
            np.mean(rows.argmax(1) == qrows.argmax(1))),
    }


def perplexity(logits, labels) -> float:
    """Token perplexity of next-token logits [N, V] against labels [N]."""
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels).reshape(-1)
    lse = np.log(np.sum(np.exp(logits - logits.max(-1, keepdims=True)),
                        axis=-1)) + logits.max(-1)
    gold = logits[np.arange(len(labels)), labels]
    return float(np.exp(np.mean(lse - gold)))

