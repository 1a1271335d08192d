"""The communication levers of the train step — the port of
``paddle_tpu/parallel/comm_opt.py:84-446``.

1. **Bucketed reduce-scatter** (:class:`BucketLayout`,
   :func:`reduce_scatter_flat`): grads are flat-concatenated by dtype into
   size-capped buckets, each reduced so every dp rank owns 1/dp of it; the
   optimizer runs on the shard and the updated params come back by
   :func:`all_gather_flat`. Gradient-reduction wire bytes halve against
   an all-reduce.
2. **Quantized collectives** (``comm_dtype="bf16"|"int8"``): chunk-scaled
   quantize, exchange by ``all_to_all``, dequantize and accumulate in
   float32; error feedback carries each rank's quantization residual into
   the next step.
3. **Wire-byte accounting** (:func:`record_collective`): every collective
   of this module and of ``parallelize`` adds its ring-model per-rank
   bytes to ``paddle_collective_bytes_total{op,dtype}`` and stamps the
   flight recorder's fingerprint stream. JAX counts and stamps once per
   trace; the port does both on every call, as it counts kernel
   launches.

The collectives are ``torch.distributed`` calls on a mesh line
(:class:`~.mesh.AxisGroup`).

4. **Overlap measurement** (:func:`measure_overlap_fraction`): how much
   of a ``torch.profiler`` capture's collective time compute overlaps —
   over NCCL's kernels on the device streams, or over the host ranges of
   the collectives a gloo group stages through host memory
   (``paddle_collective/<op>``, :func:`~.mesh._staged`); the arithmetic is
   :func:`overlap_fraction`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import flight as _flight
from ..observability import metrics as _obs_metrics
from .mesh import STAGED_RANGE, AxisGroup

__all__ = [
    "CommConfig", "BucketLayout", "Bucket", "build_bucket_layout",
    "flatten_bucket", "unflatten_bucket", "bucket_wd_mask",
    "normalize_comm_dtype", "record_collective", "wire_bytes",
    "quantize_chunked", "dequantize_chunked", "reduce_scatter_flat",
    "all_gather_flat", "quantized_allreduce", "quantized_reduce_scatter_op",
    "dtype_name", "overlap_fraction", "measure_overlap_fraction",
]

_m_wire_bytes = _obs_metrics.default_registry().counter(
    "paddle_collective_bytes_total",
    "Per-rank wire bytes of the collectives called (ring model, counted "
    "per call)", ("op", "dtype"))


def dtype_name(dtype) -> str:
    """numpy's name for a torch or numpy dtype ('float32', 'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def wire_bytes(op: str, payload_bytes: int, ranks: int) -> int:
    """Ring-model per-rank bytes for one collective of ``payload_bytes``
    global payload over ``ranks`` participants."""
    if ranks <= 1:
        return 0
    if op == "psum":                      # ring all-reduce: RS + AG legs
        return 2 * (ranks - 1) * payload_bytes // ranks
    if op in ("psum_scatter", "all_gather", "all_to_all"):
        return (ranks - 1) * payload_bytes // ranks
    if op == "ppermute":
        return payload_bytes
    raise ValueError(f"unknown collective op {op!r}")


def record_collective(op: str, dtype, payload_bytes: int,
                      ranks: int) -> int:
    """Count one collective into the wire-bytes counter and stamp the
    flight recorder's fingerprint stream (``flight.stamp_collective``);
    returns the per-rank ring bytes recorded. Every collective call of the
    port passes here once, so the stamps come per call — where the
    reference stamps each collective once, at trace time — in the same
    order on every rank."""
    b = wire_bytes(op, int(payload_bytes), int(ranks))
    if b:
        name = dtype_name(dtype)
        _m_wire_bytes.labels(op, name).inc(b)
        _flight.stamp_collective(op, name, payload_bytes, ranks)
    return b


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

_COMM_DTYPES = {
    None: None, "": None, "f32": None, "fp32": None, "float32": None,
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8",
}


def normalize_comm_dtype(name) -> Optional[str]:
    if name not in _COMM_DTYPES:
        raise ValueError(
            f"comm dtype {name!r}: expected one of f32/bf16/int8")
    return _COMM_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """The communication levers of one train step."""
    grad_reduce: str = "psum"            # "psum" | "reduce_scatter"
    comm_dtype: Optional[str] = None     # None(f32) | "bf16" | "int8"
    bucket_mb: float = 32.0              # per-bucket cap, MiB of grad bytes
    error_feedback: bool = False         # carry quantization residual
    quant_chunk: int = 256               # elements per int8 scale chunk
    pipeline_double_buffer: bool = True  # overlap the stage send

    def __post_init__(self):
        if self.grad_reduce not in ("psum", "reduce_scatter"):
            raise ValueError(
                f"grad_reduce {self.grad_reduce!r}: "
                "expected 'psum' or 'reduce_scatter'")
        object.__setattr__(
            self, "comm_dtype", normalize_comm_dtype(self.comm_dtype))
        if self.error_feedback and self.comm_dtype is None:
            raise ValueError("error_feedback requires a quantized comm_dtype")


# ---------------------------------------------------------------------------
# Bucket layout: flat concat by dtype, size-capped, padded for the group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bucket:
    """One flat comm bucket: contiguous concat of whole leaves (by
    tree-flatten order), zero-padded to ``size`` (a multiple of the
    reduce group size, and of the quant chunk when quantizing)."""
    dtype: str                       # numpy dtype name of the leaves
    entries: Tuple[Tuple[int, Tuple[int, ...], int], ...]  # (leaf_idx, shape, numel)
    size: int                        # padded flat length
    pad: int

    @property
    def nbytes(self) -> int:
        return self.size * _itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    buckets: Tuple[Bucket, ...]
    ranks: int                       # reduce-scatter group size
    total_len: int                   # sum of bucket sizes (padded)

    @property
    def shard_len(self) -> int:
        return self.total_len // self.ranks


def build_bucket_layout(shapes_dtypes: Sequence[Tuple[Tuple[int, ...], Any]],
                        ranks: int, cap_bytes: int,
                        pad_multiple: int = 1) -> BucketLayout:
    """Greedy size-capped bucketing of leaves (local shard shapes), grouped
    by dtype (numpy or torch). A leaf larger than the cap gets its own
    bucket — leaves are never split."""
    ranks = max(1, int(ranks))
    align = ranks * max(1, int(pad_multiple))
    by_dtype: Dict[str, List[Tuple[int, Tuple[int, ...], int]]] = {}
    for idx, (shape, dt) in enumerate(shapes_dtypes):
        numel = int(np.prod(shape)) if shape else 1
        by_dtype.setdefault(dtype_name(dt), []).append(
            (idx, tuple(shape), numel))

    buckets: List[Bucket] = []
    for dt_name in sorted(by_dtype):
        cur: List[Tuple[int, Tuple[int, ...], int]] = []
        cur_bytes = 0
        itemsize = _itemsize(dt_name)

        def flush():
            nonlocal cur, cur_bytes
            if not cur:
                return
            n = sum(e[2] for e in cur)
            size = -(-n // align) * align
            buckets.append(Bucket(dtype=dt_name, entries=tuple(cur),
                                  size=size, pad=size - n))
            cur, cur_bytes = [], 0

        for entry in by_dtype[dt_name]:
            if cur and cur_bytes + entry[2] * itemsize > cap_bytes:
                flush()
            cur.append(entry)
            cur_bytes += entry[2] * itemsize
        flush()
    total = sum(b.size for b in buckets)
    return BucketLayout(buckets=tuple(buckets), ranks=ranks, total_len=total)


def flatten_bucket(leaves: Sequence[torch.Tensor], bucket: Bucket,
                   dtype=torch.float32) -> torch.Tensor:
    """Concat the bucket's leaves (flattened, cast to ``dtype``) + pad."""
    parts = [leaves[i].to(dtype).reshape(-1) for i, _, _ in bucket.entries]
    if bucket.pad:
        parts.append(parts[0].new_zeros((bucket.pad,)))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def unflatten_bucket(vec: torch.Tensor, bucket: Bucket
                     ) -> Dict[int, torch.Tensor]:
    """Inverse of :func:`flatten_bucket`: {leaf_idx: view of leaf shape}
    (still in ``vec``'s dtype — the caller casts)."""
    out: Dict[int, torch.Tensor] = {}
    off = 0
    for idx, shape, numel in bucket.entries:
        out[idx] = vec[off:off + numel].view(shape)
        off += numel
    return out


def bucket_wd_mask(bucket: Bucket) -> np.ndarray:
    """Flat weight-decay mask for one bucket (1.0 on >=2-D leaves, no decay
    on biases and layernorm scales — ``parallelize._adamw_update``)."""
    parts = [np.full((numel,), 1.0 if len(shape) >= 2 else 0.0, np.float32)
             for _, shape, numel in bucket.entries]
    parts.append(np.zeros((bucket.pad,), np.float32))
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# Chunk-scaled quantization (EQuARX-style)
# ---------------------------------------------------------------------------

def quantize_chunked(x: torch.Tensor, comm_dtype: Optional[str], chunk: int):
    """float32 [n] -> (payload, scales | None). bf16 is a plain cast (no
    scales); int8 is chunk-scaled symmetric: per ``chunk`` elements one
    float32 scale = absmax / 127. ``n`` must be a chunk multiple for
    int8."""
    if comm_dtype is None:
        return x, None
    if comm_dtype == "bf16":
        return x.to(torch.bfloat16), None
    if comm_dtype != "int8":
        raise ValueError(f"bad comm dtype {comm_dtype!r}")
    xr = x.reshape(-1, chunk)
    scale = xr.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xr / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def dequantize_chunked(payload: torch.Tensor, scales, comm_dtype, chunk: int
                       ) -> torch.Tensor:
    """Inverse of :func:`quantize_chunked`, always float32 out."""
    if comm_dtype in (None, "bf16"):
        return payload.float()
    q = payload.reshape(-1, chunk).float()
    return (q * scales[:, None]).reshape(-1)


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

def reduce_scatter_flat(vec: torch.Tensor, axis: AxisGroup,
                        ccfg: CommConfig, record: bool = True):
    """Reduce ``vec`` (float32, length divisible by the group size — and
    by size·quant_chunk for int8) over ``axis``; each rank keeps its
    1/size shard, reduced in float32.

    float32 comm is one ``reduce_scatter_tensor``. Quantized comm
    quantizes the local vector chunk-scaled, exchanges the shards by
    ``all_to_all`` (payload in comm_dtype, (ranks-1)/ranks of it on the
    wire) and sums the dequantized shards locally in float32, in rank
    order.

    Returns ``(shard, new_residual)``: ``new_residual`` is the local
    quantization error when ``ccfg.error_feedback`` (the caller adds the
    incoming residual to ``vec`` before the call), else None."""
    ranks = axis.size
    n = vec.shape[0]
    if ccfg.comm_dtype is None:
        if record:
            record_collective("psum_scatter", torch.float32, n * 4, ranks)
        return axis.reduce_scatter(vec), None

    payload, scales = quantize_chunked(vec, ccfg.comm_dtype, ccfg.quant_chunk)
    new_residual = None
    if ccfg.error_feedback:
        new_residual = vec - dequantize_chunked(
            payload, scales, ccfg.comm_dtype, ccfg.quant_chunk)
    if ranks == 1:
        return dequantize_chunked(payload, scales, ccfg.comm_dtype,
                                  ccfg.quant_chunk), new_residual

    if record:
        record_collective("all_to_all", payload.dtype,
                          n * payload.element_size(), ranks)
    rows = axis.all_to_all(payload).reshape(ranks, n // ranks)
    if scales is not None:
        if record:
            record_collective("all_to_all", torch.float32,
                              scales.numel() * 4, ranks)
        srows = axis.all_to_all(scales).reshape(ranks, -1)
        deq = torch.stack([dequantize_chunked(p, s, ccfg.comm_dtype,
                                              ccfg.quant_chunk)
                           for p, s in zip(rows, srows)])
    else:
        deq = rows.float()
    return deq.sum(dim=0), new_residual


def all_gather_flat(shard: torch.Tensor, axis: AxisGroup,
                    record: bool = True) -> torch.Tensor:
    """Gather per-rank shards back into the full flat vector."""
    if axis.size == 1:
        return shard
    if record:
        record_collective("all_gather", shard.dtype,
                          shard.numel() * shard.element_size() * axis.size,
                          axis.size)
    return axis.all_gather(shard)


def _pad_to(vec: torch.Tensor, multiple: int):
    pad = (-vec.shape[0]) % multiple
    if pad:
        vec = torch.cat([vec, vec.new_zeros((pad,))])
    return vec, pad


def quantized_allreduce(x: torch.Tensor, axis: AxisGroup, comm_dtype,
                        quant_chunk: int = 256, mean: bool = False,
                        record: bool = True) -> torch.Tensor:
    """All-reduce with the wire payload in ``comm_dtype`` and float32
    accumulation: quantized reduce-scatter leg, requantize the reduced
    shard, quantized all-gather leg. Any shape; returns a new tensor of
    ``x``'s dtype (``x`` is not modified)."""
    cd = normalize_comm_dtype(comm_dtype)
    ranks = axis.size
    if cd is None or ranks == 1:
        if record:
            record_collective("psum", x.dtype, x.numel() * x.element_size(),
                              ranks)
        out = axis.all_reduce(x.clone())
        return out / ranks if mean else out
    ccfg = CommConfig(comm_dtype=cd, quant_chunk=quant_chunk)
    n = x.numel()
    flat, _ = _pad_to(x.float().reshape(-1), ranks * quant_chunk)
    shard, _ = reduce_scatter_flat(flat, axis, ccfg, record=record)
    if mean:
        shard = shard / ranks
    # requantize the reduced shard for the gather leg (fresh scales: the
    # sum's range grew by up to ranks x)
    shard, _ = _pad_to(shard, quant_chunk)
    payload, scales = quantize_chunked(shard, cd, quant_chunk)
    full_q = all_gather_flat(payload, axis, record=record)
    full_s = (all_gather_flat(scales, axis, record=record)
              if scales is not None else None)
    full = dequantize_chunked(full_q, full_s, cd, quant_chunk)
    return full[:n].reshape(x.shape).to(x.dtype)


def quantized_reduce_scatter_op(x: torch.Tensor, axis: AxisGroup,
                                comm_dtype, quant_chunk: int = 256,
                                record: bool = True) -> torch.Tensor:
    """c_reducescatter semantics ([ranks·k, ...] -> [k, ...] reduced
    shard) with a quantized wire payload and float32 accumulation."""
    cd = normalize_comm_dtype(comm_dtype)
    ranks = axis.size
    if cd is None or ranks == 1:
        if record:
            record_collective("psum_scatter", x.dtype,
                              x.numel() * x.element_size(), ranks)
        return axis.reduce_scatter(x)
    shard_shape = (x.shape[0] // ranks,) + tuple(x.shape[1:])
    row = int(np.prod(shard_shape)) if shard_shape else 1
    # chunk-align every rank's row so shard boundaries stay chunk boundaries
    row_pad = (-row) % quant_chunk
    flat = x.float().reshape(ranks, row)
    if row_pad:
        flat = torch.cat([flat, flat.new_zeros((ranks, row_pad))], dim=1)
    ccfg = CommConfig(comm_dtype=cd, quant_chunk=quant_chunk)
    shard, _ = reduce_scatter_flat(flat.reshape(-1), axis, ccfg,
                                   record=record)
    return shard[:row].reshape(shard_shape).to(x.dtype)


# ---------------------------------------------------------------------------
# overlap measurement (the reference's comm_opt.py:456-542)
# ---------------------------------------------------------------------------

def _merge_intervals(iv: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    iv = sorted(iv)
    out: List[Tuple[float, float]] = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersect_total(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_fraction(coll: List[Tuple[float, float]],
                     comp: List[Tuple[float, float]], source: str
                     ) -> Optional[Dict[str, Any]]:
    """The share of the collectives' time (``coll``, ns intervals) that
    compute (``comp``) overlaps: {overlap_fraction, collective_ms,
    exposed_ms, compute_ms, source}; None without a collective."""
    if not coll:
        return None
    coll_m = _merge_intervals(coll)
    comp_m = _merge_intervals(comp)
    coll_total = sum(e - s for s, e in coll_m)
    overlapped = _intersect_total(coll_m, comp_m)
    return {
        "overlap_fraction": overlapped / coll_total if coll_total else 0.0,
        "collective_ms": coll_total / 1e6,
        "exposed_ms": (coll_total - overlapped) / 1e6,
        "compute_ms": sum(e - s for s, e in comp_m) / 1e6,
        "source": source,
    }


def measure_overlap_fraction(trace_dir: str) -> Optional[Dict[str, Any]]:
    """Read the newest ``torch.profiler`` capture under ``trace_dir`` and
    measure how much collective time compute overlaps.

    ``source: "device_streams"``: NCCL's kernels are the collectives and
    every other kernel, memcpy and memset of the device streams is
    compute. ``source: "gloo_staged"``: the collectives are the host
    ranges of the staged ones (``paddle_collective/<op>``, which hold the
    device synchronise, the copies and the exchange); compute is the
    device streams' work, or on the CPU the host ops outside those
    ranges. None when the capture holds no collective (or no capture
    exists)."""
    from ..utils.device_trace import _cpu_scopes
    from ..utils.profile_data import ProfileData, latest_trace

    path = latest_trace(trace_dir)
    if path is None:
        return None
    pd = ProfileData.from_file(path)
    work: List[Tuple[float, float, str]] = [
        (ev.start_ns, ev.end_ns, ev.name) for plane in pd.device_planes()
        for line in plane.lines for ev in line.events
        if ev.stat("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
        and ev.duration_ns > 0]
    nccl = [(s, e) for s, e, n in work if "nccl" in n.lower()]
    if nccl:
        comp = [(s, e) for s, e, n in work if "nccl" not in n.lower()]
        return overlap_fraction(nccl, comp, "device_streams")
    host = pd.host_plane()
    if host is None:
        return None
    coll: List[Tuple[float, float]] = []
    cpu_comp: List[Tuple[float, float]] = []
    for line in host.lines:
        scopes = _cpu_scopes(line.events)
        for ev in line.events:
            if ev.duration_ns <= 0:
                continue
            if ev.stat("cat") == "user_annotation" and ev.name.startswith(
                    STAGED_RANGE):
                coll.append((ev.start_ns, ev.end_ns))
            elif ev.stat("cat") == "cpu_op" and not any(
                    s.name.startswith(STAGED_RANGE)
                    for s in scopes.get(id(ev), ())):
                cpu_comp.append((ev.start_ns, ev.end_ns))
    comp = [(s, e) for s, e, _n in work] if work else cpu_comp
    return overlap_fraction(coll, comp, "gloo_staged")
