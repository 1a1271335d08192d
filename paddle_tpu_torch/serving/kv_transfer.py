"""KV handoff between serving replicas — the port of
``paddle_tpu/serving/kv_transfer.py``.

Disaggregated serving migrates a request from its PREFILL replica to a
DECODE replica at the first-token boundary. What moves is the request's KV
cache state: the live pages of its page table (paged engines) or its valid
slab rows (slab engines), in fixed-size chunks, each chunk a pair of
CRC-stamped frames (K, V), behind the source cache's fingerprint and ahead
of an explicit commit. The channel is either a handoff dict passed within
one process, its JSON form (base64 payloads), or a length-prefixed frame
stream over a TCP socket (:class:`KVTransferServer` / :func:`send_handoff`).

The wire is the reference's, byte for byte: a frame's payload is the
chunk's C-order element bytes and its ``dtype`` the element type's name.
numpy has no bfloat16, so the port carries a bf16 chunk as its raw 2-byte
words (``Tensor.view(torch.uint8)`` out, ``torch.frombuffer`` in) and names
it ``"bfloat16"`` in the frame and in the fingerprint, as the reference's
``ml_dtypes`` arrays do. A handoff crosses between the two packages either
way.

A tp source splits each chunk along the head axis into one frame a shard
(a tp engine's rank r's heads are frame ``shard=r``); the receiver merges
a chunk's frames back before writing it, so any number of shards adopts
into any tp (a tp receiver's cache scatters the merged chunk to its
ranks: ``serving/tp.py``). :class:`TransferStats` asserts in the path that
the transient host copies stay within the chunk budget — never the whole
cache — and records the transfer's wall time, the CRC's share and the
device copies' share; :func:`transfer_history` keeps every finished
transfer's stats and :func:`summarize_stats` sums them up by kind.

A receiver refuses a handoff whose fingerprint differs from its own cache's
with a :class:`CacheConfigMismatch` that names every differing field.
"""
from __future__ import annotations

import collections
import itertools
import json
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import spans as _spans
from . import metrics as smetrics
from .kv_cache import CacheFullError

__all__ = [
    "CacheConfigMismatch", "TransferStats", "cache_fingerprint",
    "fingerprint_mismatch", "export_slot", "adopt_into_engine",
    "adopt_prefix", "export_prefix", "iter_frames", "KVTransferServer",
    "send_handoff", "last_stats", "transfer_history", "summarize_stats",
    "handoff_to_jsonable",
    "handoff_from_jsonable",
    "DEFAULT_CHUNK_PAGES", "DEFAULT_CHUNK_ROWS",
]

# chunk sizes of the staged transfer: small enough that the transient
# host copies are pages, not pools; large enough that the per-chunk host
# round trip amortizes
DEFAULT_CHUNK_PAGES = 4
DEFAULT_CHUNK_ROWS = 64

_transfer_ids = itertools.count(1)

# the element types a frame may carry, by the name the reference writes
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def _dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a cache dtype: ``numpy.dtype(...).name`` of the
    reference's arrays ("float32", "bfloat16", "float16")."""
    for name, dt in _WIRE_DTYPES.items():
        if dt == dtype:
            return name
    raise TypeError(f"KV transfer: no wire name for dtype {dtype}")


class CacheConfigMismatch(RuntimeError):
    """KV bytes shaped for one cache geometry were offered to another.
    The message names every differing field — the fix is config, not
    retry."""


def cache_fingerprint(cache) -> Dict[str, Any]:
    """The geometry that determines the shape of transferred KV bytes. Two
    caches with equal fingerprints exchange pages or rows byte for byte;
    anything else is refused up front."""
    fp = {
        "layout": "paged" if hasattr(cache, "page_size") else "slab",
        "num_layers": int(cache.num_layers),
        "num_heads": int(cache.num_heads),
        "head_dim": int(cache.head_dim),
        "dtype": _dtype_name(cache.dtype),
    }
    if fp["layout"] == "paged":
        fp["page_size"] = int(cache.page_size)
    return fp


def fingerprint_mismatch(expected: Dict[str, Any],
                         got: Dict[str, Any]) -> List[str]:
    """Human-readable list of differing fingerprint fields (empty =
    compatible)."""
    keys = sorted(set(expected) | set(got))
    return [f"{k}: expected {expected.get(k)!r}, got {got.get(k)!r}"
            for k in keys if expected.get(k) != got.get(k)]


class TransferStats:
    """Residency meter of a transfer's transient host copies:
    ``note_alloc`` when a chunk is read or merged, ``note_free`` when it is
    serialized or written and dropped. At no point may the in-flight bytes
    exceed the per-chunk budget (let alone approach the full cache). Also
    the transfer's wall ms and the shares of it spent in ``zlib.crc32``
    (``crc_ms``) and in the cache's page or row copies (``copy_ms``: the
    device gather and its host copy out, the host copy and scatter in).
    ``kind`` names the transfer once it is done: "export" / "adopt" for a
    request's handoff, "prefix_export" / "prefix_adopt" for a shared
    prefix record."""

    def __init__(self, budget_bytes: int, full_cache_bytes: int):
        self.kind: Optional[str] = None
        self.budget_bytes = int(budget_bytes)
        self.full_cache_bytes = int(full_cache_bytes)
        self.inflight_bytes = 0
        self.peak_bytes = 0
        self.total_bytes = 0       # wire payload bytes moved
        self.chunks = 0
        self.elapsed_ms = 0.0
        self.crc_ms = 0.0
        self.copy_ms = 0.0

    def note_alloc(self, nbytes: int) -> None:
        self.inflight_bytes += int(nbytes)
        self.peak_bytes = max(self.peak_bytes, self.inflight_bytes)
        self.chunks += 1
        if self.inflight_bytes > self.budget_bytes:
            raise AssertionError(
                f"KV transfer residency {self.inflight_bytes}B exceeds "
                f"the chunk budget {self.budget_bytes}B — the transfer "
                f"must stay chunk-wise (full cache: "
                f"{self.full_cache_bytes}B)")

    def note_free(self, nbytes: int) -> None:
        self.inflight_bytes -= int(nbytes)


_stats_lock = threading.Lock()
_last_stats: Dict[str, TransferStats] = {}
# every finished transfer's stats, oldest first (the newest HISTORY_LEN)
HISTORY_LEN = 4096
_history: "collections.deque[TransferStats]" = collections.deque(
    maxlen=HISTORY_LEN)


def last_stats(kind: str = "adopt") -> Optional[TransferStats]:
    """The most recent transfer's stats of ``kind`` (see
    :class:`TransferStats`)."""
    with _stats_lock:
        return _last_stats.get(kind)


def transfer_history(clear: bool = False) -> List[TransferStats]:
    """The stats of the transfers finished since the history was last
    cleared, oldest first; ``clear`` empties it after the read."""
    with _stats_lock:
        out = list(_history)
        if clear:
            _history.clear()
    return out


def _pct(vals: List[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if vals else None


def summarize_stats(stats: Sequence[TransferStats]
                    ) -> Dict[str, Dict[str, Optional[float]]]:
    """Per kind present in ``stats``: the count, wall ms p50/p99, the CRC's
    and the cache copies' ms p50 and shares of the wall time, and the mean
    bytes a transfer moved."""
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for kind in sorted({s.kind for s in stats}):
        sel = [s for s in stats if s.kind == kind]
        wall = max(sum(s.elapsed_ms for s in sel), 1e-9)
        out[kind] = {
            "n": len(sel),
            "ms_p50": _pct([s.elapsed_ms for s in sel], 50),
            "ms_p99": _pct([s.elapsed_ms for s in sel], 99),
            "crc_ms_p50": _pct([s.crc_ms for s in sel], 50),
            "copy_ms_p50": _pct([s.copy_ms for s in sel], 50),
            "crc_share": sum(s.crc_ms for s in sel) / wall,
            "copy_share": sum(s.copy_ms for s in sel) / wall,
            "bytes_mean": float(np.mean([s.total_bytes for s in sel])),
        }
    return out


def _shard_count(engine) -> int:
    """Frames a projection a chunk: the engine's tp (one a rank)."""
    ecfg = getattr(engine, "ecfg", None)
    if ecfg is not None and getattr(ecfg, "sharding", None) == "tp":
        return int(ecfg.tp)
    return 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _crc(data: bytes, stats: TransferStats) -> int:
    t0 = time.perf_counter_ns()
    crc = zlib.crc32(data)
    stats.crc_ms += (time.perf_counter_ns() - t0) / 1e6
    return crc


def _split_frames(t: torch.Tensor, proj: str, axis: int, nshards: int,
                  stats: TransferStats) -> List[Dict[str, Any]]:
    """Serialize one host chunk into per-shard wire frames (the head axis
    split ``nshards`` ways), each its element bytes in C order."""
    parts = (torch.tensor_split(t, nshards, dim=axis) if nshards > 1
             else (t,))
    frames = []
    for si, part in enumerate(parts):
        data = part.contiguous().view(torch.uint8).numpy().tobytes()
        frames.append({"proj": proj, "shard": si, "nshards": nshards,
                       "shape": [int(d) for d in part.shape],
                       "dtype": _dtype_name(part.dtype),
                       "crc": _crc(data, stats), "data": data})
    return frames


def _frame_tensor(f: Dict[str, Any]) -> torch.Tensor:
    dt = _WIRE_DTYPES.get(f["dtype"])
    if dt is None:
        raise ValueError(f"KV transfer: unknown frame dtype {f['dtype']!r}")
    # bytearray: a writable copy, which torch.frombuffer wants
    return torch.frombuffer(bytearray(f["data"]), dtype=dt).reshape(
        [int(d) for d in f["shape"]])


def _assemble_chunk(chunk: Dict[str, Any], axis: int,
                    stats: TransferStats
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Verify CRCs and merge a chunk's shard frames back into the canonical
    layout (head-axis concat). Returns (k, v) host tensors."""
    out: Dict[str, torch.Tensor] = {}
    for proj in ("k", "v"):
        frames = sorted((f for f in chunk["shards"] if f["proj"] == proj),
                        key=lambda f: f["shard"])
        if not frames:
            raise ValueError(f"handoff chunk missing {proj!r} frames")
        parts = []
        for f in frames:
            if _crc(f["data"], stats) != f["crc"]:
                raise ValueError(
                    f"KV transfer CRC mismatch on chunk "
                    f"{chunk['index']} {proj}/shard {f['shard']}")
            parts.append(_frame_tensor(f))
        merged = torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]
        stats.note_alloc(_nbytes(merged))
        out[proj] = merged
    return out["k"], out["v"]


def _wire_bytes(handoff: Dict[str, Any]) -> int:
    return sum(len(f["data"]) for ch in handoff["chunks"]
               for f in ch["shards"])


def _page_unit(cache) -> int:
    """Bytes of one page of one projection."""
    return (cache.num_layers * cache.page_size * cache.num_heads
            * cache.head_dim * cache.k.element_size())


def _row_unit(cache) -> int:
    """Bytes of one slab row of one projection."""
    return (cache.num_layers * cache.num_heads * cache.head_dim
            * cache.k.element_size())


def _read_chunk(read, stats: TransferStats, axis: int, nshards: int
                ) -> List[Dict[str, Any]]:
    """``read()`` -> (k, v) host copies; their frames, within budget."""
    t0 = time.perf_counter_ns()
    k, v = read()
    stats.copy_ms += (time.perf_counter_ns() - t0) / 1e6
    nbytes = _nbytes(k) + _nbytes(v)
    stats.note_alloc(nbytes)
    shards = (_split_frames(k, "k", axis, nshards, stats)
              + _split_frames(v, "v", axis, nshards, stats))
    stats.note_free(nbytes)
    return shards


def _write_chunk(ch: Dict[str, Any], axis: int, stats: TransferStats,
                 write) -> int:
    """Merge ``ch`` and ``write(k, v)`` it; returns its ``n``."""
    k, v = _assemble_chunk(ch, axis, stats)
    t0 = time.perf_counter_ns()
    write(k, v)
    stats.copy_ms += (time.perf_counter_ns() - t0) / 1e6
    stats.note_free(_nbytes(k) + _nbytes(v))
    return int(ch["n"])


def _finish_stats(kind: str, stats: TransferStats, handoff, t0: int) -> None:
    stats.kind = kind
    stats.total_bytes = _wire_bytes(handoff)
    stats.elapsed_ms = (time.perf_counter_ns() - t0) / 1e6
    with _stats_lock:
        _last_stats[kind] = stats
        _history.append(stats)
    if kind in ("export", "adopt"):
        # the handoff's families, as the reference meters them: a prefix
        # record's transfer is counted by m_pool_prefix alone
        smetrics.m_kv_transfer_bytes.labels(
            "out" if kind == "export" else "in").inc(stats.total_bytes)
        smetrics.m_kv_transfer_ms.observe(stats.elapsed_ms)


# ----------------------------------------------------------------------
# export (prefill side)
# ----------------------------------------------------------------------
def export_slot(engine, slot: int,
                tokens: Optional[Sequence[int]] = None,
                chunk_pages: int = DEFAULT_CHUNK_PAGES,
                chunk_rows: int = DEFAULT_CHUNK_ROWS) -> Dict[str, Any]:
    """Serialize a live slot's KV state into a handoff dict: config
    fingerprint + chunked, per-shard, CRC-stamped frames + commit flag.
    The slot stays live — the caller frees it after the handoff is
    accepted (or keeps it on failure)."""
    cache = engine.cache
    fp = cache_fingerprint(cache)
    length = int(cache.length(slot))
    if length <= 0:
        raise ValueError(f"slot {slot} has no valid KV rows to export")
    t0 = time.perf_counter_ns()
    nshards = _shard_count(engine)
    chunks: List[Dict[str, Any]] = []
    if fp["layout"] == "paged":
        pages = [int(p) for p in
                 cache.table_row(slot)[:cache.pages_for(length)]]
        stats = TransferStats(2 * chunk_pages * _page_unit(cache),
                              cache.nbytes)
        for ci, i in enumerate(range(0, len(pages), chunk_pages)):
            group = pages[i:i + chunk_pages]
            shards = _read_chunk(lambda: cache.read_pages(group), stats, 3,
                                 nshards)
            chunks.append({"index": ci, "n": len(group), "shards": shards})
    else:
        stats = TransferStats(2 * chunk_rows * _row_unit(cache),
                              cache.nbytes)
        for ci, start in enumerate(range(0, length, chunk_rows)):
            n = min(chunk_rows, length - start)
            shards = _read_chunk(lambda: cache.read_rows(slot, start, n),
                                 stats, 2, nshards)
            chunks.append({"index": ci, "start": start, "n": n,
                           "shards": shards})
    handoff = {
        "version": 1,
        "transfer_id": f"t{next(_transfer_ids)}-{id(engine) & 0xffff:x}",
        "fingerprint": fp,
        "length": length,
        "tokens": ([int(t) for t in tokens]
                   if tokens is not None else None),
        "chunks": chunks,
        "committed": True,
    }
    _finish_stats("export", stats, handoff, t0)
    return handoff


# ----------------------------------------------------------------------
# adopt (decode side)
# ----------------------------------------------------------------------
def _check_fingerprint(cache, fp: Dict[str, Any], what: str) -> None:
    diffs = fingerprint_mismatch(cache_fingerprint(cache), fp)
    if diffs:
        raise CacheConfigMismatch(
            f"{what} rejected — cache config mismatch: " + "; ".join(diffs))


def _write_pages_chunked(cache, pages: List[int], chunks,
                         stats: TransferStats, what: str) -> None:
    written = 0
    for ch in sorted(chunks, key=lambda c: c["index"]):
        group = pages[written:written + int(ch["n"])]
        written += _write_chunk(
            ch, 3, stats, lambda k, v: cache.write_pages(group, k, v))
    if written != len(pages):
        raise ValueError(f"{what} covered {written} page(s), need "
                         f"{len(pages)}")


def adopt_into_engine(engine, handoff: Dict[str, Any]) -> int:
    """Write a handoff into the receiving engine's cache and return the
    slot it now lives in. The fingerprint is checked FIRST
    (:class:`CacheConfigMismatch` on any differing field); chunks are
    merged shard by shard and written page- or row-wise, so the canonical
    layout only ever exists chunk-sized on the host. Refusals —
    mismatch, an uncommitted handoff, no free slot — claim nothing."""
    cache = engine.cache
    _check_fingerprint(cache, handoff["fingerprint"], "KV handoff")
    if not handoff.get("committed"):
        raise ValueError("handoff was never committed — refusing partial "
                         "KV state")
    if cache.free_slot_count() == 0:
        # fail BEFORE claiming pages and writing chunks: under backlog the
        # scheduler retries adoption every tick
        raise CacheFullError(
            f"no free decode slot for handoff "
            f"{handoff.get('transfer_id')!r}")
    t0 = time.perf_counter_ns()
    length = int(handoff["length"])
    max_chunk = max((int(ch["n"]) for ch in handoff["chunks"]), default=1)
    if hasattr(cache, "page_size"):
        stats = TransferStats(2 * max_chunk * _page_unit(cache),
                              cache.nbytes)
        pages = cache.claim_pages(cache.pages_for(length))
        try:
            _write_pages_chunked(cache, pages, handoff["chunks"], stats,
                                 "handoff")
            slot = cache.adopt_slot(length, pages)
        except Exception:
            cache.deref_pages(pages)
            raise
    else:
        stats = TransferStats(2 * max_chunk * _row_unit(cache),
                              cache.nbytes)
        slot = cache.alloc(length)
        try:
            for ch in sorted(handoff["chunks"], key=lambda c: c["index"]):
                start = int(ch["start"])
                _write_chunk(ch, 2, stats, lambda k, v: cache.write_rows(
                    slot, start, k, v))
        except Exception:
            cache.free(slot)
            raise
    _finish_stats("adopt", stats, handoff, t0)
    # under the request's span context (the scheduler's handoff ingest),
    # so the adoption lands inside the migrated request's trace
    _spans.record("serve/kv_adopt", t0, time.perf_counter_ns() - t0,
                  attrs={"transfer_id": handoff.get("transfer_id"),
                         "bytes": stats.total_bytes})
    return slot


def export_prefix(pool, tokens: Sequence[int], table_row,
                  chunk_pages: int = DEFAULT_CHUNK_PAGES
                  ) -> Optional[Dict[str, Any]]:
    """Serialize the longest page-aligned prefix of ``tokens`` (pages per
    ``table_row``) into a blob :func:`adopt_prefix` replays on any engine
    of the same fingerprint — the payload of the gang-shared prefix index
    (``serving/disagg.py``). None when nothing page-aligned is mapped."""
    ps = pool.page_size
    full = len(tokens) // ps
    if full < 1:
        return None
    prefix = [int(t) for t in tokens[:full * ps]]
    pages = [int(p) for p in table_row[:full]]
    if any(p == 0 for p in pages):
        return None
    t0 = time.perf_counter_ns()
    stats = TransferStats(2 * chunk_pages * _page_unit(pool), pool.nbytes)
    chunks: List[Dict[str, Any]] = []
    for ci, i in enumerate(range(0, len(pages), chunk_pages)):
        group = pages[i:i + chunk_pages]
        shards = _read_chunk(lambda: pool.read_pages(group), stats, 3, 1)
        chunks.append({"index": ci, "n": len(group), "shards": shards})
    blob = {
        "version": 1,
        "transfer_id": f"p{next(_transfer_ids)}",
        "fingerprint": cache_fingerprint(pool),
        "length": len(prefix),
        "tokens": prefix,
        "chunks": chunks,
        "committed": True,
    }
    _finish_stats("prefix_export", stats, blob, t0)
    return blob


def adopt_prefix(engine, blob: Dict[str, Any]) -> int:
    """Adopt a gang-shared prefix record (an export whose ``tokens`` cover
    exactly its page-aligned length) into the local pool and prefix cache,
    so the next prefill of those tokens hits locally. Returns the prefix-
    cache entries registered (0 when the prefix is already cached). Paged
    engines with a prefix cache only."""
    cache = engine.cache
    if not getattr(engine, "paged", False) or engine.prefix is None:
        raise ValueError("prefix adoption needs kv_layout='paged' with "
                         "prefix_cache enabled")
    _check_fingerprint(cache, blob["fingerprint"], "prefix record")
    tokens = [int(t) for t in (blob.get("tokens") or [])]
    length = int(blob["length"])
    if not tokens or len(tokens) != length or length % cache.page_size:
        raise ValueError("prefix record must carry page-aligned tokens "
                         "matching its length")
    if engine.prefix.has(tokens):
        return 0
    t0 = time.perf_counter_ns()
    max_chunk = max((int(ch["n"]) for ch in blob["chunks"]), default=1)
    stats = TransferStats(2 * max_chunk * _page_unit(cache), cache.nbytes)
    pages = cache.claim_pages(cache.pages_for(length))
    try:
        _write_pages_chunked(cache, pages, blob["chunks"], stats,
                             "prefix record")
        # claim_pages' single reference becomes the cache's reference
        added = engine.prefix.adopt_nested(tokens, pages)
    except Exception:
        cache.deref_pages(pages)
        raise
    _finish_stats("prefix_adopt", stats, blob, t0)
    return added


# ----------------------------------------------------------------------
# JSON-inline form (the HTTP channel without a transfer server; tests)
# ----------------------------------------------------------------------
def handoff_to_jsonable(handoff: Dict[str, Any]) -> Dict[str, Any]:
    """Base64 the frame payloads so a handoff can ride a JSON body (~33%
    larger; the socket channel is the real path)."""
    import base64

    out = {k: v for k, v in handoff.items() if k != "chunks"}
    out["chunks"] = [
        dict(ch, shards=[
            dict(f, data=base64.b64encode(f["data"]).decode())
            for f in ch["shards"]])
        for ch in handoff["chunks"]]
    return out


def handoff_from_jsonable(obj: Dict[str, Any]) -> Dict[str, Any]:
    import base64

    out = {k: v for k, v in obj.items() if k != "chunks"}
    out["chunks"] = [
        dict(ch, shards=[
            dict(f, data=base64.b64decode(f["data"]))
            for f in ch["shards"]])
        for ch in obj["chunks"]]
    return out


# ----------------------------------------------------------------------
# socket channel (between replica processes)
# ----------------------------------------------------------------------
# frame = [4B header length][header JSON][8B payload length][payload]
_HDR = struct.Struct(">I")
_PAY = struct.Struct(">Q")


def iter_frames(handoff: Dict[str, Any]
                ) -> Iterator[Tuple[Dict[str, Any], bytes]]:
    """The handoff as a frame stream: one meta frame, one frame a shard
    payload, one commit frame."""
    meta = {k: v for k, v in handoff.items() if k != "chunks"}
    meta["kind"] = "meta"
    meta["committed"] = False       # commit is its own frame
    meta["n_chunks"] = len(handoff["chunks"])
    yield meta, b""
    for ch in handoff["chunks"]:
        base = {k: v for k, v in ch.items() if k != "shards"}
        for f in ch["shards"]:
            hdr = dict(base, kind="chunk",
                       transfer_id=handoff["transfer_id"],
                       **{k: v for k, v in f.items() if k != "data"})
            yield hdr, f["data"]
    yield {"kind": "commit", "transfer_id": handoff["transfer_id"]}, b""


def _send_frame(sock: socket.socket, header: Dict[str, Any],
                payload: bytes) -> None:
    hdr = json.dumps(header).encode()
    sock.sendall(_HDR.pack(len(hdr)) + hdr + _PAY.pack(len(payload)))
    if payload:
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(min(1 << 20, n - len(buf)))
        if not part:
            raise ConnectionError("KV transfer peer closed mid-frame")
        buf.extend(part)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Tuple[Dict[str, Any], bytes]:
    hdr_len = _HDR.unpack(_recv_exact(sock, _HDR.size))[0]
    header = json.loads(_recv_exact(sock, hdr_len).decode())
    pay_len = _PAY.unpack(_recv_exact(sock, _PAY.size))[0]
    payload = _recv_exact(sock, pay_len) if pay_len else b""
    return header, payload


def send_handoff(host: str, port: int, handoff: Dict[str, Any],
                 timeout_s: float = 30.0) -> None:
    """Stream a handoff to a :class:`KVTransferServer` and wait for its
    post-commit ACK. Raises on any transport fault — the caller's cue to
    fall back to colocated dispatch (degrade, never drop). The handoff's
    own trace context (stamped at export) parents the ``serve/kv_send``
    span, so the wire hop shows in the request's trace."""
    with _spans.default_tracer().context(_spans.extract(handoff)), \
            _spans.span("serve/kv_send",
                        attrs={"transfer_id": handoff["transfer_id"],
                               "length": int(handoff["length"])}), \
            socket.create_connection((host, int(port)),
                                     timeout=timeout_s) as sock:
        for header, payload in iter_frames(handoff):
            _send_frame(sock, header, payload)
        ack = _recv_exact(sock, 2)
        if ack != b"OK":
            raise ConnectionError(
                f"KV transfer not acknowledged (got {ack!r})")


class KVTransferServer:
    """Per-replica TCP endpoint that buffers incoming handoffs until the
    serving loop adopts them. A transfer's frames are staged under its
    transfer_id and become visible to :meth:`pop` only after the commit
    frame — a connection dying mid-stream leaves nothing behind."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.5)
        self.host = host
        self.port = int(self._sock.getsockname()[1])
        self._ready: Dict[str, Dict[str, Any]] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(
            target=self._serve, daemon=True, name="kv-transfer-server")

    def start(self) -> "KVTransferServer":
        self._thread.start()
        return self

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True, name="kv-transfer-conn").start()

    def _handle(self, conn: socket.socket) -> None:
        staged: Dict[str, Any] = {}
        chunks: Dict[int, Dict[str, Any]] = {}
        try:
            with conn:
                conn.settimeout(30.0)
                while True:
                    header, payload = _recv_frame(conn)
                    kind = header.get("kind")
                    if kind == "meta":
                        staged = {k: v for k, v in header.items()
                                  if k not in ("kind", "n_chunks")}
                        chunks = {}
                    elif kind == "chunk":
                        ci = int(header["index"])
                        ch = chunks.setdefault(ci, {
                            "index": ci, "n": header["n"], "shards": []})
                        if "start" in header:
                            ch["start"] = header["start"]
                        ch["shards"].append({
                            "proj": header["proj"],
                            "shard": header["shard"],
                            "nshards": header["nshards"],
                            "shape": header["shape"],
                            "dtype": header["dtype"],
                            "crc": header["crc"], "data": payload})
                    elif kind == "commit":
                        # its bytes count as "in" once, when the decode
                        # engine adopts it (adopt_into_engine): counting
                        # the receipt too, as the reference does, counts
                        # a socket handoff twice
                        handoff = dict(
                            staged, committed=True,
                            chunks=[chunks[i] for i in sorted(chunks)])
                        with self._cv:
                            self._ready[handoff["transfer_id"]] = handoff
                            self._cv.notify_all()
                        conn.sendall(b"OK")
                        return
                    else:
                        raise ValueError(f"unknown frame kind {kind!r}")
        except (ConnectionError, OSError, ValueError, KeyError):
            # mid-stream death: nothing was published — the sender's
            # missing ACK triggers its colocated fallback
            return

    def pop(self, transfer_id: str,
            timeout_s: float = 30.0) -> Dict[str, Any]:
        """Block until the transfer committed, then hand it over (exactly
        once). TimeoutError when it never lands."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: transfer_id in self._ready or self._stop,
                timeout=timeout_s)
            if not ok or transfer_id not in self._ready:
                raise TimeoutError(
                    f"KV transfer {transfer_id!r} never committed")
            return self._ready.pop(transfer_id)

    def close(self) -> None:
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5)
