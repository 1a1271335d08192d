"""Program reports, the recompile explainer and live device-memory
accounting — the port of ``paddle_tpu/observability/program_report.py``.

"Compile" has no XLA meaning in the port: nothing is traced or compiled.
A report is captured where the port builds something once — the fluid
``Executor``'s plan for a (program, version, fetch list), and the first
call of ``parallelize.make_train_step``'s step — and holds, in the
reference's record shape:

- ``compile_ms``: the first call's wall ms (the build and the run of the
  call that built it);
- ``flops`` / ``bytes_accessed``: the work that call counted — the
  ``aten`` ops' FLOPs (``torch.utils.flop_counter.FlopCounterMode``:
  matrix products, convolutions, attention), plus the hand kernels'
  costs (``ops/kernel_costs.py``). A remat policy's recompute is counted.
  The ``aten`` count is taken only under ``FLAGS_program_report_flops``
  (``tools/profile_step.py`` sets it): its Python dispatch of every op
  would cost every process's first train step seconds on the card, and
  ``flops`` is None without it. Bytes are the hand kernels' only, None
  when none launched: an ``aten`` op's traffic is not known (the
  reference's graceful path leaves such a field None,
  ``program_report.py:133``);
- ``memory``: from the allocator on the card — the arguments' bytes, the
  outputs', the peak during the call and that peak less the arguments
  (``temp_bytes``); the allocator-based fields are None on the CPU;
- ``in_avals`` / ``out_avals``: count, total bytes and the first entries'
  shapes and dtypes.

Records land in a bounded ring (:func:`recent_reports`), as JSONL under
``FLAGS_program_report_dir`` and as the ``paddle_program_*`` gauges. The
explainer (:func:`make_sig`, :func:`explain_recompile`,
:func:`note_recompile`, ``paddle_recompiles_total{cause=}``) is the
reference's. A difference by design: an eager plan is not rebuilt when a
feed's shape or dtype changes, so the port never reports ``feed_shape``
or ``feed_dtype``.

:func:`live_buffer_bytes` reads ``torch.cuda.memory_allocated`` /
``max_memory_allocated`` on the card and gives (None, None) on the CPU.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import metrics as _metrics

logger = logging.getLogger("paddle_tpu_torch.program_report")

__all__ = [
    "build_report", "record_report", "capture", "counted",
    "recent_reports", "make_sig", "explain_recompile", "note_recompile",
    "live_buffer_bytes", "sample_hbm_gauges", "reconcile_memory_usage",
    "reset",
]

_OBS = _metrics.default_registry()
_m_reports = _OBS.counter(
    "paddle_program_reports_total", "Program reports captured")
_m_flops = _OBS.gauge(
    "paddle_program_flops",
    "Counted flops of the program's first call", ("program",))
_m_bytes = _OBS.gauge(
    "paddle_program_bytes_accessed",
    "Counted bytes of the program's first call (hand kernels)",
    ("program",))
_m_peak = _OBS.gauge(
    "paddle_program_peak_hbm_bytes",
    "Allocator peak bytes during the program's first call", ("program",))
_m_compile_ms = _OBS.gauge(
    "paddle_program_compile_ms",
    "Wall-clock ms of the program's first call (its build)", ("program",))
_m_recompiles = _OBS.counter(
    "paddle_recompiles_total",
    "Program rebuilds by explained cause", ("cause",))
_m_live = _OBS.gauge(
    "paddle_live_buffer_bytes",
    "Live device buffer bytes (the allocator's)")
_m_peak_hbm = _OBS.gauge(
    "paddle_peak_hbm_bytes",
    "Peak device buffer bytes (the allocator's)")

# bounded ring of recent reports: the anomaly-forensics dump references
# the programs active when a step went bad
_RECENT_MAX = 64
_recent: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=_RECENT_MAX)
_seq_lock = threading.Lock()
_seq = [0]
_jsonl_state: Dict[str, Any] = {"dir": None, "file": None}


def reset() -> None:
    """Drop module state (tests): the report ring, the JSONL sink binding
    and the recompile log limiter."""
    _recent.clear()
    _seq[0] = 0
    f = _jsonl_state.get("file")
    if f is not None:
        try:
            f.close()
        except OSError:
            pass
    _jsonl_state.update(dir=None, file=None)
    _log_counts.clear()


# ---------------------------------------------------------------------------
# Counting one call
# ---------------------------------------------------------------------------


def _tensors(tree) -> List[Any]:
    """The arrays of a nested structure (dicts, lists, tuples): tensors
    and numpy arrays, in order."""
    import numpy as np
    import torch

    out: List[Any] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, (torch.Tensor, np.ndarray)):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
    return out


def _size(t) -> int:
    return int(t.nbytes) if hasattr(t, "nbytes") else \
        t.numel() * t.element_size()


def _nbytes(tree) -> int:
    """Bytes of a structure's arrays, a tensor seen twice counted once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        key = (id(t) if not hasattr(t, "data_ptr")
               else (t.data_ptr(), t.numel(), str(t.dtype)))
        if key not in seen:
            seen.add(key)
            total += _size(t)
    return total


def _aval_rows(tree, limit: int = 24) -> Dict[str, Any]:
    """A structure's arrays as {count, total_bytes, entries[:limit]}."""
    ts = _tensors(tree)
    return {"count": len(ts),
            "total_bytes": int(sum(_size(t) for t in ts)),
            "entries": [{"shape": list(t.shape),
                         "dtype": str(t.dtype).replace("torch.", "")}
                        for t in ts[:limit]]}


class Counted:
    """What :func:`counted` measured of a block: wall ms, the ``aten``
    FLOPs, the hand kernels' FLOPs / bytes / launches, and on the card the
    allocator's peak during the block."""

    def __init__(self):
        self.wall_ms: Optional[float] = None
        self.aten_flops: Optional[int] = None     # None: not counted
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_launches = 0
        self.peak_bytes: Optional[int] = None

    @property
    def flops(self) -> Optional[float]:
        if self.aten_flops is None:
            return None
        return float(self.aten_flops + self.kernel_flops)

    @property
    def bytes_accessed(self) -> Optional[float]:
        return float(self.kernel_bytes) if self.kernel_launches else None


@contextlib.contextmanager
def counted(device=None, flops: Optional[bool] = None):
    """Count the block's work: the hand kernels' launch costs
    (``kernel_costs.arm``) and its wall ms, and with ``flops`` (default:
    the flag ``FLAGS_program_report_flops``) ``FlopCounterMode`` over its
    ``aten`` ops (a backward and a remat recompute included) — off by
    default, as its Python dispatch of every op costs a process's first
    train step seconds on the card, a restart's time; on a CUDA
    ``device`` the block ends in a synchronize and the allocator's peak
    is read (its peak counter is reset at the start). Yields a
    :class:`Counted` filled when the block ends."""
    import torch

    from ..framework.core import get_flag
    from ..ops import kernel_costs

    if flops is None:
        flops = bool(get_flag("FLAGS_program_report_flops"))
    dev = torch.device(device) if device is not None else None
    cuda = dev is not None and dev.type == "cuda"
    c = Counted()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if flops:
        from torch.utils.flop_counter import FlopCounterMode

        mode = FlopCounterMode(display=False)
    else:
        mode = contextlib.nullcontext()
    t0 = time.perf_counter()
    with kernel_costs.arm() as costs, mode:
        yield c
        if cuda:
            torch.cuda.synchronize(dev)
    c.wall_ms = (time.perf_counter() - t0) * 1e3
    c.aten_flops = int(mode.get_total_flops()) if flops else None
    for t in costs.totals().values():
        c.kernel_flops += t["flops"]
        c.kernel_bytes += t["bytes"]
        c.kernel_launches += t["launches"]
    if cuda:
        c.peak_bytes = int(torch.cuda.max_memory_allocated(dev))


def memory_summary(inputs=None, outputs=None,
                   peak_bytes: Optional[int] = None
                   ) -> Dict[str, Optional[int]]:
    """The reference's memory keys from the allocator: argument and
    output bytes of the call's tensors, the peak during it and that peak
    less the arguments (``temp_bytes``); no generated code, no aliasing
    counted (None), and None for what no allocator measured."""
    arg = _nbytes(inputs) if inputs is not None else None
    out = _nbytes(outputs) if outputs is not None else None
    temp = (max(0, peak_bytes - arg)
            if peak_bytes is not None and arg is not None else None)
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
            "generated_code_bytes": None, "alias_bytes": None,
            "peak_hbm_bytes": peak_bytes}


def build_report(name: str, counts: Optional[Counted] = None,
                 cache: Optional[str] = None, donated: Sequence[str] = (),
                 inputs=None, outputs=None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble one program-report record from a first call's
    :class:`Counted` and its inputs / outputs (structures of tensors, or
    pre-built summary dicts)."""
    with _seq_lock:
        _seq[0] += 1
        seq = _seq[0]
    c = counts if counts is not None else Counted()
    rec: Dict[str, Any] = {
        "seq": seq,
        "ts": round(time.time(), 3),
        "program": str(name),
        "compile_ms": (round(float(c.wall_ms), 3)
                       if c.wall_ms is not None else None),
        "cache": cache,
        "donated": list(donated),
        "flops": c.flops,
        "bytes_accessed": c.bytes_accessed,
        "kernel_launches": c.kernel_launches,
        "memory": memory_summary(
            None if isinstance(inputs, dict) and "count" in inputs
            else inputs,
            None if isinstance(outputs, dict) and "count" in outputs
            else outputs, c.peak_bytes),
    }
    if inputs is not None:
        rec["in_avals"] = (inputs if isinstance(inputs, dict)
                           and "count" in inputs else _aval_rows(inputs))
    if outputs is not None:
        rec["out_avals"] = (outputs if isinstance(outputs, dict)
                            and "count" in outputs else _aval_rows(outputs))
    if extra:
        rec.update(extra)
    return rec


def _jsonl_sink():
    """Open (once) the per-process JSONL file under
    FLAGS_program_report_dir; returns None when the flag is unset."""
    from ..framework.core import get_flag

    d = get_flag("FLAGS_program_report_dir") or ""
    if not d:
        return None
    if _jsonl_state["dir"] != d or _jsonl_state["file"] is None:
        try:
            os.makedirs(d, exist_ok=True)
            f = open(os.path.join(
                d, f"program_reports.{os.getpid()}.jsonl"), "a")
        except OSError as e:
            logger.warning("program report dir %r unusable: %s", d, e)
            return None
        old = _jsonl_state.get("file")
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        _jsonl_state.update(dir=d, file=f)
    return _jsonl_state["file"]


def record_report(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Publish a report: ring buffer + JSONL sink + labeled gauges."""
    _recent.append(rec)
    _m_reports.inc()
    label = rec.get("program", "?")
    if rec.get("flops") is not None:
        _m_flops.labels(label).set(rec["flops"])
    if rec.get("bytes_accessed") is not None:
        _m_bytes.labels(label).set(rec["bytes_accessed"])
    peak = (rec.get("memory") or {}).get("peak_hbm_bytes")
    if peak is not None:
        _m_peak.labels(label).set(peak)
    if rec.get("compile_ms") is not None:
        _m_compile_ms.labels(label).set(rec["compile_ms"])
    f = _jsonl_sink()
    if f is not None:
        try:
            f.write(json.dumps(rec) + "\n")
            f.flush()
        except (OSError, TypeError, ValueError) as e:
            logger.warning("program report write failed: %s", e)
    return rec


def capture(name: str, counts: Optional[Counted] = None, **kw
            ) -> Dict[str, Any]:
    """build_report + record_report; never raises (observability must not
    take down the path it watches)."""
    try:
        return record_report(build_report(name, counts, **kw))
    except Exception as e:  # pragma: no cover - defensive
        logger.warning("program report capture failed for %s: %s", name, e)
        return {}


def recent_reports(n: Optional[int] = None) -> List[Dict[str, Any]]:
    out = list(_recent)
    return out if n is None else out[-n:]


# ---------------------------------------------------------------------------
# Recompile explainer (the reference's)
# ---------------------------------------------------------------------------

def make_sig(feed_sig, fetch_names, flags: Optional[Dict[str, Any]] = None,
             version=None, mesh=None) -> Dict[str, Any]:
    """Normalize one build's identity for later diffing."""
    return {
        "feed": tuple((str(n), tuple(s), str(d)) for n, s, d in feed_sig),
        "fetch": tuple(str(n) for n in fetch_names),
        "flags": tuple(sorted((flags or {}).items())),
        "version": version,
        "mesh": mesh,
    }


def _diff_causes(old: Dict[str, Any], new: Dict[str, Any]):
    """Diff two build signatures; returns (causes, detail_lines) in
    specificity order."""
    causes: List[str] = []
    details: List[str] = []
    old_feed = {n: (s, d) for n, s, d in old["feed"]}
    new_feed = {n: (s, d) for n, s, d in new["feed"]}
    if set(old_feed) != set(new_feed):
        causes.append("feed_set")
        added = sorted(set(new_feed) - set(old_feed))
        removed = sorted(set(old_feed) - set(new_feed))
        details.append(f"feed names changed (+{added} -{removed})")
    else:
        shape_diffs = [(n, old_feed[n][0], new_feed[n][0])
                       for n in new_feed if old_feed[n][0] != new_feed[n][0]]
        dtype_diffs = [(n, old_feed[n][1], new_feed[n][1])
                       for n in new_feed if old_feed[n][1] != new_feed[n][1]]
        if shape_diffs:
            causes.append("feed_shape")
            details += [f"feed {n!r} shape {o} -> {w}"
                        for n, o, w in shape_diffs[:4]]
        if dtype_diffs:
            causes.append("feed_dtype")
            details += [f"feed {n!r} dtype {o} -> {w}"
                        for n, o, w in dtype_diffs[:4]]
    if old["fetch"] != new["fetch"]:
        causes.append("fetch_list")
        details.append(f"fetch list {list(old['fetch'])} -> "
                       f"{list(new['fetch'])}")
    if old["flags"] != new["flags"]:
        changed = [f"{k}={dict(old['flags']).get(k)!r}->{v!r}"
                   for k, v in new["flags"]
                   if dict(old["flags"]).get(k) != v]
        causes.append("flags")
        details.append("flags changed: " + ", ".join(changed))
    if old.get("version") != new.get("version"):
        causes.append("program_mutation")
        details.append("program was mutated (version token changed)")
    if old.get("mesh") != new.get("mesh"):
        causes.append("mesh")
        details.append(f"mesh plan {old.get('mesh')} -> {new.get('mesh')}")
    return causes, details


def explain_recompile(new_sig: Dict[str, Any],
                      siblings: Sequence[Dict[str, Any]]):
    """Pick the *nearest* sibling signature (fewest differing components,
    most recent sibling winning ties — the likely predecessor) and name
    the rebuild's cause. Returns (cause, detail_str); cause is "other"
    when nothing differs in a way we model."""
    best: Optional[Tuple[List[str], List[str]]] = None
    for old in reversed(list(siblings)):
        causes, details = _diff_causes(old, new_sig)
        if best is None or len(causes) < len(best[0]):
            best = (causes, details)
            if len(causes) == 1:
                break
    if best is None or not best[0]:
        return "other", "no sibling signature difference identified"
    causes, details = best
    # primary cause = most specific in the fixed priority order
    for cause in ("feed_shape", "feed_dtype", "feed_set", "fetch_list",
                  "flags", "program_mutation", "mesh"):
        if cause in causes:
            return cause, "; ".join(details)
    return causes[0], "; ".join(details)


# log rate limit: first N occurrences per (program, cause) logged, then
# every Kth — the counter keeps exact totals regardless
_LOG_FIRST = 3
_LOG_EVERY = 50
_log_counts: Dict[Tuple[str, str], int] = {}


def note_recompile(program_label: str, cause: str, detail: str) -> bool:
    """Count one explained rebuild; emit the human-readable cause line
    subject to the rate limit. Returns True when the line was logged."""
    _m_recompiles.labels(cause).inc()
    key = (str(program_label), cause)
    n = _log_counts.get(key, 0) + 1
    _log_counts[key] = n
    if n <= _LOG_FIRST or n % _LOG_EVERY == 0:
        suffix = (f" ({n} total, logging 1/{_LOG_EVERY})"
                  if n > _LOG_FIRST else "")
        logger.warning("recompile of %s: cause=%s — %s%s",
                       program_label, cause, detail, suffix)
        return True
    return False


# ---------------------------------------------------------------------------
# Live device memory
# ---------------------------------------------------------------------------

def live_buffer_bytes() -> Tuple[Optional[int], Optional[int]]:
    """(allocated bytes, peak allocated bytes) on the current card; (None,
    None) while no card is in use (the CPU has no allocator counters)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None, None
    return (int(torch.cuda.memory_allocated()),
            int(torch.cuda.max_memory_allocated()))


def sample_hbm_gauges() -> Tuple[Optional[int], Optional[int]]:
    """live_buffer_bytes() + publish both numbers as registry gauges."""
    live, peak = live_buffer_bytes()
    if live is not None:
        _m_live.set(live)
    if peak is not None:
        _m_peak_hbm.set(peak)
    return live, peak


def reconcile_memory_usage(program, batch_size: int = 1) -> Dict[str, Any]:
    """The reference checks ``contrib.memory_usage_calc``'s static estimate
    against the measured bytes; that module is not ported yet."""
    raise NotImplementedError(
        "reconcile_memory_usage needs contrib.memory_usage_calc, which is "
        "not ported yet (ROADMAP A5)")
