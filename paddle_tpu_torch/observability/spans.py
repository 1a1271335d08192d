"""Lightweight end-to-end span tracer — the port of
``paddle_tpu/observability/spans.py`` (pure Python, the same record shape
and JSONL sink format, so either package's assembler reads the other's
files).

The metrics registry answers "how much / how often"; the span tracer
answers "which request / which step, and what happened inside it".  A span
is one timed operation with identity:

    {trace, span, parent, name, start_ns, dur_ns, tid, thread, attrs}

- ``trace`` groups every span of one logical unit (a serving request, a
  training step) so a user-visible p99 can be walked back to the exact
  prefill/decode tick that caused it;
- ``parent`` links spans into a tree *across threads*: a worker thread
  (the serving ``EngineLoop``, the checkpoint writer) attaches the
  submitting thread's context
  with :meth:`SpanTracer.context` and its spans parent correctly instead
  of orphaning;
- timestamps are ``time.perf_counter_ns`` (CLOCK_MONOTONIC, one epoch per
  host), so spans of several processes on one machine line up.

Span times are HOST times. A span ends when the host reaches its end: a
serving decode tick syncs on its sampled tokens and so covers the
device's work; a prefill span ends after its logits are copied to the
host, which waits for the device too; any span around work that is only
enqueued times the enqueue.

Cost model (``chip_smoke.py`` times the decode tick and the train step
with tracing on and off, in turns): a disabled tracer is one global read;
an enabled :func:`record` is two dict builds and a deque append; the
:meth:`span` context manager adds two ``perf_counter_ns`` calls.  Spans
land in a bounded ring (old spans fall off) and, when a JSONL sink is
set, one flushed line per span.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Any, Dict, IO, List, Optional, Tuple, Union

__all__ = [
    "SpanTracer", "default_tracer", "span", "record", "current_context",
    "gen_id", "set_tracing_enabled", "tracing_enabled",
    "WIRE_KEY", "inject", "extract", "attach_process_sink",
    "process_sink_path",
]

# process-wide kill switch, mirroring metrics.set_metrics_enabled (the
# tracing on/off pairs throw it)
_ENABLED = True


def tracing_enabled() -> bool:
    return _ENABLED


def set_tracing_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


_ids = itertools.count(1)
_pid_salt = None


def gen_id() -> int:
    """Process-unique span/trace id (monotone counter salted with the pid
    so ids from different gang ranks never collide in a merged view)."""
    global _pid_salt
    if _pid_salt is None:
        import os

        _pid_salt = (os.getpid() & 0xFFFF) << 40
    return _pid_salt | next(_ids)


Context = Tuple[int, int]  # (trace_id, span_id)

# -- trace-context wire format ----------------------------------------------
# One request = ONE trace across processes: the gang front door mints a
# context, injects it into every replica-bound JSON body (and the KV
# handoff frame), and each hop extracts + re-injects.  The wire shape is
# a plain JSON object under the ``trace`` key:
#
#     {"trace": {"trace_id": <int>, "parent_span": <int>}}
#
# ints, not hex strings, so stdlib-only workers round-trip it with
# nothing but ``json``.

WIRE_KEY = "trace"


def inject(ctx: Optional[Context]) -> Optional[Dict[str, int]]:
    """Serialize a (trace_id, span_id) context for a JSON body / frame.
    The receiving side's spans parent under ``parent_span``."""
    if ctx is None:
        return None
    return {"trace_id": int(ctx[0]), "parent_span": int(ctx[1])}


def extract(obj: Any) -> Optional[Context]:
    """Inverse of :func:`inject`.  Accepts the wire dict itself or any
    mapping carrying it under :data:`WIRE_KEY`; returns None on anything
    malformed (a request with a garbled trace still serves — it just
    starts a fresh trace)."""
    if not isinstance(obj, dict):
        return None
    wire = obj.get(WIRE_KEY, obj)
    if not isinstance(wire, dict):
        return None
    try:
        return (int(wire["trace_id"]), int(wire["parent_span"]))
    except (KeyError, TypeError, ValueError):
        return None


def process_sink_path(trace_dir: str, role: str = "proc") -> str:
    """Per-process span file inside a shared trace dir.  The pid keeps
    sibling replicas (and restarted incarnations) from clobbering each
    other; ``paddle_tpu_torch.tools.trace_assemble`` globs
    ``spans-*.jsonl``."""
    import os

    return os.path.join(trace_dir, f"spans-{role}-{os.getpid()}.jsonl")


def attach_process_sink(trace_dir: str, role: str = "proc") -> str:
    """Point the default tracer's JSONL sink at this process's file in
    ``trace_dir`` (created if missing).  Append-at-record with per-line
    flush — a SIGKILLed process leaves every finished span on disk for
    post-mortem assembly."""
    import os

    os.makedirs(trace_dir, exist_ok=True)
    path = process_sink_path(trace_dir, role)
    _default.set_sink(path)
    return path


class _OpenSpan:
    __slots__ = ("tracer", "name", "trace", "span_id", "parent", "attrs",
                 "t0")

    def __init__(self, tracer, name, trace, span_id, parent, attrs):
        self.tracer = tracer
        self.name = name
        self.trace = trace
        self.span_id = span_id
        self.parent = parent
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def set_attr(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tls = tr._tls
        tls.ctx = (self.trace, self.parent) if self.parent else None
        if exc_type is not None:
            self.set_attr("error", exc_type.__name__)
        tr._append({
            "name": self.name, "trace": self.trace, "span": self.span_id,
            "parent": self.parent, "start_ns": self.t0,
            "dur_ns": t1 - self.t0, "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            **({"attrs": self.attrs} if self.attrs else {}),
        })
        return False


class _NullSpan:
    """Shared no-op handle returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def set_attr(self, key, value):
        pass

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class SpanTracer:
    """Bounded-ring span recorder with thread-local context propagation."""

    def __init__(self, ring: int = 4096,
                 sink: Optional[Union[str, IO]] = None):
        import collections

        self._ring = collections.deque(maxlen=int(ring))
        self._tls = threading.local()
        self._sink: Optional[IO] = None
        self._own_sink = False
        self._sink_lock = threading.Lock()
        if sink is not None:
            self.set_sink(sink)

    # -- context propagation ----------------------------------------------
    def current_context(self) -> Optional[Context]:
        """(trace_id, span_id) of the innermost open span on this thread,
        or an attached cross-thread context; None outside any span."""
        return getattr(self._tls, "ctx", None)

    @contextlib.contextmanager
    def context(self, ctx: Optional[Context]):
        """Adopt ``ctx`` (captured on another thread via
        :meth:`current_context`) for the duration of the block: spans
        opened inside parent into it.  ``None`` is a no-op block."""
        prev = getattr(self._tls, "ctx", None)
        if ctx is not None:
            self._tls.ctx = ctx
        try:
            yield
        finally:
            self._tls.ctx = prev

    # -- recording --------------------------------------------------------
    def span(self, name: str, trace: Optional[int] = None,
             attrs: Optional[Dict[str, Any]] = None):
        """Context manager timing one span.  Inherits trace + parent from
        the thread-local context unless ``trace`` starts a new one."""
        if not _ENABLED:
            return _NULL
        ctx = getattr(self._tls, "ctx", None)
        if trace is not None:
            trace_id, parent = trace, (ctx[1] if ctx and ctx[0] == trace
                                       else None)
        elif ctx is not None:
            trace_id, parent = ctx
        else:
            trace_id, parent = gen_id(), None
        span_id = gen_id()
        self._tls.ctx = (trace_id, span_id)
        return _OpenSpan(self, name, trace_id, span_id, parent, attrs)

    def record(self, name: str, start_ns: int, dur_ns: int,
               trace: Optional[int] = None, parent: Optional[int] = None,
               span_id: Optional[int] = None,
               attrs: Optional[Dict[str, Any]] = None) -> Optional[int]:
        """Append an already-timed span (the timing happened elsewhere —
        e.g. queue wait measured between submit and admit).  With
        ``trace=None`` both trace and parent come from the thread-local
        context; an explicit ``trace`` leaves ``parent`` exactly as given
        (``None`` = a root span of that trace).  Returns the span id, or
        None while tracing is disabled."""
        if not _ENABLED:
            return None
        if trace is None:
            ctx = getattr(self._tls, "ctx", None)
            if ctx is not None:
                trace = ctx[0]
                if parent is None:
                    parent = ctx[1]
            else:
                trace = gen_id()
        if span_id is None:
            span_id = gen_id()
        self._append({
            "name": name, "trace": trace, "span": span_id,
            "parent": parent, "start_ns": int(start_ns),
            "dur_ns": int(dur_ns), "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            **({"attrs": attrs} if attrs else {}),
        })
        return span_id

    def _append(self, rec: dict) -> None:
        self._ring.append(rec)
        sink = self._sink
        if sink is not None:
            with self._sink_lock:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()

    # -- sinks / introspection --------------------------------------------
    def set_sink(self, path_or_file: Optional[Union[str, IO]]) -> None:
        """JSONL sink: one flushed line per finished span (None detaches).
        The ring keeps recording either way."""
        with self._sink_lock:
            if self._own_sink and self._sink is not None:
                self._sink.close()
            if path_or_file is None:
                self._sink, self._own_sink = None, False
            elif hasattr(path_or_file, "write"):
                self._sink, self._own_sink = path_or_file, False
            else:
                self._sink = open(path_or_file, "a")
                self._own_sink = True

    def spans(self) -> List[dict]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def summary(self) -> Dict[str, dict]:
        """Per-name percentile rollup over the ring:
        {name: {count, total_ms, p50_ms, p90_ms, p99_ms, max_ms}}."""
        by_name: Dict[str, List[float]] = {}
        for s in list(self._ring):
            by_name.setdefault(s["name"], []).append(s["dur_ns"] / 1e6)
        out: Dict[str, dict] = {}
        for name, vals in sorted(by_name.items()):
            vals.sort()
            n = len(vals)

            def pct(q):
                return vals[min(n - 1, max(0, int(round(q / 100.0
                                                        * (n - 1)))))]

            out[name] = {
                "count": n, "total_ms": round(sum(vals), 3),
                "p50_ms": round(pct(50), 3), "p90_ms": round(pct(90), 3),
                "p99_ms": round(pct(99), 3), "max_ms": round(vals[-1], 3),
            }
        return out

    def trace_spans(self, trace_id: int) -> List[dict]:
        """Every ring span of one trace, in start order (the p99->cause
        walk: feed it the trace id stamped on a slow request)."""
        return sorted((s for s in list(self._ring)
                       if s["trace"] == trace_id),
                      key=lambda s: s["start_ns"])


_default = SpanTracer()


def default_tracer() -> SpanTracer:
    return _default


def span(name: str, trace: Optional[int] = None,
         attrs: Optional[Dict[str, Any]] = None):
    """Module-level :meth:`SpanTracer.span` on the default tracer."""
    return _default.span(name, trace=trace, attrs=attrs)


def record(name: str, start_ns: int, dur_ns: int, **kw) -> Optional[int]:
    return _default.record(name, start_ns, dur_ns, **kw)


def current_context() -> Optional[Context]:
    return _default.current_context()
