"""Phase-disaggregated serving: in-process replica set and router — the port
of ``paddle_tpu/serving/disagg.py:41-329``.

Prefill is compute-bound and bursty; decode is bound by memory and steady.
Colocated, a long prompt's prefill stalls every rider's decode tick. This
module is the in-process form of the split (one Python process, one engine
per role), used by ``tools/serve_bench.py --disagg``, ``chip_smoke.py``
and the parity tests:

- :class:`LocalReplica` — engine + scheduler + serving loop, with the
  engine's role;
- :class:`SharedPrefixIndex` — the pool-level prefix cache: a gang-shared,
  token-keyed index of serialized prefix pages, so a system prompt
  prefilled on ANY replica is adoptable by all (counted per phase by
  ``paddle_serve_pool_prefix_cache_total{event,phase}``);
- :class:`DisaggRouter` — queue-ETA placement per role, first-token
  migration over ``serving/kv_transfer.py``, and degrade-never-drop: an
  empty phase fleet or a failed handoff falls back to colocated dispatch
  (``paddle_serve_disagg_fallback_total{reason}``, reasons
  ``no_phase_fleet``, ``prefill_refused``, ``prefill_failed``,
  ``handoff_refused``, ``decode_failed``).

One routed request is one trace (``observability/spans.py``):
:meth:`DisaggRouter.generate` records ``serve/route`` and hands its context
to the prefill replica; the handoff carries it to the decode replica
(``serve/kv_adopt`` there), and a colocated fallback inherits it too.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability import spans as _spans
from . import metrics as smetrics
from .kv_transfer import export_prefix
from .sampling import SamplingParams
from .scheduler import Scheduler, SchedulerConfig

__all__ = ["LocalReplica", "SharedPrefixIndex", "DisaggRouter",
           "DisaggResult"]


class SharedPrefixIndex:
    """Gang-shared prefix index: token tuple -> serialized prefix pages (a
    ``kv_transfer`` blob). It plugs into an engine's ``prefix_store`` slot
    (duck-typed: the engine calls ``maybe_publish``), so every prefill
    publish lands here as well as in the replica's own cache; a router
    takes the longest blob for a prompt (:meth:`fetch`) and hands it to
    ``Scheduler.submit(prefix_blob=...)`` for adoption."""

    def __init__(self, max_records: int = 256):
        self.max_records = int(max_records)
        self._lock = threading.Lock()
        # insertion-ordered key -> blob (the oldest drops past max_records)
        self._blobs: Dict[Tuple[int, ...], Dict[str, Any]] = {}
        self.hits = 0
        self.misses = 0
        self.published = 0

    def binding(self, role: str) -> "_IndexBinding":
        """A phase-stamping adapter to set as ``engine.prefix_store``."""
        return _IndexBinding(self, role)

    def publish(self, tokens: Sequence[int], table_row, pool,
                phase: str = "colocated") -> bool:
        blob = export_prefix(pool, tokens, table_row)
        if blob is None:
            return False
        key = tuple(blob["tokens"])
        with self._lock:
            if key in self._blobs:
                return False
            self._blobs[key] = blob
            while len(self._blobs) > self.max_records:
                self._blobs.pop(next(iter(self._blobs)))
            self.published += 1
        smetrics.m_pool_prefix.labels("publish", phase).inc()
        return True

    def fetch(self, tokens: Sequence[int],
              phase: str = "colocated") -> Optional[Dict[str, Any]]:
        """Longest indexed page-aligned prefix of ``tokens`` that leaves at
        least one suffix token to prefill. Counts hit/miss per phase."""
        tokens = [int(t) for t in tokens]
        best = None
        with self._lock:
            for key, blob in self._blobs.items():
                n = len(key)
                if (n < len(tokens) and tuple(tokens[:n]) == key
                        and (best is None or n > len(best["tokens"]))):
                    best = blob
            if best is None:
                self.misses += 1
            else:
                self.hits += 1
        smetrics.m_pool_prefix.labels(
            "miss" if best is None else "hit", phase).inc()
        return best

    def __len__(self) -> int:
        with self._lock:
            return len(self._blobs)


class _IndexBinding:
    """One replica's view of the shared index: stamps its role on the
    publish metric and satisfies the engine's ``prefix_store`` duck
    type."""

    def __init__(self, index: SharedPrefixIndex, role: str):
        self.index = index
        self.role = role

    def maybe_publish(self, tokens, table_row, pool) -> bool:
        return self.index.publish(tokens, table_row, pool, phase=self.role)


class LocalReplica:
    """One in-process serving replica: engine + continuous-batching
    scheduler + loop thread, with the engine's role."""

    def __init__(self, engine, scfg: Optional[SchedulerConfig] = None,
                 prefix_index: Optional[SharedPrefixIndex] = None,
                 name: Optional[str] = None):
        from .server import EngineLoop

        self.engine = engine
        self.role = getattr(engine, "role", "colocated")
        self.name = name or f"{self.role}-{id(engine) & 0xffff:x}"
        self.scheduler = Scheduler(engine, scfg, device=engine.device)
        self.prefix_index = prefix_index
        if (prefix_index is not None and getattr(engine, "paged", False)
                and engine.prefix is not None
                and engine.prefix_store is None):
            engine.prefix_store = prefix_index.binding(self.role)
        self.loop = EngineLoop(self.scheduler).start()

    def wake(self) -> None:
        self.loop.wake()

    def stop(self) -> None:
        self.loop.stop()

    def load_eta_s(self) -> float:
        """Placement score: seconds of work already committed here —
        queued, pending-handoff and active requests over the measured
        drain rate (the count itself while no rate is measurable, so cold
        replicas still spread)."""
        depth = self.scheduler.pending()
        rate = self.scheduler.drain_rate()
        if rate is None or rate <= 0:
            return float(depth)
        return depth / rate


class DisaggResult:
    """What the router hands back: the tokens (parity checks) and the
    latencies (prefill-side TTFT, decode-side cadence)."""

    __slots__ = ("tokens", "ttft_ms", "token_times", "state", "error",
                 "migrated", "fallback_reason", "handoff_ms", "trace_id")

    def __init__(self, tokens, ttft_ms, token_times, state,
                 error=None, migrated=False, fallback_reason=None,
                 handoff_ms=None):
        self.tokens = tokens
        self.ttft_ms = ttft_ms
        self.token_times = token_times
        self.state = state
        self.error = error
        self.migrated = migrated
        self.fallback_reason = fallback_reason
        self.handoff_ms = handoff_ms
        self.trace_id = None

    @property
    def tpot_ms(self) -> Optional[float]:
        if len(self.token_times) < 2:
            return None
        return float(np.mean(np.diff(self.token_times)) * 1e3)


class DisaggRouter:
    """Routes a request prefill replica -> decode replica at the first-token
    boundary; any failure degrades to colocated dispatch on whatever fleet
    can still serve (never drops)."""

    def __init__(self, replicas: Sequence[LocalReplica],
                 prefix_index: Optional[SharedPrefixIndex] = None):
        self.replicas = list(replicas)
        self.prefill_fleet = [r for r in self.replicas
                              if r.role == "prefill"]
        self.decode_fleet = [r for r in self.replicas if r.role == "decode"]
        self.colocated_fleet = [r for r in self.replicas
                                if r.role == "colocated"]
        self.prefix_index = prefix_index
        self._count_lock = threading.Lock()
        self.migrated = 0
        self.fallbacks = 0

    @staticmethod
    def _pick(fleet: Sequence[LocalReplica]) -> LocalReplica:
        return min(fleet, key=lambda r: r.load_eta_s())

    def _fallback_fleet(self) -> List[LocalReplica]:
        # colocated replicas first; else any engine serves both phases
        # (roles are routing policy, not capability)
        return self.colocated_fleet or (self.decode_fleet
                                        + self.prefill_fleet)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 timeout_s: float = 30.0,
                 sampling: Optional[SamplingParams] = None,
                 trace_ctx: Optional[_spans.Context] = None
                 ) -> DisaggResult:
        """Serve one request end to end (blocking — callers thread). One
        trace per request: ``trace_ctx`` (from the wire) names it, else a
        fresh one; ``serve/route`` is its span here, and the result's
        ``trace_id`` names the trace."""
        deadline = time.monotonic() + timeout_s
        trace_id = trace_ctx[0] if trace_ctx is not None \
            else _spans.gen_id()
        route_span = _spans.gen_id()
        t0 = time.perf_counter_ns()
        try:
            res = self._generate(prompt, max_new_tokens, deadline,
                                 sampling, (trace_id, route_span))
        finally:
            attrs = {"router": "disagg"}
            if trace_ctx is not None:
                attrs["remote_parent"] = True
            _spans.record(
                "serve/route", t0, time.perf_counter_ns() - t0,
                trace=trace_id, span_id=route_span,
                parent=trace_ctx[1] if trace_ctx is not None else None,
                attrs=attrs)
        res.trace_id = trace_id
        return res

    def _generate(self, prompt, max_new_tokens, deadline, sampling,
                  ctx: _spans.Context) -> DisaggResult:
        if not self.prefill_fleet or not self.decode_fleet:
            return self._colocated(prompt, max_new_tokens, deadline,
                                   sampling, "no_phase_fleet", ctx)
        # -- phase 1: prefill to the first token ------------------------
        pr = self._pick(self.prefill_fleet)
        blob = (self.prefix_index.fetch(prompt, "prefill")
                if self.prefix_index is not None else None)
        try:
            preq = pr.scheduler.submit(
                prompt, max_new_tokens=max_new_tokens,
                timeout_s=_left(deadline), sampling=sampling,
                prefill_only=True, prefix_blob=blob, trace_ctx=ctx)
        except Exception:
            return self._colocated(prompt, max_new_tokens, deadline,
                                   sampling, "prefill_refused", ctx)
        pr.wake()
        preq.wait(timeout=_left(deadline) + 1.0)
        if preq.state != "done" or preq.handoff is None:
            return self._colocated(prompt, max_new_tokens, deadline,
                                   sampling, "prefill_failed", ctx)
        first = preq.tokens[0]
        if max_new_tokens <= 1:
            self._count("migrated")           # nothing left to decode
            return DisaggResult([first], preq.ttft_ms,
                                list(preq.token_times), "done",
                                migrated=True, handoff_ms=0.0)
        # -- phase 2: migrate the KV, decode the rest -------------------
        t_h0 = time.monotonic()
        dr = self._pick(self.decode_fleet)
        try:
            dreq = dr.scheduler.submit_handoff(
                preq.handoff, first, max_new_tokens=max_new_tokens,
                timeout_s=_left(deadline), sampling=sampling, prompt=prompt)
        except Exception:
            return self._colocated(prompt, max_new_tokens, deadline,
                                   sampling, "handoff_refused", ctx)
        dr.wake()
        dreq.wait(timeout=_left(deadline) + 1.0)
        if dreq.state != "done":
            return self._colocated(prompt, max_new_tokens, deadline,
                                   sampling, "decode_failed", ctx)
        handoff_ms = ((dreq.token_times[1] - t_h0) * 1e3
                      if len(dreq.token_times) > 1 else 0.0)
        self._count("migrated")
        return DisaggResult(list(dreq.tokens), preq.ttft_ms,
                            list(dreq.token_times), "done",
                            migrated=True, handoff_ms=handoff_ms)

    def _count(self, what: str) -> None:
        with self._count_lock:
            setattr(self, what, getattr(self, what) + 1)

    def _colocated(self, prompt, max_new_tokens, deadline, sampling,
                   reason: str, ctx: _spans.Context) -> DisaggResult:
        """Degrade, never drop: the whole request again on the fallback
        fleet, in the same trace."""
        smetrics.m_disagg_fallback.labels(reason).inc()
        self._count("fallbacks")
        fleet = self._fallback_fleet()
        if not fleet:
            return DisaggResult([], None, [], "failed",
                                error="no replica can serve",
                                fallback_reason=reason)
        rep = self._pick(fleet)
        try:
            req = rep.scheduler.submit(
                prompt, max_new_tokens=max_new_tokens,
                timeout_s=_left(deadline), sampling=sampling,
                trace_ctx=ctx)
        except Exception as e:
            return DisaggResult([], None, [], "failed",
                                error=f"{type(e).__name__}: {e}",
                                fallback_reason=reason)
        rep.wake()
        req.wait(timeout=_left(deadline) + 1.0)
        return DisaggResult(list(req.tokens), req.ttft_ms,
                            list(req.token_times), req.state,
                            error=req.error, fallback_reason=reason)


def _left(deadline: float) -> float:
    """Seconds to ``deadline``, at least 0.1."""
    return max(0.1, deadline - time.monotonic())
