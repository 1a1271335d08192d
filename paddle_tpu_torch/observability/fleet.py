"""Live fleet-wide metric aggregation — the port of
``paddle_tpu/observability/fleet.py``.

One gang = many replica processes, each already serving its own
``/metrics`` exposition and heartbeat file.  This module is the
supervisor-side poller that turns those per-process views into ONE live
fleet view:

- a continuously refreshed ``FLEET.json`` (atomic tmp+rename writes, so
  dashboards can tail it safely),
- a merged prom exposition via :func:`prom.merge_expositions` with a
  ``replica``/``role`` label injected per source — per-replica series
  survive the merge while the per-role rollups in FLEET.json answer the
  aggregate question,
- an optional :class:`~.slo.SLOEngine` evaluated every tick so the SLO
  status rides along in the same document.

The poller is transport-agnostic: it calls a ``collect()`` callable
returning one :class:`ReplicaSample` per replica (an HTTP scrape of each
front door's ``/metrics`` and ``/health``, or canned expositions in
tests).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import metrics as _obs
from . import prom as _prom

__all__ = ["ReplicaSample", "FleetPoller", "role_rollups"]

_REG = _obs.default_registry()

m_fleet_alive = _REG.gauge(
    "paddle_fleet_alive_replicas",
    "Live replicas per role, as seen by the fleet poller", ("role",))
m_fleet_polls = _REG.counter(
    "paddle_fleet_polls_total", "Fleet poll ticks completed")
m_fleet_scrape_errors = _REG.counter(
    "paddle_fleet_scrape_errors_total",
    "Replica /metrics scrapes that failed during fleet polls")


@dataclasses.dataclass
class ReplicaSample:
    """One replica's state at one poll tick."""

    index: int
    role: str
    alive: bool
    heartbeat_age_s: Optional[float] = None
    metrics_text: Optional[str] = None
    incarnation: int = 0
    inflight: int = 0


# families rolled up per role in FLEET.json; everything else stays in
# the merged exposition where the replica label distinguishes sources
_ROLLUP_SUM = ("paddle_serve_queue_depth", "paddle_serve_active_requests",
               "paddle_serve_requests_total")
_ROLLUP_MAX = ("paddle_serve_slot_occupancy",)
_ROLLUP_HIST = ("paddle_serve_ttft_ms", "paddle_serve_tpot_ms")


def _parse_samples(text: str):
    """Minimal 0.0.4 exposition parse: yields (name, value) per sample
    line, labels ignored (rollups aggregate across label sets)."""
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        space = line.rfind(" ")
        if space <= 0:
            continue
        name = line[:space]
        brace = name.find("{")
        if brace >= 0:
            name = name[:brace]
        try:
            yield name, float(line[space + 1:])
        except ValueError:
            continue


def role_rollups(samples: Sequence[ReplicaSample]) -> Dict[str, Any]:
    """Per-role aggregate dict: additive families summed, level gauges
    maxed, latency histograms reduced to a mean (p-quantiles live in
    the merged exposition's buckets — a mean is enough for a glance)."""
    roles: Dict[str, Any] = {}
    for s in samples:
        r = roles.setdefault(s.role, {
            "replicas": 0, "alive": 0, "inflight": 0,
            "max_heartbeat_age_s": None, "sums": {}, "maxes": {},
            "hist": {f: [0.0, 0.0] for f in _ROLLUP_HIST},
        })
        r["replicas"] += 1
        r["alive"] += int(s.alive)
        r["inflight"] += int(s.inflight)
        if s.heartbeat_age_s is not None:
            prev = r["max_heartbeat_age_s"]
            r["max_heartbeat_age_s"] = (
                s.heartbeat_age_s if prev is None
                else max(prev, s.heartbeat_age_s))
        if not s.metrics_text:
            continue
        for name, value in _parse_samples(s.metrics_text):
            if name in _ROLLUP_SUM:
                r["sums"][name] = r["sums"].get(name, 0.0) + value
            elif name in _ROLLUP_MAX:
                r["maxes"][name] = max(r["maxes"].get(name, 0.0), value)
            else:
                for fam in _ROLLUP_HIST:
                    if name == fam + "_sum":
                        r["hist"][fam][0] += value
                    elif name == fam + "_count":
                        r["hist"][fam][1] += value
    for r in roles.values():
        r["latency_mean_ms"] = {
            fam: (round(tot / cnt, 3) if cnt else None)
            for fam, (tot, cnt) in r.pop("hist").items()}
        r["sums"] = {k: round(v, 3) for k, v in r["sums"].items()}
        r["maxes"] = {k: round(v, 4) for k, v in r["maxes"].items()}
    return roles


class FleetPoller:
    """Poll ``collect()`` on an interval into FLEET.json + a merged
    exposition.  ``tick()`` may also be driven manually (tests, or the
    gang's request path when it wants a fresh view)."""

    def __init__(self, collect: Callable[[], List[ReplicaSample]],
                 out_path: Optional[str] = None,
                 interval_s: float = 2.0,
                 slo=None,
                 slo_checkpoint_every: int = 10):
        self.collect = collect
        self.out_path = out_path
        self.interval_s = float(interval_s)
        self.slo = slo
        self.slo_checkpoint_every = int(slo_checkpoint_every)
        self._lock = threading.Lock()
        self._last_doc: Dict[str, Any] = {}
        self._last_exposition = ""
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one tick ------------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        try:
            samples = list(self.collect())
        except Exception:
            m_fleet_scrape_errors.inc()
            samples = []
        texts, extra = [], []
        for s in samples:
            if s.metrics_text:
                texts.append(s.metrics_text)
                extra.append([("replica", str(s.index)),
                              ("role", s.role)])
        merged = _prom.merge_expositions(texts, extra_labels=extra) \
            if texts else ""
        roles = role_rollups(samples)
        for role, r in roles.items():
            m_fleet_alive.labels(role).set(r["alive"])
        doc: Dict[str, Any] = {
            "ts": time.time(),
            "n_replicas": len(samples),
            "n_alive": sum(int(s.alive) for s in samples),
            "replicas": [{
                "index": s.index, "role": s.role, "alive": s.alive,
                "heartbeat_age_s": s.heartbeat_age_s,
                "incarnation": s.incarnation, "inflight": s.inflight,
            } for s in samples],
            "roles": roles,
        }
        if self.slo is not None:
            try:
                doc["slo"] = self.slo.evaluate()
            except Exception as e:
                doc["slo_error"] = f"{type(e).__name__}: {e}"
        with self._lock:
            self._ticks += 1
            self._last_doc = doc
            self._last_exposition = merged
            ticks = self._ticks
        if self.out_path:
            tmp = f"{self.out_path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, default=str)
                os.replace(tmp, self.out_path)
            except OSError:
                pass
        if (self.slo is not None and self.slo_checkpoint_every
                and ticks % self.slo_checkpoint_every == 0):
            try:
                self.slo.checkpoint()
            except Exception:
                pass
        m_fleet_polls.inc()
        return doc

    # -- cached views (what GET /fleet serves) -------------------------
    def fleet_doc(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._last_doc)

    def exposition(self) -> str:
        with self._lock:
            return self._last_exposition

    # -- background loop -----------------------------------------------
    def start(self) -> "FleetPoller":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    m_fleet_scrape_errors.inc()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet_poller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.slo is not None:
            try:
                self.slo.checkpoint()
            except Exception:
                pass
