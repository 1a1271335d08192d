"""Live SLO engine — the port of ``paddle_tpu/observability/slo.py``.

Declarative serving objectives evaluated over rolling windows, with the
Google-SRE multi-window burn-rate alerting shape: every request reduces
to a good/bad event per objective (a TTFT sample above the p99 target is
"bad" for the TTFT objective; a 5xx is "bad" for the error-rate
objective), the burn rate over a window is ``bad_fraction / budget``,
and an alert fires only when BOTH the fast window (seconds — catches a
cliff) and the slow window (minutes — rejects blips) burn above their
thresholds.  Alerts are latched per objective: one breach = one alert
(+ one forensic dump), re-armed only after the fast window recovers.

The error-budget ledger (cumulative good/bad per objective) survives
warm restarts through the port's :class:`~..parallel.checkpoint.
ElasticCheckpointer` — a recycled gang supervisor resumes its budget
accounting instead of forgetting the bad minutes that preceded the
crash.

:meth:`SLOEngine.slo_status` is the machine-readable signal surface an
autoscaler or autotuner consumes: one dict with per-objective measured
values, burn rates, alert state, and remaining error budget.

Slow-request forensics: when an alert fires, the engine dumps the worst
recent request's trace (from the span tracer's ring) plus a
caller-supplied scheduler/engine state snapshot into a bounded
:class:`ForensicDir`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import metrics as _obs
from . import spans as _spans

__all__ = [
    "Objective", "DEFAULT_OBJECTIVES", "SLOEngine", "ForensicDir",
    "slo_status", "default_engine", "set_default_engine",
]

_REG = _obs.default_registry()

m_slo_alerts = _REG.counter(
    "paddle_slo_alerts_total",
    "SLO burn-rate alerts fired, by objective and window pair",
    ("objective", "window"))
m_slo_burn = _REG.gauge(
    "paddle_slo_burn_rate",
    "Error-budget burn rate (bad_fraction / budget) per window",
    ("objective", "window"))
m_slo_ok = _REG.gauge(
    "paddle_slo_ok",
    "1 when every objective currently meets its target, else 0")
m_slo_budget = _REG.gauge(
    "paddle_slo_budget_remaining",
    "Cumulative error budget remaining (1 = untouched, <0 = overdrawn)",
    ("objective",))
m_slo_forensics = _REG.counter(
    "paddle_slo_forensic_dumps_total",
    "Slow-request / breach forensic dumps written")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective.

    ``signal`` picks the per-request reduction:

    - ``ttft_ms`` / ``tpot_ms`` — latency: a sample above ``target``
      (ms) is a bad event; the windowed ``percentile`` is also reported
      and compliance is ``pct(window) <= target``.
    - ``error_rate`` — non-2xx outcomes (sheds excluded; they are their
      own objective).  ``target`` is the max allowed fraction.
    - ``shed_rate`` — requests rejected by overload control.
    - ``availability`` — 1 - (errors + sheds) fraction; ``target`` is
      the MIN allowed (e.g. 0.99).

    ``budget`` is the allowed bad-event fraction the burn rate divides
    by; latency objectives default it from the percentile (p99 -> 1%),
    rate objectives from ``target``.
    """

    name: str
    signal: str
    target: float
    percentile: Optional[float] = None
    budget: Optional[float] = None

    def resolved_budget(self) -> float:
        if self.budget is not None:
            return float(self.budget)
        if self.percentile is not None:
            return max(1e-6, 1.0 - self.percentile / 100.0)
        if self.signal == "availability":
            return max(1e-6, 1.0 - self.target)
        return max(1e-6, float(self.target))

    def is_bad(self, sample: dict) -> Optional[bool]:
        """True/False = the sample counts against/for this objective;
        None = the sample carries no signal for it (e.g. a shed request
        has no TTFT)."""
        if self.signal in ("ttft_ms", "tpot_ms"):
            v = sample.get(self.signal)
            if v is None:
                return None
            return float(v) > self.target
        if self.signal == "error_rate":
            return bool(sample.get("error"))
        if self.signal == "shed_rate":
            return bool(sample.get("shed"))
        if self.signal == "availability":
            return bool(sample.get("error") or sample.get("shed"))
        raise ValueError(f"unknown SLO signal {self.signal!r}")


DEFAULT_OBJECTIVES = (
    Objective("ttft_p99", "ttft_ms", target=500.0, percentile=99.0),
    Objective("tpot_p50", "tpot_ms", target=50.0, percentile=50.0),
    Objective("error_rate", "error_rate", target=0.01),
    Objective("shed_rate", "shed_rate", target=0.05),
    Objective("availability", "availability", target=0.99),
)


class ForensicDir:
    """Bounded JSON dump directory: every
    :meth:`dump` writes one pretty-printed file; past ``keep`` files the
    oldest is deleted, so a breach storm can never fill a disk."""

    def __init__(self, dirname: str, keep: int = 16):
        self.dirname = str(dirname)
        self.keep = int(keep)
        self._n = 0
        self._lock = threading.Lock()
        os.makedirs(self.dirname, exist_ok=True)

    def dump(self, tag: str, payload: Dict[str, Any]) -> str:
        with self._lock:
            self._n += 1
            path = os.path.join(self.dirname,
                                f"forensic-{self._n:06d}-{tag}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, default=str)
            os.replace(tmp, path)
            self._gc()
        m_slo_forensics.inc()
        return path

    def _gc(self) -> None:
        files = sorted(f for f in os.listdir(self.dirname)
                       if f.startswith("forensic-")
                       and f.endswith(".json"))
        for f in files[:max(0, len(files) - self.keep)]:
            try:
                os.unlink(os.path.join(self.dirname, f))
            except OSError:
                pass

    def files(self) -> List[str]:
        return sorted(f for f in os.listdir(self.dirname)
                      if f.startswith("forensic-")
                      and f.endswith(".json"))


class SLOEngine:
    """Rolling-window SLO evaluation + burn-rate alerting + persistent
    error-budget ledger.

    Feed it one :meth:`note_request` per terminal request (the gang
    front door / fleet poller does this); call :meth:`evaluate` on an
    interval (the fleet poller's tick) or on demand.  Timestamps may be
    passed explicitly for deterministic tests."""

    def __init__(self, objectives=DEFAULT_OBJECTIVES,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0,
                 fast_burn_threshold: float = 14.0,
                 slow_burn_threshold: float = 2.0,
                 min_events: int = 8,
                 ledger_dir: Optional[str] = None,
                 forensics: Optional[ForensicDir] = None,
                 state_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 ring: int = 4096):
        self.objectives = tuple(objectives)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.slow_burn_threshold = float(slow_burn_threshold)
        # below this many samples in the fast window no alert can fire —
        # one bad request at boot is not a burn, it is noise
        self.min_events = int(min_events)
        self.forensics = forensics
        self.state_fn = state_fn
        self._samples: deque = deque(maxlen=int(ring))
        self._lock = threading.Lock()
        # cumulative ledger: objective -> [bad, total] (ints)
        self._ledger: Dict[str, List[int]] = {
            o.name: [0, 0] for o in self.objectives}
        self.alerts_total: Dict[str, int] = {}
        self._alerted: Dict[str, bool] = {}      # latch per objective
        self._ck = None
        self._ck_step = 0
        if ledger_dir is not None:
            from ..parallel.checkpoint import ElasticCheckpointer

            self._ck = ElasticCheckpointer(str(ledger_dir),
                                           use_async=False, keep_last=3)
            self._restore_ledger()

    # -- ingestion -----------------------------------------------------
    def note_request(self, ttft_ms: Optional[float] = None,
                     tpot_ms: Optional[float] = None,
                     code: Any = 200, shed: bool = False,
                     trace_id: Optional[int] = None,
                     request_id: Any = None,
                     t: Optional[float] = None) -> None:
        """One terminal request outcome.  ``code`` is the HTTP-style
        result; ``shed`` marks overload rejections (429/503 by policy —
        they spend the shed budget, not the error budget)."""
        try:
            code_i = int(code)
        except (TypeError, ValueError):
            code_i = 500
        sample = {
            "t": time.monotonic() if t is None else float(t),
            "ttft_ms": None if ttft_ms is None else float(ttft_ms),
            "tpot_ms": None if tpot_ms is None else float(tpot_ms),
            "error": (not shed) and not (200 <= code_i < 300),
            "shed": bool(shed),
            "code": code_i,
            "trace_id": trace_id,
            "request_id": request_id,
        }
        with self._lock:
            self._samples.append(sample)
            for o in self.objectives:
                bad = o.is_bad(sample)
                if bad is None:
                    continue
                row = self._ledger[o.name]
                row[0] += int(bad)
                row[1] += 1

    # -- evaluation ----------------------------------------------------
    def _window(self, now: float, seconds: float) -> List[dict]:
        lo = now - seconds
        return [s for s in self._samples if s["t"] >= lo]

    @staticmethod
    def _measure(o: Objective, win: List[dict]):
        """(measured_value, bad, total) for one objective over a window."""
        flags = [(s, o.is_bad(s)) for s in win]
        flags = [(s, b) for s, b in flags if b is not None]
        total = len(flags)
        bad = sum(1 for _s, b in flags if b)
        if o.signal in ("ttft_ms", "tpot_ms"):
            vals = [s[o.signal] for s, _b in flags]
            measured = (float(np.percentile(vals, o.percentile))
                        if vals else None)
        elif o.signal == "availability":
            measured = (1.0 - bad / total) if total else None
        else:
            measured = (bad / total) if total else None
        return measured, bad, total

    @staticmethod
    def _meets(o: Objective, measured) -> Optional[bool]:
        if measured is None:
            return None
        if o.signal == "availability":
            return measured >= o.target
        return measured <= o.target

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate every objective over the fast/slow windows, update
        the prom gauges, fire latched burn-rate alerts (+ forensics),
        and return the full status dict (see :meth:`slo_status`)."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            fast = self._window(now, self.fast_window_s)
            slow = self._window(now, self.slow_window_s)
            ledger = {k: list(v) for k, v in self._ledger.items()}
        objectives: Dict[str, Any] = {}
        alerts_fired: List[str] = []
        all_ok = True
        for o in self.objectives:
            budget = o.resolved_budget()
            f_meas, f_bad, f_tot = self._measure(o, fast)
            s_meas, s_bad, s_tot = self._measure(o, slow)
            f_burn = (f_bad / f_tot / budget) if f_tot else 0.0
            s_burn = (s_bad / s_tot / budget) if s_tot else 0.0
            meets = self._meets(o, f_meas)
            if meets is False:
                all_ok = False
            burning = (f_tot >= self.min_events
                       and f_burn >= self.fast_burn_threshold
                       and s_burn >= self.slow_burn_threshold)
            fired = False
            if burning and not self._alerted.get(o.name):
                # latched: one alert per excursion, re-armed on recovery
                self._alerted[o.name] = True
                self.alerts_total[o.name] = \
                    self.alerts_total.get(o.name, 0) + 1
                m_slo_alerts.labels(o.name, "fast+slow").inc()
                alerts_fired.append(o.name)
                fired = True
            elif not burning and f_burn < self.fast_burn_threshold:
                self._alerted[o.name] = False
            led_bad, led_tot = ledger[o.name]
            budget_remaining = (1.0 - (led_bad / led_tot) / budget
                                if led_tot else 1.0)
            m_slo_burn.labels(o.name, "fast").set(round(f_burn, 4))
            m_slo_burn.labels(o.name, "slow").set(round(s_burn, 4))
            m_slo_budget.labels(o.name).set(round(budget_remaining, 4))
            objectives[o.name] = {
                "signal": o.signal, "target": o.target,
                "percentile": o.percentile, "budget": budget,
                "measured": (round(f_meas, 4)
                             if f_meas is not None else None),
                "meets_target": meets,
                "burn_rate": {"fast": round(f_burn, 3),
                              "slow": round(s_burn, 3)},
                "events": {"fast": f_tot, "slow": s_tot},
                "alerting": bool(self._alerted.get(o.name)),
                "alert_fired": fired,
                "budget_remaining": round(budget_remaining, 4),
                "ledger": {"bad": led_bad, "total": led_tot},
            }
        m_slo_ok.set(1.0 if all_ok else 0.0)
        status = {
            "ok": all_ok,
            "alerting": sorted(k for k, v in self._alerted.items() if v),
            "alerts_total": dict(self.alerts_total),
            "objectives": objectives,
        }
        for name in alerts_fired:
            self._dump_breach(name, status)
        return status

    def slo_status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The machine-readable signal surface: alias of
        :meth:`evaluate` — evaluation IS the status."""
        return self.evaluate(now)

    # -- forensics -----------------------------------------------------
    def _dump_breach(self, objective: str, status: Dict[str, Any]) -> None:
        if self.forensics is None:
            return
        # the slowest/worst recent offender, with its trace assembled
        # from the local tracer ring — cross-process assembly is
        # paddle_tpu_torch.tools.trace_assemble over the shared trace dir
        with self._lock:
            recent = list(self._samples)[-64:]
        obj = next(o for o in self.objectives if o.name == objective)
        offenders = [s for s in recent if obj.is_bad(s)]
        worst = offenders[-1] if offenders else None
        spans = []
        if worst and worst.get("trace_id") is not None:
            spans = _spans.default_tracer().trace_spans(
                worst["trace_id"])
        payload = {
            "kind": "slo_breach",
            "objective": objective,
            "status": status["objectives"].get(objective),
            "worst_request": worst,
            "trace_spans": spans,
        }
        if self.state_fn is not None:
            try:
                payload["state"] = self.state_fn()
            except Exception as e:
                payload["state_error"] = f"{type(e).__name__}: {e}"
        try:
            self.forensics.dump(objective, payload)
        except Exception:
            pass                    # forensics must never hurt serving

    # -- error-budget ledger persistence -------------------------------
    def checkpoint(self) -> None:
        """Persist the cumulative ledger (atomic COMMIT via the elastic
        checkpointer — the warm-restart half of the budget contract)."""
        if self._ck is None:
            return
        import torch

        with self._lock:
            names = [o.name for o in self.objectives]
            bad = torch.tensor([self._ledger[n][0] for n in names],
                               dtype=torch.int64)
            total = torch.tensor([self._ledger[n][1] for n in names],
                                 dtype=torch.int64)
            alerts = dict(self.alerts_total)
        self._ck.save(self._ck_step, {"bad": bad, "total": total},
                      extra={"objectives": names,
                             "alerts_total": alerts})
        self._ck_step += 1

    def _restore_ledger(self) -> None:
        from ..parallel.checkpoint import CheckpointError

        steps = self._ck.all_steps()
        if not steps:
            return
        try:
            rec, man = self._ck.restore(steps[-1])
        except CheckpointError:
            return
        names = (man.get("extra") or {}).get("objectives") or []
        bad = np.asarray(rec.get("bad", []), np.int64)
        total = np.asarray(rec.get("total", []), np.int64)
        for i, name in enumerate(names):
            if name in self._ledger and i < len(bad):
                self._ledger[name] = [int(bad[i]), int(total[i])]
        self.alerts_total.update(
            (man.get("extra") or {}).get("alerts_total") or {})
        self._ck_step = steps[-1] + 1

    def close(self) -> None:
        self.checkpoint()
        if self._ck is not None:
            self._ck.close()


# -- process-default engine (the gang supervisor installs its own) -------
_default_engine: Optional[SLOEngine] = None
_default_lock = threading.Lock()


def default_engine() -> SLOEngine:
    global _default_engine
    with _default_lock:
        if _default_engine is None:
            _default_engine = SLOEngine()
        return _default_engine


def set_default_engine(engine: Optional[SLOEngine]) -> None:
    global _default_engine
    with _default_lock:
        _default_engine = engine


def slo_status() -> Dict[str, Any]:
    """Module-level signal surface: evaluate the process-default engine
    (the one the gang supervisor installed) and return its status."""
    return default_engine().slo_status()
