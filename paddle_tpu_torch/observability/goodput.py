"""Goodput ledger: attribute every wall-second of a run — the port of
``paddle_tpu/observability/goodput.py``, with its categories, its
exclusive-time timers and its on-disk reports (``goodput.rank<R>.<pid>
.json``, ``GOODPUT.json``, the Prometheus textfiles) unchanged, so either
package reads the other's files.

The ledger classifies a run's wall-clock into a fixed category taxonomy:

    productive_step   dispatching + executing training/serving steps
    compile           one-time start-up work before steady state. The
                      port has no XLA compile; its counterpart is the
                      kernel library's build or load (``ops/_build.py``)
                      and a train step's first call (torch's lazy
                      imports, cuBLAS set-up, the first kernel use:
                      9.5-11.1 s on the H100, PERF.md) — the hang
                      watchdog's suspend windows (``health.suspend``) —
                      and the worker's model and step bring-up. So a
                      port GOODPUT.json reads as the reference's does.
    checkpoint_save   synchronous part of checkpoint saves (host snapshot
                      + commit waits; the async writer overlaps steps and
                      burns no main-thread wall)
    restore           checkpoint restore + resharding on entry/rollback
    restart_downtime  gang-level: failure detection -> respawn complete
                      (supervisor-attributed; a SIGKILL'd worker cannot
                      report its own death)
    rollback_replay   divergence-guardrail skip restores and rollbacks
    input_stall       the train loop blocked on its input
    device_wait       blocking device->host fetch materialization
    drain             serving drain windows (refuse-new, finish-in-flight)
    other             the unaccounted remainder

Accounting model — exclusive time on a timer stack: ``timer(category)``
nests; a child's wall time is subtracted from its parent, so nested
``compile``-inside-``productive_step`` splits correctly and the category
totals sum EXACTLY to covered wall time.  A run window
(:meth:`GoodputLedger.run_window`) anchors the wall clock: at window exit
the uncovered remainder becomes ``other`` and the window total lands in
``paddle_goodput_wall_seconds_total``, so

    sum(paddle_goodput_seconds_total{category=*}) == wall   (by
    construction).

Per-rank export: when the launcher exports ``PADDLE_GOODPUT_DIR``
(:data:`ENV_DIR`), :func:`maybe_export` writes ``goodput.rank<R>.<pid>.json``
plus a per-rank Prometheus textfile at window exit;
``parallel/launch.py`` merges those with its own restart-downtime record
into one gang ``GOODPUT.json`` + merged exposition (see
:func:`write_gang_report` and ``paddle_tpu_torch.tools.goodput_report``).
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics as _metrics

__all__ = [
    "CATEGORIES", "ENV_DIR", "GoodputLedger", "ledger", "timer",
    "attribute", "maybe_export", "merge_reports", "write_gang_report",
]

CATEGORIES = (
    "productive_step", "compile", "checkpoint_save", "restore",
    "restart_downtime", "rollback_replay", "input_stall", "device_wait",
    "drain", "other",
)

ENV_DIR = "PADDLE_GOODPUT_DIR"

# the numerator of the goodput fraction: wall-seconds spent doing the work
# the job exists to do
_PRODUCTIVE = ("productive_step",)


class GoodputLedger:
    """Per-process wall-clock ledger with exclusive-time timers."""

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None):
        reg = registry or _metrics.default_registry()
        self._m = reg.counter(
            "paddle_goodput_seconds_total",
            "Run wall-clock attributed by category (docs/observability.md)",
            ("category",))
        # pre-resolve every child so the exposition always carries the full
        # taxonomy
        self._children = {c: self._m.labels(c) for c in CATEGORIES}
        self._m_wall = reg.counter(
            "paddle_goodput_wall_seconds_total",
            "Total run-window wall seconds (== sum over categories)")
        self._lock = threading.Lock()
        self._totals = {c: 0.0 for c in CATEGORIES}
        self._tls = threading.local()
        # depth-0 covered nanoseconds (any thread) — the window's
        # accounted share
        self._covered_ns = 0
        self._window_t0: Optional[int] = None
        self._window_covered0 = 0
        self._window_snap: Dict[str, float] = {}
        self.last_window: Optional[Dict[str, Any]] = None

    # -- attribution -------------------------------------------------------
    def attribute(self, category: str, seconds: float,
                  covered: bool = False) -> None:
        """Directly add ``seconds`` to a category (supervisor restart
        windows and other externally-timed spans).  ``covered=True`` also
        counts it against the open window's accounted share.

        Hot-path cost model: no lock — CPython container ops are atomic
        enough for monotonically increasing telemetry (the registry's own
        contract); a cross-thread race can only under-count by one
        increment."""
        if seconds <= 0:
            return
        t = self._totals
        t[category] = t.get(category, 0.0) + seconds
        child = self._children.get(category)
        if child is None:
            child = self._children.setdefault(
                category, self._m.labels(category))
        child.inc(seconds)
        if covered:
            self._covered_ns += int(seconds * 1e9)

    class _Timer:
        """Exclusive-time stack frame (a slotted class, not a
        contextlib generator — this sits on the dispatch fast path)."""

        __slots__ = ("ledger", "category", "frame", "stack")

        def __init__(self, ledger, category):
            self.ledger = ledger
            self.category = category

        def __enter__(self):
            led = self.ledger
            stack = getattr(led._tls, "stack", None)
            if stack is None:
                stack = led._tls.stack = []
            self.stack = stack
            self.frame = [time.perf_counter_ns(), 0]  # t0, child_ns
            stack.append((self.category, self.frame))
            return self

        def __exit__(self, *exc):
            now = time.perf_counter_ns()
            led = self.ledger
            stack = self.stack
            stack.pop()
            dt = now - self.frame[0]
            self_ns = dt - self.frame[1]
            if self_ns < 0:
                self_ns = 0
            if stack:
                stack[-1][1][1] += dt
            else:
                led._covered_ns += dt
            led.attribute(self.category, self_ns / 1e9)
            return False

    def timer(self, category: str) -> "GoodputLedger._Timer":
        """Exclusive-time timer: nested timers steal their wall time from
        the enclosing frame, so totals never double-count."""
        return GoodputLedger._Timer(self, category)

    # -- run window --------------------------------------------------------
    def start_window(self) -> bool:
        """Open the wall-clock window (idempotent: a nested open is a
        no-op returning False, and the matching end must be skipped)."""
        if self._window_t0 is not None:
            return False
        self._window_t0 = time.perf_counter_ns()
        self._window_covered0 = self._covered_ns
        self._window_snap = self.totals()
        return True

    def end_window(self, extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """Close the window: the uncovered remainder becomes ``other``,
        the wall total lands in the registry, and the window's per-category
        breakdown (delta vs open) is returned as a report dict."""
        if self._window_t0 is None:
            raise RuntimeError("goodput window is not open")
        wall_ns = time.perf_counter_ns() - self._window_t0
        covered_ns = self._covered_ns - self._window_covered0
        other_s = max(0.0, (wall_ns - covered_ns) / 1e9)
        self.attribute("other", other_s, covered=True)
        wall_s = wall_ns / 1e9
        self._m_wall.inc(wall_s)
        snap0, self._window_t0 = self._window_snap, None
        cur = self.totals()
        cats = {c: round(cur.get(c, 0.0) - snap0.get(c, 0.0), 6)
                for c in CATEGORIES}
        productive = sum(cats[c] for c in _PRODUCTIVE)
        report = {
            "wall_s": round(wall_s, 6),
            "categories": cats,
            "goodput_fraction": round(productive / wall_s, 6)
            if wall_s > 0 else None,
            "unaccounted_fraction": round(cats["other"] / wall_s, 6)
            if wall_s > 0 else None,
            "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0")),
            "pid": os.getpid(),
            "time": time.time(),
        }
        if extra:
            report.update(extra)
        self.last_window = report
        return report

    @contextlib.contextmanager
    def run_window(self, export: bool = True,
                   extra: Optional[Dict[str, Any]] = None):
        """``with ledger.run_window():`` around a run's driving loop.
        Reentrant (the inner open is a no-op); on exit the window report
        is exported per-rank when :data:`ENV_DIR` is set."""
        opened = self.start_window()
        try:
            yield self
        finally:
            if opened:
                report = self.end_window(extra=extra)
                if export:
                    maybe_export(report)

    # -- introspection -----------------------------------------------------
    def category_seconds(self, category: str,
                         include_open: bool = False) -> float:
        """Cumulative seconds attributed to one category."""
        return self.totals(include_open=include_open).get(category, 0.0)

    def totals(self, include_open: bool = False) -> Dict[str, float]:
        """Cumulative seconds per category.  ``include_open=True`` adds
        the elapsed self-time of timers currently open on the CALLING
        thread (the TrainMonitor's per-step breakdown needs the enclosing
        step timer's in-flight share)."""
        with self._lock:
            out = dict(self._totals)
        if include_open:
            stack = getattr(self._tls, "stack", None)
            if stack:
                now = time.perf_counter_ns()
                for cat, (t0, child_ns) in stack:
                    out[cat] = out.get(cat, 0.0) \
                        + max(0, now - t0 - child_ns) / 1e9
        return out


_default = GoodputLedger()


def ledger() -> GoodputLedger:
    return _default


def timer(category: str):
    return _default.timer(category)


def attribute(category: str, seconds: float, **kw) -> None:
    _default.attribute(category, seconds, **kw)


# ---------------------------------------------------------------------------
# Per-rank export + gang aggregation
# ---------------------------------------------------------------------------

def maybe_export(report: Dict[str, Any],
                 dirname: Optional[str] = None) -> Optional[str]:
    """Write the window report (plus this rank's Prometheus exposition)
    into the launcher's shared goodput dir.  No-op when neither
    ``dirname`` nor :data:`ENV_DIR` names one.  File names carry rank AND
    pid so a restarted incarnation never clobbers its predecessor."""
    d = dirname or os.environ.get(ENV_DIR)
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        rank = report.get("rank", 0)
        base = os.path.join(d, f"goodput.rank{rank}.{os.getpid()}")
        tmp = base + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, base + ".json")
        from . import prom

        prom.write_textfile(base + ".prom")
        return base + ".json"
    except OSError:
        return None


def merge_reports(reports: List[Dict[str, Any]],
                  restart_downtime_s: float = 0.0,
                  nranks: Optional[int] = None) -> Dict[str, Any]:
    """Merge per-rank window reports into one gang ledger.

    Semantics: per-rank category seconds sum;
    ``restart_downtime_s`` (the supervisor's failure-detect -> respawn
    windows) is charged once per rank — the whole gang is idle while a
    gang restart is in flight — so gang seconds stay comparable to
    ``nranks x job wall``.  The gang goodput fraction is productive
    seconds over all attributed seconds."""
    nranks = nranks or max(1, len({r.get("rank", 0) for r in reports}))
    cats = {c: 0.0 for c in CATEGORIES}
    wall = 0.0
    for r in reports:
        wall += float(r.get("wall_s", 0.0))
        for c, v in (r.get("categories") or {}).items():
            cats[c] = cats.get(c, 0.0) + float(v)
    downtime_total = restart_downtime_s * nranks
    cats["restart_downtime"] += downtime_total
    wall += downtime_total
    total = sum(cats.values())
    productive = sum(cats[c] for c in _PRODUCTIVE)
    return {
        "nranks": nranks,
        "rank_reports": len(reports),
        "wall_s": round(wall, 6),
        "categories": {c: round(v, 6) for c, v in cats.items()},
        "restart_downtime_s": round(restart_downtime_s, 6),
        "gang_goodput_fraction": round(productive / total, 6)
        if total > 0 else None,
        "unaccounted_fraction": round(cats["other"] / total, 6)
        if total > 0 else None,
    }


def write_gang_report(dirname: str, restart_downtime_s: float = 0.0,
                      nranks: Optional[int] = None,
                      extra: Optional[Dict[str, Any]] = None,
                      out_path: Optional[str] = None) -> Optional[str]:
    """Supervisor-side aggregation: merge every ``goodput.rank*.json``
    under ``dirname`` (plus the per-rank prom textfiles into one gang
    exposition) and write ``GOODPUT.json``.  Returns its path, or None
    when no rank ever reported."""
    rank_files = sorted(glob.glob(
        os.path.join(dirname, "goodput.rank*.json")))
    reports = []
    for p in rank_files:
        try:
            with open(p) as f:
                reports.append(json.load(f))
        except (OSError, ValueError):
            continue
    if not reports and restart_downtime_s <= 0:
        return None
    gang = merge_reports(reports, restart_downtime_s=restart_downtime_s,
                         nranks=nranks)
    gang["rank_files"] = [os.path.basename(p) for p in rank_files]
    if extra:
        gang.update(extra)
    prom_files = sorted(glob.glob(
        os.path.join(dirname, "goodput.rank*.prom")))
    if prom_files:
        from . import prom

        texts = []
        for p in prom_files:
            try:
                with open(p) as f:
                    texts.append(f.read())
            except OSError:
                continue
        merged = prom.merge_expositions(texts)
        gang_prom = os.path.join(dirname, "gang_metrics.prom")
        with open(gang_prom, "w") as f:
            f.write(merged)
        gang["gang_exposition"] = gang_prom
    out_path = out_path or os.path.join(dirname, "GOODPUT.json")
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(gang, f, indent=1)
    os.replace(tmp, out_path)
    return out_path
