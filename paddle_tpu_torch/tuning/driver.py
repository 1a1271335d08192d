"""Autotune search driver — the port of ``paddle_tpu/tuning/driver.py``.

Successive halving over a pre-enumerated candidate pool:

1. every enumeration-time refusal is counted as pruned (the validity
   predicates in space.py mirror the port's own refusals);
2. the INCUMBENT is probed first at the cheapest rung — its program
   report anchors the static model;
3. ``static_fn`` prunes candidates predicted ``static_margin`` worse
   than the incumbent's own estimate, or over the device-memory budget —
   those never run a probe;
4. survivors go through the rung ladder ``((steps, keep_frac), ...)``:
   wide cheap probes, then narrow long probes; the incumbent is never
   halved out (the final comparison must be against the committed
   defaults, measured at full length);
5. the winner must beat the incumbent by ``improve_margin``, else the
   incumbent stays — TUNED.json then reproduces the defaults and
   perf_diff arbitration is an A/A check.

Every probe appends one JSONL line to the :class:`ProbeLog` (flushed and
fsynced a line at a time), so a SIGKILL mid-tune resumes: completed
``(space, rung, key)`` probes return their cached result WITHOUT
re-running and WITHOUT re-incrementing ``paddle_autotune_probes_total``
— the probe count is conserved across the kill, and a torn tail line is
skipped. Each executed probe runs inside an ``autotune/probe`` span
(``observability/spans.py``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..observability import metrics as _metrics
from ..observability import spans as _spans
from .space import Candidate
from .static_cost import StaticEstimate

__all__ = ["ProbeLog", "TuneResult", "tune", "PROBES_TOTAL",
           "PRUNED_TOTAL", "DEFAULT_RUNGS"]

_REG = _metrics.default_registry()
# executed probes only — cached resume hits do NOT increment
PROBES_TOTAL = _REG.counter(
    "paddle_autotune_probes_total",
    "Measured autotune probes executed", ("phase",))
PRUNED_TOTAL = _REG.counter(
    "paddle_autotune_pruned_total",
    "Autotune candidates pruned before/without a full measurement",
    ("reason",))

DEFAULT_RUNGS: Tuple[Tuple[int, float], ...] = ((2, 0.5), (4, 1.0))


class ProbeLog:
    """Append-only JSONL of probes + prunes; the resume index.

    Line shapes::

        {"kind": "probe", "probe_id": "...", "space": "...", "rung": 0,
         "steps": 2, "key": "...", "result": {...}, "executed": true}
        {"kind": "pruned", "space": "...", "key": "...", "reason": "..."}
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._probes: Dict[Tuple[str, int, str], Dict[str, Any]] = {}
        self._probe_ids: Dict[Tuple[str, int, str], str] = {}
        self._pruned: set = set()           # (space, key) already logged
        self._count = 0
        self._fh = None
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue            # torn tail line from the kill
                    if rec.get("kind") == "probe":
                        k = (rec["space"], int(rec["rung"]), rec["key"])
                        self._probes[k] = rec.get("result") or {}
                        self._probe_ids[k] = rec.get("probe_id", "")
                        self._count += 1
                    elif rec.get("kind") == "pruned":
                        self._pruned.add((rec.get("space", ""),
                                          rec["key"]))
        if path:
            self._fh = open(path, "a")

    @property
    def completed_probes(self) -> int:
        return self._count

    def _emit(self, rec: Dict[str, Any]) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def cached(self, space: str, rung: int, key: str):
        return self._probes.get((space, rung, key))

    def probe_id(self, space: str, rung: int, key: str) -> str:
        return self._probe_ids.get((space, rung, key), "")

    def record_probe(self, space: str, rung: int, steps: int, key: str,
                     result: Dict[str, Any]) -> str:
        self._count += 1
        pid = f"{space}-r{rung}-{self._count:04d}"
        k = (space, rung, key)
        self._probes[k] = result
        self._probe_ids[k] = pid
        self._emit({"kind": "probe", "probe_id": pid, "space": space,
                    "rung": rung, "steps": steps, "key": key,
                    "result": _jsonable(result), "executed": True})
        return pid

    def seen_pruned(self, space: str, key: str) -> bool:
        return (space, key) in self._pruned

    def record_pruned(self, space: str, key: str, reason: str) -> None:
        self._pruned.add((space, key))
        self._emit({"kind": "pruned", "space": space, "key": key,
                    "reason": reason})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _jsonable(v):
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, float) and math.isinf(v):
        return "inf"
    return v


def _score(result: Dict[str, Any]) -> float:
    s = result.get("score")
    if s == "inf" or s is None:
        return float("inf")
    return float(s)


@dataclasses.dataclass
class TuneResult:
    space: str
    winner: Candidate
    incumbent: Candidate
    improved: bool                    # winner beat incumbent by margin
    results: Dict[str, Dict[str, Any]]      # key -> last-rung result
    static: Dict[str, StaticEstimate]       # key -> static estimate
    pruned: Dict[str, int]                  # reason -> count (this run)
    probes_executed: int                    # this process, not cached
    probe_ids: Dict[str, List[str]]         # key -> probe ids (all rungs)
    rungs: Tuple[Tuple[int, float], ...]

    @property
    def winner_result(self) -> Dict[str, Any]:
        return self.results.get(self.winner.key, {})


def tune(*, space: str, candidates: Sequence[Candidate],
         refusals: Sequence[Tuple[Candidate, str]] = (),
         incumbent: Candidate,
         probe_fn: Callable[[Candidate, int, int], Dict[str, Any]],
         static_fn: Optional[Callable[
             [Candidate, Dict[str, Any]], Optional[StaticEstimate]]] = None,
         rungs: Tuple[Tuple[int, float], ...] = DEFAULT_RUNGS,
         improve_margin: float = 0.03, static_margin: float = 0.20,
         log: Optional[ProbeLog] = None, phase: Optional[str] = None,
         progress: Optional[Callable[[str], None]] = None) -> TuneResult:
    """Run one space's tune. ``probe_fn(cand, steps, rung)`` returns a
    result dict whose ``score`` is lower-better; ``static_fn(cand,
    incumbent_result)`` returns a :class:`StaticEstimate` (or None to
    skip static pruning for that candidate)."""
    log = log or ProbeLog(None)
    phase = phase or space
    say = progress or (lambda m: None)
    pruned: Dict[str, int] = {}
    probe_ids: Dict[str, List[str]] = {}
    executed = 0

    def count_pruned(cand: Candidate, reason: str) -> None:
        if log.seen_pruned(space, cand.key):
            return                      # resumed run: already counted
        log.record_pruned(space, cand.key, reason)
        pruned[reason] = pruned.get(reason, 0) + 1
        PRUNED_TOTAL.labels(reason).inc()

    def probe(cand: Candidate, steps: int, rung: int) -> Dict[str, Any]:
        nonlocal executed
        cached = log.cached(space, rung, cand.key)
        if cached is not None:
            pid = log.probe_id(space, rung, cand.key)
            if pid:
                probe_ids.setdefault(cand.key, []).append(pid)
            return cached
        with _spans.span("autotune/probe",
                         attrs={"space": space, "rung": rung,
                                "steps": steps, "key": cand.key,
                                "phase": phase}):
            try:
                result = probe_fn(cand, steps, rung)
            except Exception as e:      # a crashing candidate loses,
                result = {"score": float("inf"),   # not the whole tune
                          "error": f"{type(e).__name__}: {e}"}
        PROBES_TOTAL.labels(phase).inc()
        executed += 1
        pid = log.record_probe(space, rung, steps, cand.key, result)
        probe_ids.setdefault(cand.key, []).append(pid)
        return result

    for cand, reason in refusals:
        count_pruned(cand, reason)

    # rung 0 for the incumbent first: its result anchors the static model
    r0_steps = rungs[0][0]
    inc_result = probe(incumbent, r0_steps, 0)
    results: Dict[str, Dict[str, Any]] = {incumbent.key: inc_result}

    pool: List[Candidate] = [c for c in candidates
                             if c.key != incumbent.key]
    static: Dict[str, StaticEstimate] = {}
    if static_fn is not None:
        inc_est = static_fn(incumbent, inc_result)
        if inc_est is not None:
            static[incumbent.key] = inc_est
        survivors: List[Candidate] = []
        for c in pool:
            est = static_fn(c, inc_result)
            if est is None:
                survivors.append(c)
                continue
            static[c.key] = est
            if est.over_hbm:
                count_pruned(c, "over_hbm")
            elif inc_est is not None and \
                    est.ms > inc_est.ms * (1.0 + static_margin):
                count_pruned(c, "static_worse")
            else:
                survivors.append(c)
        say(f"[{space}] static: {len(pool) - len(survivors)} pruned, "
            f"{len(survivors)} survivors")
        pool = survivors

    # successive halving; incumbent rides every rung but is never dropped
    for rung, (steps, keep_frac) in enumerate(rungs):
        if rung == 0:
            results[incumbent.key] = inc_result
        else:
            results[incumbent.key] = probe(incumbent, steps, rung)
        scored: List[Tuple[float, Candidate]] = []
        for c in pool:
            res = probe(c, steps, rung)
            results[c.key] = res
            scored.append((_score(res), c))
        scored.sort(key=lambda t: t[0])
        keep = max(1, math.ceil(len(scored) * keep_frac)) \
            if keep_frac < 1.0 else len(scored)
        if rung < len(rungs) - 1:
            dropped = scored[keep:]
            pool = [c for _, c in scored[:keep]]
            for s, c in dropped:
                count_pruned(c, "measured_worse")
        else:
            # terminal rung: everyone measured at full length; inf-score
            # candidates (SLO fail / crash) are measured rejections
            for s, c in scored:
                if math.isinf(s):
                    count_pruned(c, "measured_worse")
        say(f"[{space}] rung {rung} ({steps} steps): "
            f"{len(scored)} probed")

    inc_score = _score(results[incumbent.key])
    best = min(pool, key=lambda c: _score(results[c.key]), default=None)
    improved = (best is not None
                and _score(results[best.key])
                < inc_score * (1.0 - improve_margin))
    winner = best if improved else incumbent
    say(f"[{space}] winner: {winner.key} "
        f"({'improved' if improved else 'incumbent stays'})")
    return TuneResult(space=space, winner=winner, incumbent=incumbent,
                      improved=improved, results=results, static=static,
                      pruned=pruned, probes_executed=executed,
                      probe_ids=probe_ids, rungs=tuple(rungs))
