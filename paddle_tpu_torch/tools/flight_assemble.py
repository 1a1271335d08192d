"""Cross-rank blame engine for the training-gang flight recorder — the
port of the JAX package's ``tools/flight_assemble.py``, verdict for
verdict (it reads either package's flight files).

Every rank of a training gang appends typed events to its own
``flight-rank<R>-<pid>.jsonl`` under the gang's shared flight dir
(``observability/flight.py`` sidecars; first line is a ``meta`` record
anchoring the rank's monotonic clock to the wall clock).  When the hang
watchdog kills a wedged gang, this tool merges the surviving per-rank
files and emits a machine-readable verdict:

- **last_common_seq** — the highest host-side collective seq every rank
  entered (ranks agree on seq numbers by construction: identical
  programs, identical step loops);
- **blamed_ranks** — the rank(s) that never entered ``missed_seq =
  last_common_seq + 1`` while a healthy peer did (``never_entered``),
  or that entered the frontier collective but never exited while peers
  did (``stuck_inside`` — death mid-exchange);
- **per-rank stall taxonomy** — what each rank was doing when its file
  went quiet (``data_wait`` / ``compute`` / ``comm`` / ``checkpoint``),
  mapped onto the goodput categories (``input_stall`` /
  ``productive_step`` / ``device_wait`` / ``checkpoint_save``) so
  straggler cost lands in the same ledger ``goodput_report`` reads;
- **step-skew timeline** — per training step, the wall-clock spread
  (max-min) of ``step_begin`` across ranks, via each file's meta clock
  anchor; the last common step's skew feeds ``paddle_step_skew_ms``;
- **zero-gap check** — each rank's ``coll_enter`` seqs must be
  contiguous from 1 (surviving files assemble with no sequence holes);
- **fingerprint divergence** — the ``coll_lowered`` stream
  (``comm_opt.record_collective`` stamps, one per collective call in the
  port) must agree across ranks; a mismatch means the ranks ran
  different steps, which is its own verdict.

The supervisor (``parallel/launch.py``) runs :func:`assemble_dir`
automatically on a hang-cause restart and writes the verdict next to the
files as ``blame.attempt<K>.json``. Usage::

    python -m paddle_tpu_torch.tools.flight_assemble RUN_DIR/flight \\
        [--out BLAME.json] [--attempt K] [--require-blame]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional

__all__ = ["load_flight_files", "group_attempts", "rank_summary",
           "rank_goodput", "blame", "assemble_dir"]

_FNAME_RE = re.compile(r"flight-rank(\d+)-(\d+)\.jsonl$")

# stall taxonomy: the kind of the LAST event on a quiet file -> what the
# rank was doing -> which goodput category the stalled seconds belong to
STALL_OF_EVENT = {
    "coll_enter": "comm",          # entered an exchange, never came out
    "data_wait": "data_wait",      # starved by the input pipeline
    "ckpt_write": "checkpoint",
    "stream_fetch": "data_wait",
}
GOODPUT_OF_STALL = {
    "comm": "device_wait",
    "data_wait": "input_stall",
    "checkpoint": "checkpoint_save",
    "compute": "productive_step",
}


def load_flight_files(flight_dir: str) -> Dict[str, List[dict]]:
    """All ``flight-*.jsonl`` under ``flight_dir`` -> {filename: events}.
    A torn final line (a rank SIGKILLed mid-write) is skipped, not
    fatal — everything already flushed before it still assembles."""
    out: Dict[str, List[dict]] = {}
    for path in sorted(glob.glob(os.path.join(flight_dir,
                                              "flight-*.jsonl"))):
        recs: List[dict] = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue          # torn tail from a SIGKILL
                    if isinstance(rec, dict) and "ev" in rec:
                        recs.append(rec)
        except OSError:
            continue
        out[os.path.basename(path)] = recs
    return out


def group_attempts(files: Dict[str, List[dict]]
                   ) -> Dict[int, Dict[int, dict]]:
    """{attempt: {rank: {file, meta, events}}} — incarnation grouping.
    Rank/attempt come from the meta header (filename rank as fallback);
    a restarted rank's new pid makes a new file, and the LONGEST file
    wins if a (attempt, rank) pair somehow collides."""
    out: Dict[int, Dict[int, dict]] = {}
    for fname, recs in files.items():
        meta = next((r for r in recs if r.get("ev") == "meta"), None)
        m = _FNAME_RE.search(fname)
        rank = int(meta["rank"]) if meta and "rank" in meta else (
            int(m.group(1)) if m else 0)
        attempt = int(meta.get("attempt", 0)) if meta else 0
        events = [r for r in recs if r.get("ev") != "meta"]
        slot = out.setdefault(attempt, {})
        prev = slot.get(rank)
        if prev is None or len(events) > len(prev["events"]):
            slot[rank] = {"file": fname, "meta": meta, "events": events}
    return out


def _wall(meta: Optional[dict], t_ns: int) -> Optional[float]:
    """Map a rank's monotonic timestamp onto the wall clock via its meta
    anchor (ts and t_ns were sampled together at attach)."""
    if not meta or "ts" not in meta or "t_ns" not in meta:
        return None
    return meta["ts"] + (t_ns - meta["t_ns"]) / 1e9


def rank_summary(rank: int, info: dict) -> Dict[str, Any]:
    """One rank's file distilled: collective frontier, seq gaps, stall
    classification of the quiet tail, step timeline."""
    events = info["events"]
    meta = info.get("meta")
    enter_seqs: List[int] = []
    enter_names: Dict[int, str] = {}
    exit_seqs: set = set()
    steps: Dict[int, Optional[float]] = {}
    lowered: List[tuple] = []
    for e in events:
        ev = e["ev"]
        if ev == "coll_enter":
            seq = int(e.get("seq", 0))
            enter_seqs.append(seq)
            enter_names[seq] = e.get("name", "?")
        elif ev == "coll_exit":
            exit_seqs.add(int(e.get("seq", 0)))
        elif ev == "step_begin":
            steps[int(e.get("step", -1))] = _wall(meta, e["t_ns"])
        elif ev == "coll_lowered":
            lowered.append((e.get("op"), e.get("dtype"), e.get("bytes"),
                            e.get("ranks"), e.get("site")))
    entered = max(enter_seqs, default=0)
    exited = max(exit_seqs, default=0)
    # zero-gap check: host seqs are handed out 1,2,3,... per incarnation
    gaps = sorted(set(range(1, entered + 1)) - set(enter_seqs))
    last = events[-1] if events else None
    stall = STALL_OF_EVENT.get(last["ev"], "compute") if last else "compute"
    if (last is not None and last["ev"] == "coll_enter"
            and int(last.get("seq", 0)) in exit_seqs):
        stall = "compute"   # enter already matched: quiet AFTER the exchange
    return {
        "rank": rank,
        "file": info["file"],
        "n_events": len(events),
        "entered": entered,
        "exited": exited,
        "in_flight": sorted(set(enter_seqs) - exit_seqs),
        "gaps": gaps,
        "enter_names": enter_names,
        "steps": steps,
        "last_step": max(steps, default=None),
        "last_event": ({"ev": last["ev"], "t_ns": last["t_ns"],
                        "wall": _wall(meta, last["t_ns"])}
                       if last else None),
        "stall": stall,
        "goodput_category": GOODPUT_OF_STALL[stall],
        "lowered": lowered,
    }


def rank_goodput(events: List[dict]) -> Dict[str, float]:
    """Per-rank seconds by goodput category, straight from the flight
    events (``goodput_report --by-rank``): explicit durations
    (data_wait / ckpt_write / stream_fetch) plus matched
    coll_enter->coll_exit comm time; compute is the step residue."""
    out = {"productive_step": 0.0, "input_stall": 0.0,
           "device_wait": 0.0, "checkpoint_save": 0.0}
    open_enters: Dict[int, int] = {}
    step_t0: Optional[int] = None
    step_total = 0.0
    for e in events:
        ev = e["ev"]
        if ev == "data_wait" or ev == "stream_fetch":
            out["input_stall"] += e.get("dur_ns", 0) / 1e9
        elif ev == "ckpt_write":
            out["checkpoint_save"] += e.get("dur_ns", 0) / 1e9
        elif ev == "coll_enter":
            open_enters[int(e.get("seq", 0))] = e["t_ns"]
        elif ev == "coll_exit":
            t0 = open_enters.pop(int(e.get("seq", 0)), None)
            if t0 is not None:
                out["device_wait"] += (e["t_ns"] - t0) / 1e9
        elif ev == "step_begin":
            step_t0 = e["t_ns"]
        elif ev == "step_end":
            if step_t0 is not None:
                step_total += (e["t_ns"] - step_t0) / 1e9
                step_t0 = None
    overhead = (out["input_stall"] + out["device_wait"]
                + out["checkpoint_save"])
    out["productive_step"] = max(0.0, step_total - overhead)
    out["step_total"] = step_total
    return out


def blame(per_rank: Dict[int, dict]) -> Dict[str, Any]:
    """The verdict over one attempt's rank summaries."""
    ranks = sorted(per_rank)
    summaries = {r: rank_summary(r, per_rank[r]) for r in ranks}
    entered = {r: s["entered"] for r, s in summaries.items()}
    frontier = max(entered.values(), default=0)
    last_common = min(entered.values(), default=0)

    blamed: List[int] = []
    blame_mode: Optional[str] = None
    missed_seq: Optional[int] = None
    missed_name: Optional[str] = None
    if frontier > last_common:
        # someone moved past seq N while these ranks never entered N+1
        blame_mode = "never_entered"
        missed_seq = last_common + 1
        blamed = [r for r in ranks if entered[r] == last_common]
        for s in summaries.values():
            if missed_seq in s["enter_names"]:
                missed_name = s["enter_names"][missed_seq]
                break
    elif frontier > 0:
        # every rank entered the frontier collective; blame whoever
        # never came out while a peer did (death mid-exchange)
        stuck = [r for r in ranks if frontier in summaries[r]["in_flight"]]
        if stuck and len(stuck) < len(ranks):
            blame_mode = "stuck_inside"
            missed_seq = frontier
            blamed = stuck
            for s in summaries.values():
                if frontier in s["enter_names"]:
                    missed_name = s["enter_names"][frontier]
                    break

    # step-skew timeline: wall-clock spread of step_begin across ranks
    all_steps = sorted({st for s in summaries.values() for st in s["steps"]})
    timeline: List[dict] = []
    for st in all_steps:
        walls = {r: summaries[r]["steps"][st] for r in ranks
                 if st in summaries[r]["steps"]
                 and summaries[r]["steps"][st] is not None}
        if len(walls) < 2:
            continue
        skew = (max(walls.values()) - min(walls.values())) * 1e3
        timeline.append({"step": st, "skew_ms": round(skew, 3),
                         "n_ranks": len(walls),
                         "slowest": max(walls, key=walls.get)})
    full = [t for t in timeline if t["n_ranks"] == len(ranks)]
    step_skew_ms = full[-1]["skew_ms"] if full else (
        timeline[-1]["skew_ms"] if timeline else None)

    # fingerprint stream: the ranks make identical collective calls, so
    # the streams must agree; a shorter stream that is a prefix of the
    # longest is fine (the rank died before making more calls)
    longest = max((s["lowered"] for s in summaries.values()),
                  key=len, default=[])
    divergent = [r for r, s in summaries.items()
                 if s["lowered"] != longest[:len(s["lowered"])]]

    seq_gaps_total = sum(len(s["gaps"]) for s in summaries.values())
    for s in summaries.values():
        s.pop("lowered", None)
        s["enter_names"] = {str(k): v for k, v in s["enter_names"].items()}
        s["steps"] = {str(k): v for k, v in s["steps"].items()}
    return {
        "n_ranks": len(ranks),
        "ranks": ranks,
        "last_common_seq": last_common,
        "frontier_seq": frontier,
        "missed_seq": missed_seq,
        "missed_name": missed_name,
        "blamed_ranks": blamed,
        "blame_mode": blame_mode,
        "step_skew_ms": step_skew_ms,
        "step_skew_timeline": timeline,
        "seq_gaps_total": seq_gaps_total,
        "divergent_ranks": divergent,
        "per_rank": {str(r): summaries[r] for r in ranks},
    }


def assemble_dir(flight_dir: str,
                 attempt: Optional[int] = None) -> Dict[str, Any]:
    """One-call form for the supervisor and the harnesses: load + group
    + blame.  ``attempt=None`` judges the latest incarnation on disk
    (the one that just died); the report carries every attempt's verdict
    under ``attempts`` regardless."""
    files = load_flight_files(flight_dir)
    grouped = group_attempts(files)
    attempts = {k: blame(v) for k, v in sorted(grouped.items())}
    if attempt is None:
        attempt = max(grouped, default=None)
    verdict = attempts.get(attempt) if attempt is not None else None
    return {
        "flight_dir": os.path.abspath(flight_dir),
        "files": {f: len(r) for f, r in files.items()},
        "attempt": attempt,
        "attempts": {str(k): v for k, v in attempts.items()},
        "verdict": verdict,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.flight_assemble",
        description="assemble per-rank flight files into a hang verdict")
    ap.add_argument("flight_dir", help="gang flight dir (flight-*.jsonl)")
    ap.add_argument("--out", default=None,
                    help="write the blame report JSON here")
    ap.add_argument("--attempt", type=int, default=None,
                    help="judge this restart attempt (default: latest)")
    ap.add_argument("--require-blame", action="store_true",
                    help="exit 1 unless the verdict names a blamed rank")
    args = ap.parse_args(argv)

    report = assemble_dir(args.flight_dir, attempt=args.attempt)
    if not report["files"]:
        print(f"no flight-*.jsonl under {args.flight_dir}",
              file=sys.stderr)
        return 2
    v = report["verdict"] or {}
    print(f"attempt {report['attempt']}: {v.get('n_ranks', 0)} ranks, "
          f"last common seq {v.get('last_common_seq')}, "
          f"frontier {v.get('frontier_seq')}")
    if v.get("blamed_ranks"):
        print(f"BLAME: rank(s) {v['blamed_ranks']} "
              f"({v['blame_mode']}) missed seq {v['missed_seq']}"
              + (f" [{v['missed_name']}]" if v.get("missed_name") else ""))
    else:
        print("no blamed rank (clean or insufficient data)")
    for r, s in sorted((v.get("per_rank") or {}).items(),
                       key=lambda kv: int(kv[0])):
        print(f"  rank {r}: entered={s['entered']} exited={s['exited']} "
              f"stall={s['stall']} ({s['goodput_category']}) "
              f"last_step={s['last_step']} gaps={len(s['gaps'])}")
    if v.get("step_skew_ms") is not None:
        print(f"  step skew: {v['step_skew_ms']}ms "
              f"(last common step)")
    if v.get("seq_gaps_total"):
        print(f"  WARNING: {v['seq_gaps_total']} sequence gap(s)",
              file=sys.stderr)
    if v.get("divergent_ranks"):
        print(f"  WARNING: divergent lowered streams on ranks "
              f"{v['divergent_ranks']}", file=sys.stderr)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report -> {args.out}")
    if args.require_blame and not v.get("blamed_ranks"):
        print("FAIL: no blamed rank", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
