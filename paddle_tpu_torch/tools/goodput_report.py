"""Gang goodput report: merge per-rank goodput ledgers into GOODPUT.json
— the port of the JAX package's ``tools/goodput_report.py`` (it reads
either package's rank files).

``parallel.launch`` runs this aggregation automatically at job end (it
also owns the restart-downtime windows only a supervisor can see); this
CLI re-runs it standalone — after the fact, over a copied-out goodput
dir, or for a single-process run that exported its ledger via
``PADDLE_GOODPUT_DIR``.

  python -m paddle_tpu_torch.tools.goodput_report --dir LOGDIR/goodput \\
      [--out GOODPUT.json] [--restart-downtime S] [--nranks N]

The report:

  {
    "nranks": 8, "wall_s": ...,
    "categories": {"productive_step": ..., "compile": ...,
                   "restart_downtime": ..., "other": ...},
    "gang_goodput_fraction": productive / attributed seconds,
    "unaccounted_fraction": other / attributed seconds,
    ...
  }

``--by-rank --flight-dir DIR`` derives a per-rank category breakdown
straight from the flight-recorder sidecars: explicit data_wait /
ckpt_write / stream_fetch durations, matched coll_enter -> coll_exit comm
time, and the step residue as productive time — the taxonomy the blame
engine's stall classification feeds.

The reference's ``--diff A.json B.json`` compares two reports through the
perf sentinel (``observability/baseline.py``), which waits for the
device-side observability (ROADMAP A, item 4).

Exit status: 1 when no rank ever reported, or when the merged ledger
leaves more than --max-unaccounted (default 5%) of wall-clock in
``other`` — an instrumentation gap, not a measurement.
"""
import argparse
import json
import os
import sys

from paddle_tpu_torch.observability import goodput
from paddle_tpu_torch.tools import flight_assemble as fa


def by_rank_report(flight_dir: str, attempt, out_path) -> int:
    grouped = fa.group_attempts(fa.load_flight_files(flight_dir))
    if not grouped:
        print(f"[goodput_report] no flight-*.jsonl under {flight_dir}",
              file=sys.stderr)
        return 1
    if attempt is None:
        attempt = max(grouped)
    per_rank = grouped.get(attempt) or {}
    cats = ("productive_step", "input_stall", "device_wait",
            "checkpoint_save")
    rows = {r: fa.rank_goodput(info["events"])
            for r, info in sorted(per_rank.items())}
    print(f"{'rank':<6}{'steps_s':>9}" + "".join(f"{c:>17}" for c in cats))
    for r, g in rows.items():
        tot = g.get("step_total") or 0.0
        print(f"{r:<6}{tot:>9.3f}" + "".join(
            f"{g[c]:>10.3f} {g[c] / tot if tot else 0.0:>5.1%}"
            for c in cats))
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"flight_dir": os.path.abspath(flight_dir),
                       "attempt": attempt,
                       "by_rank": {str(r): g for r, g in rows.items()}},
                      f, indent=1)
        print(f"[goodput_report] wrote {out_path}", file=sys.stderr)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.goodput_report",
        description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None,
                    help="goodput dir holding goodput.rank*.json")
    ap.add_argument("--out", default=None,
                    help="output path (default: <dir>/GOODPUT.json)")
    ap.add_argument("--restart-downtime", type=float, default=0.0,
                    help="supervisor-observed restart downtime seconds "
                         "(charged once per rank)")
    ap.add_argument("--nranks", type=int, default=None)
    ap.add_argument("--max-unaccounted", type=float, default=0.05,
                    help="fail when other/total exceeds this fraction")
    ap.add_argument("--by-rank", action="store_true",
                    help="per-rank category breakdown from the flight "
                         "recorder sidecars (needs --flight-dir)")
    ap.add_argument("--flight-dir", default=None,
                    help="gang flight dir holding flight-*.jsonl")
    ap.add_argument("--attempt", type=int, default=None,
                    help="--by-rank: restart attempt (default: latest)")
    args = ap.parse_args(argv)

    if args.by_rank:
        if not args.flight_dir:
            ap.error("--by-rank needs --flight-dir DIR")
        return by_rank_report(args.flight_dir, args.attempt, args.out)
    if not args.dir:
        ap.error("--dir is required (or --by-rank --flight-dir DIR)")

    path = goodput.write_gang_report(
        args.dir, restart_downtime_s=args.restart_downtime,
        nranks=args.nranks, out_path=args.out)
    if path is None:
        print(f"[goodput_report] no rank reports under {args.dir}",
              file=sys.stderr)
        return 1
    with open(path) as f:
        gang = json.load(f)
    print(json.dumps(gang, indent=1))
    unacc = gang.get("unaccounted_fraction")
    if unacc is not None and unacc > args.max_unaccounted:
        print(f"[goodput_report] FAIL: {unacc:.1%} of wall-clock "
              f"unaccounted (gate {args.max_unaccounted:.0%})",
              file=sys.stderr)
        return 1
    print(f"[goodput_report] wrote {path} "
          f"(gang goodput {gang.get('gang_goodput_fraction')})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
