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

``--diff A.json B.json`` instead compares two goodput reports (rank
windows or gang GOODPUT.json) per category, reusing the perf sentinel's
band arithmetic (``observability/baseline.compare_goodput``): a category
is out-of-band when its wall-share moved more than
``tol_rel * share_A + tol_abs`` in the worse direction (productive_step
down, any overhead category up). Non-zero exit on any out-of-band
category.

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


def diff_reports(path_a: str, path_b: str, tol_rel: float,
                 tol_abs: float) -> int:
    from paddle_tpu_torch.observability import baseline as B

    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    out = B.compare_goodput(a, b, tol_rel=tol_rel, tol_abs_share=tol_abs)
    print(f"{'category':<18}{'A share':>9}{'B share':>9}{'delta':>9}"
          f"{'band':>8}  flag")
    for r in out["rows"]:
        flag = "OUT-OF-BAND" if r["out_of_band"] else ""
        print(f"{r['category']:<18}{r['share_a']:>9.4f}"
              f"{r['share_b']:>9.4f}{r['delta_share']:>+9.4f}"
              f"{r['band']:>8.4f}  {flag}")
    print(f"[goodput_report] wall {out['wall_s_a']:.3f}s -> "
          f"{out['wall_s_b']:.3f}s, {out['out_of_band']} categor"
          f"{'y' if out['out_of_band'] == 1 else 'ies'} out of band",
          file=sys.stderr)
    return 0 if out["ok"] else 1


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
    ap.add_argument("--diff", nargs=2, metavar=("A.json", "B.json"),
                    help="compare two goodput reports per category "
                         "instead of aggregating a rank dir")
    ap.add_argument("--tol-rel", type=float, default=0.25,
                    help="--diff: relative share band per category")
    ap.add_argument("--tol-abs", type=float, default=0.02,
                    help="--diff: absolute share band floor")
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

    if args.diff:
        return diff_reports(args.diff[0], args.diff[1], args.tol_rel,
                            args.tol_abs)
    if args.by_rank:
        if not args.flight_dir:
            ap.error("--by-rank needs --flight-dir DIR")
        return by_rank_report(args.flight_dir, args.attempt, args.out)
    if not args.dir:
        ap.error("--dir is required (or --diff A.json B.json, or "
                 "--by-rank --flight-dir DIR)")

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
