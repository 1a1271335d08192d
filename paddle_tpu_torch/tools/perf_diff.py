"""Perf regression sentinel CLI: diff a run's artifacts against a baseline
— the port of the JAX package's ``tools/perf_diff.py`` (core logic in
``observability/baseline.py``, which both packages share to the line).

    python -m paddle_tpu_torch.tools.perf_diff [--dir perf_runs]
    python -m paddle_tpu_torch.tools.perf_diff --attribution A.json \\
        [--goodput GOODPUT.json] [--monitor steps.jsonl] \\
        [--baseline B.json] [--out REGRESSION.json]
    python -m paddle_tpu_torch.tools.perf_diff --update-baseline \\
        [--lane gpu] [--dir perf_runs]

The defaults read a run directory (``--dir``, default ``perf_runs``, where
``tools/profile_step.py`` writes): its ``ATTRIBUTION.json``,
``GOODPUT.json`` and ``monitor.jsonl`` when present, the baseline
``PERF_BASELINE.json`` and the report ``REGRESSION.json`` — never the
repository root's files, which are the JAX package's records.

Every metric in the baseline that the run's artifacts cover is checked
against its tolerance band (artifact files absent from this run are
skipped and listed, not failed). On a ``degraded: true`` baseline (a CPU
lane) timing and count metrics demote to structural checks — present and
finite — while counted facts (flops, bytes), exact counters and flags
keep their bands. Each out-of-band metric is attributed to a cause: a
config lever changed, a goodput category grew, a named program's
flops/bytes/first-call ms moved, a new recompile cause, a named kernel
group slower, residue share up. Writes the report and exits 1 on any
out-of-band or structural failure, 2 when there is nothing to diff.
``--update-baseline`` records the baseline from this run instead.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _in(run_dir: str, name: str):
    p = os.path.join(run_dir, name)
    return p if os.path.exists(p) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.perf_diff",
        description="perf regression sentinel")
    ap.add_argument("--dir", default="perf_runs",
                    help="run directory the defaults read (default "
                         "perf_runs)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default <dir>/PERF_BASELINE.json)")
    ap.add_argument("--attribution", default=None,
                    help="default <dir>/ATTRIBUTION.json")
    ap.add_argument("--goodput", default=None,
                    help="default <dir>/GOODPUT.json")
    ap.add_argument("--monitor", default=None,
                    help="TrainMonitor JSONL (default <dir>/monitor.jsonl)")
    ap.add_argument("--dispatch", default=None)
    ap.add_argument("--comm", default=None)
    ap.add_argument("--serve", default=None)
    ap.add_argument("--bench", default=None, help="a headline JSON")
    ap.add_argument("--programs", nargs="*", default=(),
                    help="program-report JSONL file(s)")
    ap.add_argument("--out", default=None,
                    help="report path (default <dir>/REGRESSION.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="record the baseline from this run's artifacts "
                         "instead of diffing")
    ap.add_argument("--lane", default=None,
                    help="baseline lane label (default: gpu when the "
                         "attribution is not degraded, else cpu_smoke)")
    ap.add_argument("--notes", default="")
    args = ap.parse_args(argv)

    from ..observability import baseline as B

    d = args.dir
    baseline = args.baseline or os.path.join(d, "PERF_BASELINE.json")
    out = args.out or os.path.join(d, "REGRESSION.json")
    artifacts = B.load_artifacts(
        attribution=args.attribution or _in(d, "ATTRIBUTION.json"),
        goodput=args.goodput or _in(d, "GOODPUT.json"),
        monitor=args.monitor or _in(d, "monitor.jsonl"),
        dispatch=args.dispatch, comm=args.comm, serve=args.serve,
        bench=args.bench, programs=args.programs)
    present = sorted(k for k, v in artifacts.items() if v)
    if not present:
        print("[perf_diff] no artifacts found — nothing to diff",
              file=sys.stderr)
        return 2

    if args.update_baseline:
        att = artifacts.get("attribution") or {}
        lane = args.lane or ("gpu" if att.get("degraded") is False
                             else "cpu_smoke")
        doc = B.make_baseline(artifacts, lane=lane, notes=args.notes)
        os.makedirs(os.path.dirname(os.path.abspath(baseline)),
                    exist_ok=True)
        tmp = baseline + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, baseline)
        print(f"[perf_diff] baseline recorded: {baseline} "
              f"(lane={lane}, degraded={doc['degraded']}, "
              f"{len(doc['metrics'])} metrics from {present})")
        return 0

    base = B.load_json(baseline)
    if base is None:
        print(f"[perf_diff] no baseline at {baseline} — run with "
              f"--update-baseline to record one", file=sys.stderr)
        return 2

    report = B.compare(artifacts, base, out_path=out)
    print(f"[perf_diff] lane={report['baseline_lane']} "
          f"degraded={report['degraded']} checked={report['checked']} "
          f"artifacts={present}")
    for ch in report["config_changes"]:
        print(f"[perf_diff] CONFIG: lever {ch['lever']!r} "
              f"{ch['baseline']!r} -> {ch['value']!r}")
    for bad in report["structural_failures"]:
        print(f"[perf_diff] STRUCTURAL {bad['metric']}: "
              f"value={bad.get('value')!r} "
              f"baseline={bad.get('baseline')!r} "
              f"({bad.get('detail', bad.get('check'))}) "
              f"<- {bad['cause']['detail']}")
    for bad in report["out_of_band"]:
        print(f"[perf_diff] OUT-OF-BAND {bad['metric']}: "
              f"{bad['baseline']:.6g} -> {bad['value']:.6g} "
              f"(band {bad['band']:.3g}, {bad['direction']}) "
              f"<- {bad['cause']['detail']}")
    if report["skipped_missing_artifact"]:
        n = len(report["skipped_missing_artifact"])
        print(f"[perf_diff] skipped {n} metric(s) whose artifact this "
              f"run did not produce")
    if report["ok"]:
        print(f"[perf_diff] OK — no regressions "
              f"(wrote {report.get('path')})")
        return 0
    print(f"[perf_diff] FAIL — {len(report['out_of_band'])} out-of-band, "
          f"{len(report['structural_failures'])} structural "
          f"(wrote {report.get('path')})", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
