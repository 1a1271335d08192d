"""Stitch per-process span JSONL files into end-to-end request traces —
the port of the JAX package's ``tools/trace_assemble.py`` (it reads either
package's span files).

Every process of a serving fleet appends its spans to its own
``spans-<role>-<pid>.jsonl`` under a shared trace dir
(``observability/spans.py`` process sinks). One request is ONE trace id,
minted at the router and carried across every boundary: the prefill /
decode phase hop, the KV handoff (in the frame's ``trace`` key) and the
KV-transfer socket. This tool reassembles the files into per-trace
timelines and checks the stitching:

- **orphans** — a span whose ``parent`` id does not exist anywhere in
  its trace (a broken propagation edge: some hop minted a fresh context
  instead of adopting the wire one).  Spans stamped
  ``attrs.remote_parent`` (the parent is the CLIENT's own span, held
  outside this trace dir) are legitimate roots, not orphans;
- **duplicate span ids** within a trace (id-collision or double flush);
- per-trace summaries: span count, processes/roles involved, wall span.

Spans tick on ``perf_counter_ns`` (CLOCK_MONOTONIC — one epoch per
host), so cross-process timestamps on one machine are directly
comparable.

Usage::

    python -m paddle_tpu_torch.tools.trace_assemble RUN_DIR/trace \\
        [--out TRACES.json] [--require-complete] [--chrome OUT.json
        [--trace HEX]]

``--chrome`` renders the assembled spans (one trace with ``--trace``) as
a chrome trace through ``observability/trace_merge.merge_events``: one
row a recording thread, span identity in each event's args.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

__all__ = ["load_span_files", "assemble", "check_assembly",
           "assemble_dir"]


def load_span_files(trace_dir: str) -> Dict[str, List[dict]]:
    """All ``spans-*.jsonl`` under ``trace_dir`` -> {filename: records}.
    A torn final line (a process killed mid-write) is skipped, not
    fatal — everything already flushed before it still stitches."""
    out: Dict[str, List[dict]] = {}
    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "spans-*.jsonl"))):
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
                    if isinstance(rec, dict) and "span" in rec:
                        recs.append(rec)
        except OSError:
            continue
        out[os.path.basename(path)] = recs
    return out


def _file_role(fname: str) -> str:
    # spans-<role>-<pid>.jsonl
    parts = fname.split("-")
    return parts[1] if len(parts) >= 3 else "?"


def _is_open(rec: dict) -> bool:
    return bool((rec.get("attrs") or {}).get("open"))


def assemble(files: Dict[str, List[dict]]) -> Dict[int, List[dict]]:
    """Group every span across every file by trace id; each span gains
    ``file``/``role`` provenance and traces come back time-ordered.

    Open-sentinel collapse: the scheduler flushes a dur-0
    ``attrs.open`` record for every root span at ADMISSION, superseded
    by the full record at finish — so a process killed mid-request
    still leaves its children's parent on disk.  When both exist the
    final record wins; a sentinel with no final marks a span cut short
    by a crash (it stays, flagged ``open``, and is NOT a duplicate)."""
    traces: Dict[int, List[dict]] = {}
    for fname, recs in files.items():
        role = _file_role(fname)
        for rec in recs:
            tid = rec.get("trace")
            if tid is None:
                continue
            span = dict(rec, file=fname, role=role)
            traces.setdefault(int(tid), []).append(span)
    for tid, spans in traces.items():
        by_id: Dict[Any, int] = {}
        out: List[dict] = []
        for s in spans:
            sid = s.get("span")
            at = by_id.get(sid)
            if at is None:
                by_id[sid] = len(out)
                out.append(s)
            elif _is_open(out[at]) and not _is_open(s):
                out[at] = s                     # final supersedes open
            elif _is_open(s):
                pass                            # late sentinel: drop
            else:
                out.append(s)                   # genuine duplicate
        out.sort(key=lambda s: s.get("start_ns", 0))
        traces[tid] = out
    return traces


def check_assembly(traces: Dict[int, List[dict]]) -> Dict[str, Any]:
    """Cross-file stitch check: orphans + duplicate ids + summaries."""
    orphans: List[dict] = []
    duplicates: List[dict] = []
    summaries: List[dict] = []
    for tid, spans in sorted(traces.items()):
        ids = [s["span"] for s in spans]
        id_set = set(ids)
        if len(ids) != len(id_set):
            seen: set = set()
            for s in spans:
                if s["span"] in seen:
                    duplicates.append({"trace": tid, "span": s["span"],
                                       "name": s["name"],
                                       "file": s["file"]})
                seen.add(s["span"])
        for s in spans:
            parent = s.get("parent")
            if (parent is not None and parent not in id_set
                    and not (s.get("attrs") or {}).get("remote_parent")):
                # a stamped remote parent (the client's own span, held
                # outside this trace dir) is a legitimate trace root
                # here, not a broken propagation edge
                orphans.append({"trace": tid, "span": s["span"],
                                "name": s["name"], "parent": parent,
                                "file": s["file"]})
        start = min(s.get("start_ns", 0) for s in spans)
        end = max(s.get("start_ns", 0) + s.get("dur_ns", 0)
                  for s in spans)
        roots = [s for s in spans if s.get("parent") is None]
        summaries.append({
            "trace": f"{tid:x}",
            "n_spans": len(spans),
            # open sentinels with no final record: spans a crash cut
            # short — present (their children stitch) but unfinished
            "n_open": sum(1 for s in spans if _is_open(s)),
            "roots": [s["name"] for s in roots],
            "roles": sorted({s["role"] for s in spans}),
            "files": sorted({s["file"] for s in spans}),
            "names": sorted({s["name"] for s in spans}),
            "wall_ms": round((end - start) / 1e6, 3),
        })
    return {
        "n_traces": len(traces),
        "n_spans": sum(len(v) for v in traces.values()),
        "n_orphans": len(orphans),
        "n_duplicates": len(duplicates),
        "orphans": orphans[:64],
        "duplicates": duplicates[:64],
        "traces": summaries,
    }


def assemble_dir(trace_dir: str) -> Dict[str, Any]:
    """One-call form for the harnesses: load + assemble + check.
    Returns the check report with ``files`` provenance added."""
    files = load_span_files(trace_dir)
    traces = assemble(files)
    report = check_assembly(traces)
    report["trace_dir"] = os.path.abspath(trace_dir)
    report["files"] = {f: len(r) for f, r in files.items()}
    return report


def _render_chrome(traces: Dict[int, List[dict]], out_path: str,
                   only: Optional[int] = None) -> str:
    from paddle_tpu_torch.observability import trace_merge

    spans: List[dict] = []
    for tid, ss in traces.items():
        if only is not None and tid != only:
            continue
        spans.extend(ss)
    doc = trace_merge.merge_events([], [], tracer_spans=spans)
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return out_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.trace_assemble",
        description="assemble per-process span files into request traces")
    ap.add_argument("trace_dir", help="gang trace dir (spans-*.jsonl)")
    ap.add_argument("--out", default=None,
                    help="write the assembly report JSON here")
    ap.add_argument("--chrome", default=None,
                    help="render assembled spans to a chrome trace")
    ap.add_argument("--trace", default=None,
                    help="restrict --chrome to one trace id (hex)")
    ap.add_argument("--require-complete", action="store_true",
                    help="exit 1 on any orphan or duplicate span")
    args = ap.parse_args(argv)

    files = load_span_files(args.trace_dir)
    if not files:
        print(f"no spans-*.jsonl under {args.trace_dir}", file=sys.stderr)
        return 2
    traces = assemble(files)
    report = check_assembly(traces)
    report["trace_dir"] = os.path.abspath(args.trace_dir)
    report["files"] = {f: len(r) for f, r in files.items()}

    print(f"{report['n_traces']} traces / {report['n_spans']} spans "
          f"from {len(files)} files — "
          f"{report['n_orphans']} orphans, "
          f"{report['n_duplicates']} duplicates")
    for t in report["traces"][:20]:
        print(f"  trace {t['trace']}: {t['n_spans']} spans, "
              f"roles={','.join(t['roles'])}, wall={t['wall_ms']}ms, "
              f"roots={t['roots']}")
    if len(report["traces"]) > 20:
        print(f"  ... {len(report['traces']) - 20} more")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report -> {args.out}")
    if args.chrome:
        only = int(args.trace, 16) if args.trace else None
        path = _render_chrome(traces, args.chrome, only=only)
        print(f"chrome trace -> {path}")
    if args.require_complete and (report["n_orphans"]
                                  or report["n_duplicates"]):
        print("FAIL: incomplete stitching", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
