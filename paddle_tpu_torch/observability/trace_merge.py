"""Merged host + device chrome trace — the port of
``paddle_tpu/observability/trace_merge.py``.

Three sources land in ONE chrome-trace file, so a single Perfetto /
chrome://tracing load shows host dispatch lined up against device
execution:

- host events (a chrome trace's ``traceEvents``) keep their pid with
  per-thread rows;
- each device plane of a ``torch.profiler`` capture
  (``utils/profile_data.py``: one plane a CUDA device, one line a
  stream) becomes its own pid with one row a stream; on the CPU, with no
  device plane, the capture's host op lines stand in as the execution
  side (``(CPU runtime)``);
- the span tracer (``observability/spans.py``) is a third plane, one row
  a recording thread, span identity in the event args.

The capture already puts its host and device events on one clock. Other
host sources are START-ALIGNED with it as the reference aligns them: the
capture's earliest span is pinned to ``align_device_to_us`` (or to the
earliest host event), and spans opened before that epoch are clamped to
it rather than dropped. :func:`span_chrome_events` and
:func:`merge_events` are the reference's.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["device_spans_from_trace", "merge_events", "merge_profile",
           "span_chrome_events"]

# device pids start here so they can never collide with a real host pid
# (linux pid_max tops out at 2^22)
DEVICE_PID_BASE = 1 << 23
# the span-tracer plane gets its own pid block above the device planes
SPAN_PID = DEVICE_PID_BASE << 1


def device_spans_from_trace(trace_dir: str) -> List[dict]:
    """Raw timed spans from the newest ``torch.profiler`` capture under
    ``trace_dir`` (or that file).

    Returns dicts ``{plane, line, name, start_ns, dur_ns}`` for every
    positive-duration event of a device plane (every line and category —
    the merge keeps stream envelopes as rows of their own rather than
    summing them; ``utils/device_trace.py`` remains the aggregation
    track). Off the card there is no device plane, so the host's op lines
    stand in as the execution side."""
    from ..utils.profile_data import ProfileData, latest_trace

    path = latest_trace(trace_dir)
    if path is None:
        return []
    pd = ProfileData.from_file(path)
    planes = pd.device_planes()
    cpu = not planes
    if cpu:
        host = pd.host_plane()
        planes = [host] if host is not None else []
    spans: List[dict] = []
    for plane in planes:
        out_plane = f"{plane.name} (CPU runtime)" if cpu else plane.name
        for line in plane.lines:
            for ev in line.events:
                if ev.duration_ns <= 0 or (cpu and ev.stat("cat")
                                           != "cpu_op"):
                    continue
                spans.append({
                    "plane": out_plane, "line": str(line.name),
                    "name": str(ev.name), "start_ns": float(ev.start_ns),
                    "dur_ns": float(ev.duration_ns),
                })
    return spans


def span_chrome_events(tracer_spans: Iterable[dict],
                       epoch_us: Optional[float] = None
                       ) -> Tuple[List[dict], List[dict]]:
    """Tracer spans -> (metadata rows, chrome events) for the span plane.

    Spans already tick on the host perf_counter clock, so their ``ts`` is
    directly comparable to host RecordEvents.  ``epoch_us`` is the merged
    trace's epoch (the host time ``start_profiler`` returned): a span
    opened before it — e.g. a serving request admitted before profiling
    began — is ALIGNED to the epoch (start clamped, duration shrunk to the
    in-window share) rather than dropped or drawn before the trace
    starts.  Each recording thread gets its own named row.
    """
    meta: List[dict] = []
    out: List[dict] = []
    tid_row: Dict[int, int] = {}
    for s in tracer_spans:
        ts_us = s["start_ns"] / 1000.0
        dur_us = s["dur_ns"] / 1000.0
        if epoch_us is not None and ts_us < epoch_us:
            # clamp to the merged-trace epoch; fully-pre-epoch spans keep
            # a zero-length marker at the epoch so their identity survives
            dur_us = max(0.0, dur_us - (epoch_us - ts_us))
            ts_us = epoch_us
        tid = int(s.get("tid", 0))
        row = tid_row.get(tid)
        if row is None:
            row = len(tid_row)
            tid_row[tid] = row
            meta.append({"name": "thread_name", "ph": "M", "pid": SPAN_PID,
                         "tid": row,
                         "args": {"name": f"spans:"
                                          f"{s.get('thread', tid)}"}})
        args = {"track": "span", "trace": f"{s['trace']:x}",
                "span": f"{s['span']:x}"}
        if s.get("parent"):
            args["parent"] = f"{s['parent']:x}"
        if s.get("attrs"):
            args.update(s["attrs"])
        out.append({"name": s["name"], "ph": "X", "ts": ts_us,
                    "dur": dur_us, "pid": SPAN_PID, "tid": row,
                    "args": args})
    if out:
        meta.insert(0, {"name": "process_name", "ph": "M", "pid": SPAN_PID,
                        "args": {"name": "spans (request/step tracer)"}})
    return meta, out


def merge_events(host_events: Iterable[dict], device_spans: Iterable[dict],
                 align_device_to_us: Optional[float] = None,
                 tracer_spans: Optional[Iterable[dict]] = None,
                 span_epoch_us: Optional[float] = None) -> dict:
    """Merge host chrome-trace events with raw device spans (and,
    optionally, tracer spans as their own plane) into one chrome-trace
    document (pure function — the testable core).

    ``align_device_to_us``: host-clock microsecond timestamp the earliest
    device span is shifted to (start alignment). ``None`` aligns the
    earliest device span with the earliest host event.
    ``span_epoch_us``: merged-trace epoch pre-profiler tracer spans are
    aligned to (defaults to ``align_device_to_us``).
    """
    host_events = [dict(e) for e in host_events]
    device_spans = list(device_spans)

    out: List[dict] = []
    meta: List[dict] = []
    host_pids = sorted({e.get("pid", 0) for e in host_events})
    for pid in host_pids:
        tracks = {e.get("args", {}).get("track") for e in host_events
                  if e.get("pid", 0) == pid}
        # synthetic aggregate tracks (measured-device / op-costs rows that
        # device_trace/op_costs merged into the host file) keep their label
        label = (f"{next(iter(tracks))} (aggregate)"
                 if tracks and None not in tracks
                 else f"host (pid {pid})")
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": label}})
    out.extend(host_events)

    if device_spans:
        dev_min_ns = min(s["start_ns"] for s in device_spans)
        if align_device_to_us is None:
            align_device_to_us = (min(e.get("ts", 0.0) for e in host_events)
                                  if host_events else 0.0)
        shift_us = align_device_to_us - dev_min_ns / 1000.0

        plane_pid: Dict[str, int] = {}
        line_tid: Dict[Tuple[str, str], int] = {}
        for s in device_spans:
            pid = plane_pid.get(s["plane"])
            if pid is None:
                pid = DEVICE_PID_BASE + len(plane_pid)
                plane_pid[s["plane"]] = pid
                meta.append({"name": "process_name", "ph": "M", "pid": pid,
                             "args": {"name": f"device {s['plane']}"}})
            key = (s["plane"], s["line"])
            tid = line_tid.get(key)
            if tid is None:
                tid = len([k for k in line_tid if k[0] == s["plane"]])
                line_tid[key] = tid
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {"name": s["line"]}})
            out.append({
                "name": s["name"], "ph": "X",
                "ts": s["start_ns"] / 1000.0 + shift_us,
                "dur": s["dur_ns"] / 1000.0,
                "pid": pid, "tid": tid,
                "args": {"track": "device"},
            })

    if tracer_spans:
        smeta, sevents = span_chrome_events(
            tracer_spans,
            epoch_us=(span_epoch_us if span_epoch_us is not None
                      else align_device_to_us))
        meta.extend(smeta)
        out.extend(sevents)

    out.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def merge_profile(host_trace_path: str, trace_dir: str,
                  out_path: Optional[str] = None,
                  align_device_to_us: Optional[float] = None,
                  tracer_spans: Optional[Iterable[dict]] = None
                  ) -> Optional[str]:
    """Merge a host chrome trace with the ``torch.profiler`` capture it
    ran alongside (plus tracer spans, when the caller passes them).
    Returns the merged path, or None when there is nothing to merge."""
    try:
        with open(host_trace_path) as f:
            host = json.load(f).get("traceEvents", [])
    except (OSError, ValueError):
        host = []
    spans = device_spans_from_trace(trace_dir)
    if not spans and not host and not tracer_spans:
        return None
    doc = merge_events(host, spans, align_device_to_us=align_device_to_us,
                       tracer_spans=tracer_spans,
                       span_epoch_us=align_device_to_us)
    if out_path is None:
        base = host_trace_path
        if base.endswith(".chrome_trace.json"):
            base = base[: -len(".chrome_trace.json")]
        out_path = base + ".merged_trace.json"
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return out_path
