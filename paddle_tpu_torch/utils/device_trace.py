"""Measured per-kernel device time from ``torch.profiler`` captures — the
port of ``paddle_tpu/utils/device_trace.py``.

The reference reads an XSpace capture and maps each executed HLO
instruction back to the IR op through ``metadata.op_name``. Here:

1. :func:`capture` runs ``torch.profiler`` (host and CUDA activities,
   shapes and FLOP counts) over a block, arms the hand kernels' launch
   costs (``ops/kernel_costs.arm``), and exports the chrome trace into a
   trace directory with each host op's counted FLOPs in its ``args``;
2. :func:`device_rows` takes the kernel, memcpy and memset events of the
   device streams (``utils/profile_data.py``); with ``exclusive`` each
   keeps the wall time nothing nested in it covers, and the interval-union
   pass splits time that parallel streams share, so the attributed total
   is the streams' busy union;
3. :func:`launch_scopes` joins each device event to the host op that
   launched it: the event's ``correlation`` names a runtime call
   (``cudaLaunchKernel``, ``cudaMemcpyAsync``) on a host thread, and the
   ops and ``record_function`` ranges open on that thread at the call are
   its scope, the innermost last. This replaces the reference's join from
   ``hlo_op`` to ``op_name``.

The hand kernels are launched through ``ctypes`` (``ops/_build.py``):
their events carry the kernels' demangled CUDA symbols and link to a
``cudaLaunchKernel`` call, not to an ``aten::`` op of their own. Each
``cuda_kernels.KERNELS`` entry lists its symbols (``kernel_entries``);
:func:`port_kernel_launches` pairs the events with the launches the
armed costs recorded, in launch order, and raises when they disagree —
a port kernel event is never filed as another kernel.

On the CPU (no device plane) the rows are the leaf-exclusive times of
the host's ATen and custom ops, a row an op (``source: "cpu_ops"``), the
part the reference's CPU-thread emulation plays: the mechanism, not
device numbers.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import socket
import sys
import tempfile
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .profile_data import ProfileData, latest_trace

__all__ = ["capture", "Capture", "device_rows", "device_events",
           "launch_scopes", "port_kernel_launches", "unanswered_launches",
           "measured_op_rows",
           "kernel_rows", "kernel_base", "merge_into_trace", "print_rows",
           "busy_ns", "profile_data_of", "AttributionError"]

# device event categories that do work (gpu_user_annotation spans mirror
# record_function ranges onto a stream: envelopes, never summed)
_WORK_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that open a scope a launch can sit in
_SCOPE_CATS = ("cpu_op", "user_annotation")
# host ops whose FLOPs are matrix products (the attribution's "dot")
MATMUL_OPS = frozenset((
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
    "aten::matmul", "aten::linear", "aten::_scaled_mm",
    "aten::convolution", "aten::_convolution", "aten::cudnn_convolution",
    "aten::convolution_backward", "aten::conv2d",
    "aten::_scaled_dot_product_flash_attention",
    "aten::_scaled_dot_product_efficient_attention",
    "aten::_scaled_dot_product_cudnn_attention"))


# the host range :func:`capture` runs its block in: rows keep only the
# work launched inside it
CAPTURE_RANGE = "paddle_capture"


class AttributionError(RuntimeError):
    """A capture whose port kernel events and recorded launches
    disagree."""


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


class Capture:
    """What :func:`capture` leaves: the trace file and its
    :class:`ProfileData`, the launch costs, the hand kernels' launch
    counts in the block (``cuda_kernels.LAUNCHES``' delta), the host wall
    of the block (after the device finished) and the device."""

    def __init__(self, trace_dir: str, device):
        self.trace_dir = trace_dir
        self.device = device
        self.path: Optional[str] = None
        self.pd: Optional[ProfileData] = None
        self.costs = None
        self.launches: Dict[str, int] = {}
        self.wall_ns = 0
        self.export_s = 0.0       # the trace's export and reading


def _trace_name() -> str:
    return (f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns() // 1000000}.pt.trace.json")


def annotate_flops(path: str, prof) -> Dict[str, Any]:
    """Write each host op's counted FLOPs (``with_flops``) into its
    ``args`` as ``"flops"``: the exported trace leaves them out, and an op
    event's ``External id`` is its profiler event's correlation id. The
    counts are read from the profiler's own results (building its Python
    event list takes seconds a capture). Returns the trace document."""
    with open(path) as f:
        doc = json.load(f)
    flops = {e.correlation_id(): int(e.flops())
             for e in prof.profiler.kineto_results.events() if e.flops()}
    if flops:
        for e in doc.get("traceEvents", ()):
            if e.get("cat") == "cpu_op":
                n = flops.get((e.get("args") or {}).get("External id"))
                if n:
                    e["args"]["flops"] = n
        with open(path, "w") as f:
            f.write(json.dumps(doc))     # one-shot: the C encoder
    return doc


@contextlib.contextmanager
def capture(trace_dir: str, device=None, costs: bool = True, warmup=None):
    """Profile the block: ``torch.profiler`` over the host and, when
    ``device`` is a CUDA device, the card (the block's work synchronised
    before the capture stops), with shapes and FLOP counts; the hand
    kernels' launch costs armed (``costs``). The block runs inside a
    ``record_function(CAPTURE_RANGE)`` range, and the rows keep only what
    it launched. ``warmup`` (a callable: the same work once more) runs
    first, inside the profiler but outside that range: after an earlier
    profiler session in the process, the profiler loses the first few
    milliseconds of device events of the next one, and those are then the
    warm-up's. Exports ``<trace_dir>/<host>_<pid>.<ms>.pt.trace.json``;
    yields a :class:`Capture` whose ``path``, ``pd``, ``costs``,
    ``launches`` and ``wall_ns`` are set when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..ops import cuda_kernels as _ck
    from ..ops import kernel_costs

    dev = torch.device(device) if device is not None else torch.device(
        "cpu")
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    cap = Capture(trace_dir, dev)
    armed = (kernel_costs.arm() if costs else contextlib.nullcontext())
    with profile(activities=acts, record_shapes=True,
                 with_flops=True) as prof:
        if warmup is not None:
            warmup()
        if cuda:
            torch.cuda.synchronize(dev)
        with record_function(CAPTURE_RANGE), armed as lc:
            before = dict(_ck.LAUNCHES)
            t0 = time.perf_counter_ns()
            yield cap
            if cuda:
                torch.cuda.synchronize(dev)
            cap.wall_ns = time.perf_counter_ns() - t0
            cap.launches = {k: v - before.get(k, 0)
                            for k, v in _ck.LAUNCHES.items()
                            if v - before.get(k, 0)}
    cap.costs = lc
    t1 = time.perf_counter()
    cap.path = os.path.join(trace_dir, _trace_name())
    prof.export_chrome_trace(cap.path)
    cap.pd = ProfileData.from_json(annotate_flops(cap.path, prof))
    cap.export_s = time.perf_counter() - t1


def profile_data_of(prof) -> ProfileData:
    """A finished ``torch.profiler.profile`` read as :class:`ProfileData`
    (through its exported chrome trace)."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return ProfileData.from_file(path)
    finally:
        os.unlink(path)


def _load(trace) -> Optional[ProfileData]:
    if isinstance(trace, ProfileData):
        return trace
    path = latest_trace(str(trace))
    return ProfileData.from_file(path) if path else None


# ---------------------------------------------------------------------------
# exclusive / interval-union attribution (the reference's, as it is)
# ---------------------------------------------------------------------------


def _exclusive_segments(evs: List[list]) -> List[list]:
    """Per-line nested sweep that records each event's EXCLUSIVE time as
    explicit ``(start, end)`` segments (r[4] = segment list, r[5] = their
    summed ns).

    Within one trace line spans nest (parent %while/call envelopes above
    their children): a parent's open segment closes when a child starts and
    reopens when the child ends, so a parent's segments cover exactly the
    wall time no child occupies. A partially overlapping (non-nested) span
    simply eats the tail of its "parent"'s coverage — nothing goes
    negative, and the cross-line interval-union pass (:func:`_union_rows`)
    is what resolves genuinely parallel streams.
    """
    evs.sort(key=lambda r: (r[0], -r[1]))
    # frame: [end, seg_open, segments, row]
    stack: List[list] = []

    def _close_through(t: float) -> None:
        while stack and t >= stack[-1][0]:
            end, seg_open, segs, _row = stack.pop()
            if end > seg_open:
                segs.append((seg_open, end))
            if stack:   # the parent's coverage resumes where the child ended
                stack[-1][1] = max(stack[-1][1], end)

    for r in evs:
        start, dur = r[0], r[1]
        _close_through(start)
        if stack:
            top = stack[-1]
            if start > top[1]:
                top[2].append((top[1], start))
            top[1] = max(top[1], start + dur)
        segs: List[Tuple[float, float]] = []
        r.append(segs)
        stack.append([start + dur, start, segs, r])
    _close_through(float("inf"))
    for r in evs:
        r.append(sum(e - s for s, e in r[4]))   # r[5] = exclusive ns
    return evs


def _union_rows(rows: List[list]) -> List[list]:
    """Interval-union exclusive attribution across overlapping lines.

    ``rows`` carry per-line exclusive segments (r[4] from
    :func:`_exclusive_segments`).  Lines of one device plane can genuinely
    overlap (parallel streams: multiple op lines, compute vs DMA-adjacent
    work) — summing their per-line exclusive times then exceeds wall-clock
    and used to be *refused* outright (the pre-PR-14 behavior), which made
    every multi-stream trace unattributable.  Instead, sweep the elementary
    intervals of all segments and split each interval's wall time EQUALLY
    among the events active in it.  Appends r[6] = attributed ns:

      * serial traces: exactly one event active everywhere -> identical to
        the plain exclusive sum (r[6] == r[5]);
      * parallel streams: the attributed total equals the interval UNION,
        so sum(attributed) <= wall by construction.
    """
    bounds = sorted({t for r in rows for seg in r[4] for t in seg})
    idx = {t: i for i, t in enumerate(bounds)}
    starts: Dict[int, List[int]] = {}
    ends: Dict[int, List[int]] = {}
    for rid, r in enumerate(rows):
        r.append(0.0)                      # r[6] = union-attributed ns
        for s, e in r[4]:
            if e > s:
                starts.setdefault(idx[s], []).append(rid)
                ends.setdefault(idx[e], []).append(rid)
    active: Dict[int, list] = {}
    for i in range(len(bounds)):
        for rid in ends.get(i, ()):
            active.pop(rid, None)
        for rid in starts.get(i, ()):
            active[rid] = rows[rid]
        if i + 1 < len(bounds) and active:
            share = (bounds[i + 1] - bounds[i]) / len(active)
            for r in active.values():
                r[6] += share
    return rows


def _check_busy_le_wall(rows: List[list], where: str,
                        tolerance: float = 1.001) -> bool:
    """One serial device line keeps sum(exclusive) <= wall. Returns False
    (and says so) when lines overlap — the interval-union pass then owns
    the attribution instead of the plain per-line exclusive sums."""
    if not rows:
        return True
    wall = max(r[0] + r[1] for r in rows) - min(r[0] for r in rows)
    busy = sum(r[5] for r in rows)
    if busy > wall * tolerance:
        print(f"[device_trace] note: exclusive sum {busy / 1e6:.1f} ms "
              f"exceeds wall {wall / 1e6:.1f} ms on {where} — overlapping "
              f"device lines; attributing by interval union",
              file=sys.stderr)
        return False
    return True


def busy_ns(intervals: Iterable[Tuple[float, float]]) -> float:
    """The union length of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


# ---------------------------------------------------------------------------
# rows: device events (or the CPU's ops) with their attributed time
# ---------------------------------------------------------------------------


def device_rows(trace, exclusive: bool = True) -> Tuple[List[list], str]:
    """(rows, source) of the newest capture: each row ``[start_ns, dur_ns,
    plane, event, segments, exclusive_ns, attributed_ns]``.

    ``source`` is ``"device_streams"``: the kernel, memcpy and memset
    events of every device stream; or, with no device plane, ``"cpu_ops"``:
    the host's ATen and custom ops, each line's nesting swept so a parent
    op keeps only the time no child covers. Attributed ns split time that
    lines share equally among the events active in it (serial lines: the
    exclusive ns), so the rows add up to the busy union. Without
    ``exclusive`` each row keeps its event's whole duration."""
    pd = _load(trace)
    if pd is None:
        return [], "none"
    planes = pd.device_planes()
    source = "device_streams"
    keep = _is_work
    if not planes:
        host = pd.host_plane()
        planes = [host] if host is not None else []
        source = "cpu_ops"
        keep = _is_cpu_work
    inside = _inside_capture(pd, source)
    rows: List[list] = []
    for plane in planes:
        plane_rows: List[list] = []
        for line in plane.lines:
            evs = [[float(ev.start_ns), float(ev.duration_ns), plane.name,
                    ev] for ev in line.events
                   if keep(ev) and inside(ev) and (
                       ev.duration_ns > 0 or source == "device_streams")]
            if not evs:
                continue
            if exclusive:
                plane_rows.extend(_exclusive_segments(evs))
            else:
                for r in evs:
                    r += [[(r[0], r[0] + r[1])], r[1], r[1]]
                plane_rows.extend(evs)
        if plane_rows and exclusive:
            # serial lines: the union pass gives each event its exclusive
            # ns; overlapping ones (parallel streams, host threads): an
            # equal share of the time they share
            _check_busy_le_wall(plane_rows, plane.name)
            _union_rows(plane_rows)
        rows.extend(plane_rows)
    return rows, source


def _inside_capture(pd: ProfileData, source: str):
    """A predicate on a row's event: launched (on any host thread) while
    a :data:`CAPTURE_RANGE` range was open — its runtime call's time for
    a device event, its own start for the CPU lane's op. Every event when
    the trace holds no such range."""
    host = pd.host_plane()
    spans = sorted((ev.start_ns, ev.end_ns) for ln in (host.lines if host
                                                        else ())
                   for ev in ln.events if ev.name == CAPTURE_RANGE
                   and ev.stat("cat") == "user_annotation")
    if not spans:
        return lambda ev: True

    def within(t) -> bool:
        return any(s <= t <= e for s, e in spans)

    if source == "cpu_ops":
        return lambda ev: within(ev.start_ns)
    calls = {ev.stat("correlation"): ev.start_ns
             for ln in host.lines for ev in ln.events
             if ev.stat("correlation") is not None
             and ev.stat("cat") not in _SCOPE_CATS}
    return lambda ev: within(calls.get(ev.stat("correlation"), -1))


def _is_work(ev) -> bool:
    return ev.stat("cat") in _WORK_CATS


def _is_cpu_work(ev) -> bool:
    """The CPU lane's rows: ATen and custom ops (``ns::op``), not the
    autograd engine's wrappers or an autograd node's own event (their
    time stays with the op around them)."""
    return (ev.stat("cat") == "cpu_op" and "::" in ev.name
            and not ev.name.startswith("autograd::"))


def device_events(trace_dir: str, exclusive: bool = False
                  ) -> Iterable[Tuple[str, str, float]]:
    """Yield (plane, event name, ns) for every device kernel, memcpy and
    memset of the newest capture under ``trace_dir`` (the CPU's ops when
    it has no device plane); ``exclusive`` attributes nested and shared
    time as :func:`device_rows` does, else each event's whole duration."""
    rows, _source = device_rows(trace_dir, exclusive=exclusive)
    for r in rows:
        yield r[2], r[3].name, (r[6] if exclusive else r[1])


def launch_scopes(trace) -> Dict[Any, List[Any]]:
    """{correlation id: [host events open at its runtime call, outermost
    first]} for every runtime call that carries a correlation id."""
    pd = _load(trace)
    out: Dict[Any, List[Any]] = {}
    host = pd.host_plane() if pd is not None else None
    if host is None:
        return out
    for line in host.lines:
        scopes = [ev for ev in line.events if ev.stat("cat") in _SCOPE_CATS]
        calls = sorted((ev for ev in line.events
                        if ev.stat("correlation") is not None
                        and ev.stat("cat") not in _SCOPE_CATS),
                       key=lambda ev: ev.start_ns)
        stack: List[Any] = []
        i = 0
        for call in calls:
            t = call.start_ns
            while i < len(scopes) and scopes[i].start_ns <= t:
                while stack and stack[-1].end_ns <= scopes[i].start_ns:
                    stack.pop()
                stack.append(scopes[i])
                i += 1
            while stack and stack[-1].end_ns < t:
                stack.pop()
            out[call.stat("correlation")] = [s for s in stack
                                             if s.end_ns >= t]
    return out


def _cpu_scopes(line_events: Sequence[Any]) -> Dict[int, List[Any]]:
    """{id(event): its enclosing scope events, outermost first} over one
    host line (the CPU lane's rows)."""
    out: Dict[int, List[Any]] = {}
    stack: List[Any] = []
    for ev in line_events:
        if ev.stat("cat") not in _SCOPE_CATS:
            continue
        while stack and stack[-1].end_ns <= ev.start_ns:
            stack.pop()
        out[id(ev)] = list(stack)
        stack.append(ev)
    return out


def kernel_base(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list: ``void (anonymous namespace)::flash_fwd_kernel<
    __nv_bfloat16, 64, false>(Args)`` -> ``flash_fwd_kernel``, so a key
    does not change with an instance. A name that is no C++ signature
    (``Memcpy HtoD (Pageable -> Device)``, a cuBLAS kernel) is kept."""
    s = str(name).replace("(anonymous namespace)::", "")
    if not (s.startswith("void ") or "::" in s or "<" in s):
        return s
    s = re.sub(r"^(void|int|float)\s+", "", s)
    for i, ch in enumerate(s):
        if ch in "<(":
            return s[:i].strip() or str(name)
    return s.strip()


def unanswered_launches(pd: ProfileData) -> List[Any]:
    """The capture's kernel-launch calls on the host (inside its
    :data:`CAPTURE_RANGE`) that no device event answers (the profiler
    lost their kernels), in time order."""
    corrs = {ev.stat("correlation") for p in pd.device_planes()
             for ln in p.lines for ev in ln.events}
    host = pd.host_plane()
    spans = [(ev.start_ns, ev.end_ns) for ln in (host.lines if host else ())
             for ev in ln.events if ev.name == CAPTURE_RANGE]
    return sorted((ev for ln in (host.lines if host else ())
                   for ev in ln.events
                   if "Launch" in ev.name and ev.stat("correlation")
                   is not None and ev.stat("correlation") not in corrs
                   and (not spans or any(s <= ev.start_ns <= e
                                         for s, e in spans))),
                  key=lambda ev: ev.start_ns)


def _unmatched_launches(pd: ProfileData, show: int = 4) -> str:
    """:func:`unanswered_launches` for an error message: how many, and
    the first few with their scope and their time from the window's
    first and last device events."""
    dev = [ev for p in pd.device_planes() for ln in p.lines
           for ev in ln.events]
    t0 = min((ev.start_ns for ev in dev), default=0)
    t1 = max((ev.end_ns for ev in dev), default=0)
    scopes = launch_scopes(pd)
    calls = unanswered_launches(pd)
    zero = sum(1 for ev in dev if ev.duration_ns <= 0)
    shown = "; ".join(
        f"{ev.name} corr {ev.stat('correlation')} at +"
        f"{(ev.start_ns - t0) / 1e3:.1f} µs / -{(t1 - ev.start_ns) / 1e3:.1f}"
        f" µs under {'/'.join(s.name for s in scopes.get(ev.stat('correlation'), [])[-3:])}"
        for ev in calls[:show])
    return (f"; {len(calls)} launch calls with no device event ({shown}); "
            f"{zero} device events of zero duration")


def port_kernel_launches(rows: List[list], costs, pd: Optional[
        ProfileData] = None) -> Dict[int, dict]:
    """Pair the port kernels' device events with the armed launches.

    Returns {id(row): {"kernel", "flops", "bytes", "extra": [part rows]}}
    for each launch's one ``symbols`` event; a ``parts`` event (a merge
    pass) is folded into the last launch of its kernel before it. Events
    of entries sharing a symbol are told apart by launch order against
    ``costs`` (``kernel_costs.LaunchCosts``, or None: no costs, and such
    events keep the shared name). Raises :class:`AttributionError` when a
    kernel's events and its recorded launches do not pair one to one."""
    from ..ops.cuda_kernels import kernel_entries

    def corr(r):
        c = r[3].stat("correlation")
        return (c if isinstance(c, (int, float)) else -1, r[0])

    prim: Dict[Tuple[str, ...], List[list]] = {}
    parts: List[Tuple[Tuple[str, ...], list]] = []
    for r in rows:
        if r[3].stat("cat") != "kernel":
            continue
        entries, is_part = kernel_entries(r[3].name)
        if not entries:
            continue
        (parts.append((entries, r)) if is_part
         else prim.setdefault(entries, []).append(r))
    resolved = costs.resolve() if costs is not None else None
    out: Dict[int, dict] = {}
    for fam, evs in prim.items():
        evs.sort(key=corr)
        if resolved is None:
            for r in evs:
                out[id(r)] = {"kernel": "|".join(fam), "flops": None,
                              "bytes": None, "extra": []}
            continue
        recs = [(n, c) for n, c in resolved if n in fam]
        if len(recs) != len(evs):
            raise AttributionError(
                f"{'/'.join(fam)}: {len(evs)} device events but "
                f"{len(recs)} recorded launches in the capture"
                + (_unmatched_launches(pd) if pd is not None else ""))
        for r, (n, c) in zip(evs, recs):
            out[id(r)] = {"kernel": n, "flops": float(c.flops),
                          "bytes": float(c.nbytes), "extra": []}
    if resolved is not None:
        seen = {n for fam in prim for n in fam}
        missing = sorted({n for n, _c in resolved} - seen)
        if missing:
            raise AttributionError(
                f"launches of {missing} recorded, but no device event of "
                "theirs in the capture (a symbol missing from KERNELS?)")
    for fam, r in parts:
        owners = [p for p in prim.get(fam, ()) if corr(p) < corr(r)]
        if not owners:
            raise AttributionError(f"{r[3].name}: a part of {fam} with no "
                                   "launch before it")
        out[id(max(owners, key=corr))]["extra"].append(r)
    return out


def kernel_rows(trace, steps: int = 1, costs=None) -> Tuple[
        List[Dict[str, Any]], str]:
    """(rows, source): the capture's measured time aggregated by (launch
    scope, kernel) — the rows ``observability.attribution.build`` places
    on the roofline.

    Each row: ``name`` (the port kernel's ``KERNELS`` entry, else the
    kernel's base name), ``op_name`` (the launching scope path and the
    name), ``kernel`` (the entry, or None), ``events``, ``ns`` (attributed,
    a port launch's merge pass included), ``flops`` and ``bytes`` a launch
    (a port kernel's recorded costs; an ``aten`` op's counted FLOPs on its
    first kernel; bytes None where the trace cannot give them), their
    totals ``flops_total`` / ``bytes_total``, and ``opcode`` ``"dot"`` for
    a matrix product's launches."""
    pd = _load(trace)
    rows, source = device_rows(pd, exclusive=True)
    agg: Dict[str, Dict[str, Any]] = {}

    def add(name, scope, ns, flops, nbytes, kernel, dot, events=1):
        op_name = "/".join([s.name for s in scope] + [name])
        a = agg.setdefault(op_name, {
            "name": name, "op_name": op_name, "kernel": kernel,
            "events": 0, "ns": 0.0, "flops_total": None,
            "bytes_total": None, "opcode": "dot" if dot else ""})
        a["events"] += events
        a["ns"] += ns
        if flops is not None:
            a["flops_total"] = (a["flops_total"] or 0.0) + flops
        if nbytes is not None:
            a["bytes_total"] = (a["bytes_total"] or 0.0) + nbytes

    if source == "cpu_ops":
        # an op a row, whatever called it: the lane checks the mechanism,
        # and the op set is the same from run to run
        for r in rows:
            ev = r[3]
            fl = ev.stat("flops")
            add(ev.name, [], r[6], float(fl) if fl else None, None, None,
                ev.name in MATMUL_OPS)
    else:
        scopes = launch_scopes(pd)
        port = port_kernel_launches(rows, costs, pd)
        folded = {id(p) for v in port.values() for p in v["extra"]}
        flops_taken = set()
        for r in rows:
            ev = r[3]
            if id(r) in folded:
                continue
            scope = scopes.get(ev.stat("correlation"), [])
            if id(r) in port:
                p = port[id(r)]
                add(p["kernel"], scope, r[6] + sum(x[6] for x in p["extra"]),
                    p["flops"], p["bytes"], p["kernel"], False)
                continue
            op = scope[-1] if scope else None
            fl = None
            if op is not None and op.stat("flops") and id(op) not in \
                    flops_taken:
                flops_taken.add(id(op))
                fl = float(op.stat("flops"))
            add(kernel_base(ev.name), scope, r[6], fl, None, None,
                op is not None and op.name in MATMUL_OPS)
    steps = max(1, int(steps))
    out = []
    for a in agg.values():
        n = max(1, a["events"])
        a["ns_per_step"] = a["ns"] / steps
        a["flops"] = (a["flops_total"] / n
                      if a["flops_total"] is not None else None)
        a["bytes"] = (a["bytes_total"] / n
                      if a["bytes_total"] is not None else None)
        out.append(a)
    out.sort(key=lambda r: (-r["ns"], r["op_name"]))
    return out, source


def measured_op_rows(trace_dir: str) -> List[dict]:
    """Aggregate measured device ns by the op that launched each event
    (the innermost host op or ``record_function`` range; a port kernel by
    its ``KERNELS`` entry; the CPU lane by the op itself). Rows always sum
    to the measured total."""
    rows, source = kernel_rows(trace_dir)
    agg: Dict[str, List[float]] = {}
    for r in rows:
        parts = r["op_name"].split("/")
        key = r["kernel"] or (parts[-2] if source != "cpu_ops"
                              and len(parts) > 1 else r["name"])
        a = agg.setdefault(key, [0.0, 0])
        a[0] += r["ns"]
        a[1] += r["events"]
    out = [{"op": k, "device_ns": int(v[0]), "events": v[1]}
           for k, v in agg.items()]
    out.sort(key=lambda r: -r["device_ns"])
    return out


def merge_into_trace(rows: List[dict], trace_path: str) -> None:
    """Append the measured rows as a synthetic 'measured device' track to
    a chrome trace (next to the host events)."""
    try:
        with open(trace_path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = {"traceEvents": []}
    ts = 0.0
    for r in rows:
        doc["traceEvents"].append({
            "name": r["op"], "ph": "X", "ts": ts,
            "dur": r["device_ns"] / 1000.0,
            "pid": 1, "tid": 999,
            "args": {"events": r["events"], "track": "measured-device"},
        })
        ts += r["device_ns"] / 1000.0
    with open(trace_path, "w") as f:
        json.dump(doc, f)


def print_rows(rows: List[dict], top: int = 5) -> None:
    total = sum(r["device_ns"] for r in rows) or 1
    print(f"{'Op (measured device time)':<48}{'ns':>12}{'%':>7}{'events':>8}")
    for r in rows[:top]:
        print(f"{r['op']:<48}{r['device_ns']:>12}"
              f"{100.0 * r['device_ns'] / total:>6.1f}%{r['events']:>8}")
