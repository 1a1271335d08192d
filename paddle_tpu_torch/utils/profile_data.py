"""A ``torch.profiler`` capture read as planes, lines and events — the
port's counterpart of ``paddle_tpu/utils/xplane.py`` (which decodes XSpace
protobufs), with the same surface:

    pd = ProfileData.from_file(path)      # or from_trace_dir(dir)
    for plane in pd.planes:               # .name
        for line in plane.lines:          # .name
            for ev in line.events:        # .name, .start_ns, .duration_ns
                dict(ev.stats)            # {'cat': 'kernel', ...}

It reads the chrome-trace JSON that ``torch.profiler`` exports
(``prof.export_chrome_trace(path)``, or ``tensorboard_trace_handler``'s
``*.pt.trace.json`` in a trace directory):

- the host is one plane, ``/host:CPU``, with one line a (process,
  thread): its ``cpu_op`` events (``aten::`` ops, autograd nodes, custom
  ops), ``user_annotation`` ranges (``record_function``) and CUDA runtime
  calls (``cudaLaunchKernel``, ...);
- each CUDA device is one plane, ``/device:GPU:<index>``, with one line a
  stream: its ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events and the
  ``gpu_user_annotation`` spans the profiler mirrors onto the stream.

An event's ``stats`` are its trace ``args`` plus ``cat``; the links the
attribution joins on are ``correlation`` (a device kernel and the runtime
call that launched it share one) and ``External id`` (a runtime call and
the host op it ran in). Times are nanoseconds on the trace's one clock:
``torch.profiler`` puts host and device events on it already.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["ProfileData", "DEVICE_CATS", "latest_trace"]

# event categories that run on a device stream
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")

HOST_PLANE = "/host:CPU"


class Event:
    __slots__ = ("name", "start_ns", "duration_ns", "_stats")

    def __init__(self, name: str, start_ns: int, duration_ns: int,
                 stats: Dict[str, Any]):
        self.name = name
        self.start_ns = start_ns
        self.duration_ns = duration_ns
        self._stats = stats

    @property
    def stats(self) -> List[Tuple[str, Any]]:
        """(name, value) pairs, so ``dict(ev.stats)`` works."""
        return list(self._stats.items())

    def stat(self, key: str, default=None):
        return self._stats.get(key, default)

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.duration_ns

    def __repr__(self):
        return (f"Event({self.name!r}, start_ns={self.start_ns}, "
                f"duration_ns={self.duration_ns})")


class Line:
    __slots__ = ("name", "events")

    def __init__(self, name: str, events: List[Event]):
        self.name = name
        self.events = events


class Plane:
    __slots__ = ("name", "_lines")

    def __init__(self, name: str, lines: List[Line]):
        self.name = name
        self._lines = lines

    @property
    def lines(self) -> Iterator[Line]:
        return iter(self._lines)


def _ns(us) -> int:
    """A chrome-trace time in microseconds (float, ns precision) as
    integer nanoseconds."""
    return int(round(float(us) * 1000.0))


def latest_trace(trace_dir: str) -> Optional[str]:
    """The newest ``*.json`` (or ``*.json.gz``) capture under
    ``trace_dir`` (or ``trace_dir`` itself when it is a file)."""
    if os.path.isfile(trace_dir):
        return trace_dir
    files = [f for pat in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    return max(files, key=os.path.getmtime) if files else None


class ProfileData:
    """A capture's planes (the host, then each device by index)."""

    def __init__(self, planes: List[Plane], meta: Dict[str, Any]):
        self._planes = planes
        self.meta = meta

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "ProfileData":
        host: Dict[Tuple[Any, Any], List[Event]] = {}
        host_names: Dict[Tuple[Any, Any], str] = {}
        dev: Dict[int, Dict[Any, List[Event]]] = {}
        for e in doc.get("traceEvents", ()):
            ph = e.get("ph")
            if ph == "M":
                if e.get("name") == "thread_name":
                    host_names[(e.get("pid"), e.get("tid"))] = str(
                        (e.get("args") or {}).get("name", ""))
                continue
            if ph != "X" or "ts" not in e:
                continue
            args = dict(e.get("args") or {})
            cat = str(e.get("cat", ""))
            args["cat"] = cat
            ev = Event(str(e.get("name", "")), _ns(e["ts"]),
                       _ns(e.get("dur", 0)), args)
            if cat in DEVICE_CATS:
                d = args.get("device", e.get("pid", 0))
                try:
                    d = int(d)
                except (TypeError, ValueError):
                    d = 0
                stream = args.get("stream", e.get("tid", 0))
                dev.setdefault(d, {}).setdefault(stream, []).append(ev)
            else:
                host.setdefault((e.get("pid"), e.get("tid")), []).append(ev)
        planes: List[Plane] = []
        if host:
            lines = []
            for key in sorted(host, key=lambda k: (str(k[0]), str(k[1]))):
                evs = sorted(host[key], key=lambda v: (v.start_ns,
                                                       -v.duration_ns))
                name = host_names.get(key) or f"thread {key[1]}"
                lines.append(Line(f"{name} (pid {key[0]}, tid {key[1]})",
                                  evs))
            planes.append(Plane(HOST_PLANE, lines))
        for d in sorted(dev):
            lines = []
            for stream in sorted(dev[d], key=str):
                evs = sorted(dev[d][stream],
                             key=lambda v: (v.start_ns, -v.duration_ns))
                lines.append(Line(f"stream {stream}", evs))
            planes.append(Plane(f"/device:GPU:{d}", lines))
        meta = {k: v for k, v in doc.items() if k != "traceEvents"}
        return cls(planes, meta)

    @classmethod
    def from_file(cls, path: str) -> "ProfileData":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            return cls.from_json(json.load(f))

    @classmethod
    def from_trace_dir(cls, trace_dir: str) -> Optional["ProfileData"]:
        """The newest capture under ``trace_dir``; None when there is
        none."""
        path = latest_trace(trace_dir)
        return cls.from_file(path) if path else None

    @property
    def planes(self) -> Iterator[Plane]:
        return iter(self._planes)

    def device_planes(self) -> List[Plane]:
        return [p for p in self._planes if p.name.startswith("/device:")]

    def host_plane(self) -> Optional[Plane]:
        return next((p for p in self._planes if p.name == HOST_PLANE), None)
