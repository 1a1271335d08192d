"""Per-rank training-gang flight recorder — the port of
``paddle_tpu/observability/flight.py``, with its ring, its sidecar format
(``flight-rank<R>-<pid>.jsonl``, a ``meta`` first line with both clocks)
and its dumps unchanged, so either package's blame engine reads the
other's files.

A dp/fsdp gang fails *dark*: the hang watchdog (parallel/health.py) can
say "rank 2 stopped making progress" and the heartbeat poller can flag a
straggler by rate, but nothing on disk says which rank stalled at which
collective in which step — and ONE wedged rank deadlocks every healthy
peer with no symptom on their side. This module is the per-rank black
box the blame engine (``paddle_tpu_torch.tools.flight_assemble``) reads
after the crash:

- a bounded ring of typed events — ``step_begin``/``step_end``,
  ``dispatch``, ``coll_enter``/``coll_exit`` (host-side collective
  boundary), ``coll_lowered`` (a collective call's fingerprint stamp),
  ``data_wait``, ``ckpt_write``, ``stream_fetch`` — each stamped with
  ``perf_counter_ns``;
- **two monotone sequence streams**: :func:`collective_enter` hands out
  the host-side collective seq (one per blocking collective boundary a
  rank passes — the blame engine's ordinal), and
  :func:`stamp_collective` the fingerprint seq. In the reference that
  stamp fires once per collective baked into a traced program; the port
  runs eagerly, so ``comm_opt.record_collective`` stamps it on EVERY
  collective call (the launch counts are per call too). Every rank of a
  gang makes the same calls in the same order, so both streams still
  agree across ranks by construction: "rank 3 never entered seq 41" is
  a well-defined verdict, and a divergent fingerprint means the ranks
  ran different steps;
- an append+flush per-rank JSONL sidecar (``flight-rank<R>-<pid>.jsonl``
  under ``$PADDLE_FLIGHT_DIR``) with the same crash-surviving discipline
  as :mod:`.spans` — one flushed line per event, so a SIGKILLed or
  SIGSTOPped rank leaves everything up to its last completed event on
  disk (a torn final line is tolerated by the assembler);
- ring dumps (:func:`dump`) on hang-watchdog fire (``cause="hang"``,
  into the watchdog bundle dir), on TrainMonitor anomaly dumps
  (``cause="anomaly"``), and at interpreter exit (``cause="exit"``),
  counted by ``paddle_flight_dump_total{cause}``.

The first sidecar line is a ``meta`` record carrying BOTH clocks
(``t_ns`` = perf_counter_ns, ``ts`` = wall) plus rank/pid/attempt: the
assembler maps each file's monotonic timestamps onto the shared wall
clock to build the cross-rank step-skew timeline.

Cost model: a disabled recorder is one global read; an enabled
:func:`event` is one dict build and a deque append (the ring holds 4096
events, so the per-call stamps of a step with a hundred collectives stay
bounded); only an attached sidecar adds a flushed write per event.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, IO, List, Optional, Union

from .metrics import default_registry

__all__ = [
    "FlightRecorder", "default_recorder", "event", "collective_enter",
    "collective_exit", "collective", "stamp_collective", "dump",
    "flight_enabled", "set_flight_enabled", "flight_path", "attach_sink",
    "maybe_attach_from_env", "meta_record", "note_blame", "reset",
    "ENV_DIR",
]

# process-wide kill switch, mirroring spans.set_tracing_enabled (the
# flight on/off pairs throw it)
_ENABLED = True


def flight_enabled() -> bool:
    return _ENABLED


def set_flight_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


# env contract (exported by parallel/launch.py, mirrored by
# PADDLE_HEALTH_DIR / PADDLE_GOODPUT_DIR)
ENV_DIR = "PADDLE_FLIGHT_DIR"

_REG = default_registry()
_m_dumps = _REG.counter(
    "paddle_flight_dump_total",
    "Flight-recorder ring dumps by cause (hang/anomaly/exit/manual)",
    ("cause",))
_m_skew = _REG.gauge(
    "paddle_step_skew_ms",
    "Cross-rank step-begin skew (max-min, ms) from the last blame "
    "assembly the supervisor ran")
_m_blamed = _REG.gauge(
    "paddle_blamed_rank",
    "Rank blamed by the last hang blame assembly (-1 = none/unknown)")

# -- sequence streams -------------------------------------------------------
# One lock guards both counters; every gang rank advances them in the
# same order (identical program, identical step loop), so the numbers
# agree fleet-wide without any cross-rank coordination.
_seq_lock = threading.Lock()
_host_seq = 0       # coll_enter/coll_exit ordinal (the blame ordinal)
_lowered_seq = 0    # collective calls stamped (the fingerprint)


def _next_host_seq() -> int:
    global _host_seq
    with _seq_lock:
        _host_seq += 1
        return _host_seq


def _next_lowered_seq() -> int:
    global _lowered_seq
    with _seq_lock:
        _lowered_seq += 1
        return _lowered_seq


def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or "0")
    except ValueError:
        return 0


def _attempt() -> int:
    try:
        return int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0") or "0")
    except ValueError:
        return 0


def meta_record() -> Dict[str, Any]:
    """The identity + clock-anchor record: first line of every sidecar,
    header of every dump.  ``ts``/``t_ns`` sampled together so the
    assembler can map this process's monotonic clock onto the wall."""
    return {"ev": "meta", "t_ns": time.perf_counter_ns(),
            "ts": time.time(), "rank": _rank(), "pid": os.getpid(),
            "attempt": _attempt()}


class FlightRecorder:
    """Bounded event ring + optional append/flush JSONL sidecar
    (structure mirrors spans.SpanTracer — the ring records always, the
    sidecar persists each event the instant it happens)."""

    def __init__(self, ring: int = 4096,
                 sink: Optional[Union[str, IO]] = None):
        import collections

        self._ring = collections.deque(maxlen=int(ring))
        self._sink: Optional[IO] = None
        self._own_sink = False
        self._sink_lock = threading.Lock()
        if sink is not None:
            self.set_sink(sink)

    def event(self, ev: str, **fields: Any) -> None:
        """Record one typed event; no-op while the recorder is off."""
        if not _ENABLED:
            return
        rec = {"ev": ev, "t_ns": time.perf_counter_ns()}
        rec.update(fields)
        self._append(rec)

    def _append(self, rec: dict) -> None:
        self._ring.append(rec)
        sink = self._sink
        if sink is not None:
            with self._sink_lock:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()

    def set_sink(self, path_or_file: Optional[Union[str, IO]]) -> None:
        """JSONL sidecar: one flushed line per event (None detaches).
        The ring keeps recording either way."""
        with self._sink_lock:
            if self._own_sink and self._sink is not None:
                self._sink.close()
            if path_or_file is None:
                self._sink, self._own_sink = None, False
            elif hasattr(path_or_file, "write"):
                self._sink, self._own_sink = path_or_file, False
            else:
                self._sink = open(path_or_file, "a")
                self._own_sink = True

    def events(self) -> List[dict]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def summary(self) -> Dict[str, int]:
        """Event counts by kind over the ring."""
        out: Dict[str, int] = {}
        for rec in list(self._ring):
            out[rec.get("ev", "?")] = out.get(rec.get("ev", "?"), 0) + 1
        return out


_default = FlightRecorder()


def default_recorder() -> FlightRecorder:
    return _default


def event(ev: str, **fields: Any) -> None:
    """Module-level :meth:`FlightRecorder.event` on the default ring."""
    _default.event(ev, **fields)


# -- collective stamping ----------------------------------------------------

def collective_enter(name: str, nbytes: int = 0) -> int:
    """Stamp entry into a blocking collective boundary; returns the
    host-side seq (0 while disabled).  Pair with
    :func:`collective_exit` — a rank whose sidecar ends with an
    unmatched ``coll_enter`` died INSIDE the exchange; a rank whose
    last seq trails the gang never reached it."""
    if not _ENABLED:
        return 0
    seq = _next_host_seq()
    _default.event("coll_enter", seq=seq, name=name, bytes=int(nbytes))
    return seq


def collective_exit(seq: int, name: Optional[str] = None) -> None:
    """Stamp completion of the collective opened as ``seq``."""
    if not _ENABLED or not seq:
        return
    _default.event("coll_exit", seq=seq,
                   **({"name": name} if name else {}))


@contextlib.contextmanager
def collective(name: str, nbytes: int = 0):
    """``with flight.collective("allreduce_grads", nbytes):`` — the
    enter/exit pair around one blocking exchange; yields the seq."""
    seq = collective_enter(name, nbytes)
    try:
        yield seq
    finally:
        collective_exit(seq, name)


def stamp_collective(op: str, dtype: Any, payload_bytes: int, ranks: int,
                     site: Optional[str] = None) -> int:
    """Stamp one collective call (from ``comm_opt.record_collective``,
    through which every psum / all_gather / ppermute / reduce-scatter /
    all_to_all of ``parallel/*`` and ``models/gpt.py`` counts its wire
    bytes). The port stamps each eager call, where the reference stamps
    each collective at trace time; the calls are identically ordered on
    every rank, so the stream is the fingerprint the assembler
    cross-checks for divergent ranks. Returns the stamp's seq (0 while
    disabled)."""
    if not _ENABLED:
        return 0
    ls = _next_lowered_seq()
    _default.event("coll_lowered", lseq=ls, op=str(op), dtype=str(dtype),
                   bytes=int(payload_bytes), ranks=int(ranks),
                   site=site or str(op))
    return ls


# -- sidecar / env wiring ---------------------------------------------------

def flight_path(flight_dir: str, rank: Optional[int] = None) -> str:
    """Per-rank sidecar file inside a shared flight dir.  The pid keeps
    restarted incarnations from clobbering each other; the blame engine
    (``paddle_tpu_torch.tools.flight_assemble``) globs ``flight-*.jsonl``
    and groups incarnations by the meta record's ``attempt``."""
    r = _rank() if rank is None else int(rank)
    return os.path.join(flight_dir, f"flight-rank{r}-{os.getpid()}.jsonl")


def attach_sink(flight_dir: str, rank: Optional[int] = None) -> str:
    """Point the default ring's sidecar at this rank's file in
    ``flight_dir`` (created if missing) and write the meta header.
    Append-at-event with per-line flush — a SIGKILLed rank leaves every
    completed event on disk for blame assembly."""
    os.makedirs(flight_dir, exist_ok=True)
    path = flight_path(flight_dir, rank)
    _default.set_sink(path)
    _default._append(meta_record())
    return path


_attached: Optional[str] = None
_exit_registered = False


def maybe_attach_from_env() -> Optional[str]:
    """Idempotent env-driven wiring (the fault-bench worker calls this):
    when ``$PADDLE_FLIGHT_DIR`` is
    set, attach the per-rank sidecar and register the at-exit ring
    dump.  Returns the sidecar path, or None when unconfigured."""
    global _attached, _exit_registered
    flight_dir = os.environ.get(ENV_DIR)
    if not flight_dir:
        return None
    if _attached is not None:
        return _attached
    try:
        _attached = attach_sink(flight_dir)
    except OSError:
        return None
    if not _exit_registered:
        atexit.register(_dump_at_exit)
        _exit_registered = True
    return _attached


def _dump_at_exit() -> None:
    dump("exit")


def dump(cause: str, dir_path: Optional[str] = None) -> Optional[str]:
    """Write a ring snapshot (meta + every buffered event) as one JSON
    doc into ``dir_path`` (default ``$PADDLE_FLIGHT_DIR``) and count it
    under ``paddle_flight_dump_total{cause}``.  Never raises — dump
    sites are forensics paths (watchdog fire, anomaly dump, atexit)
    where a second failure must not mask the first."""
    try:
        d = dir_path or os.environ.get(ENV_DIR)
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        doc = dict(meta_record(), cause=str(cause),
                   events=_default.events())
        path = os.path.join(
            d, f"flight.dump.{cause}.rank{_rank()}.{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        _m_dumps.labels(str(cause)).inc()
        return path
    except Exception:
        return None


def note_blame(rank: Optional[int], skew_ms: Optional[float] = None) -> None:
    """Surface a blame verdict on the metric plane (the supervisor calls
    this after running the blame engine on a hang-cause restart)."""
    _m_blamed.set(-1 if rank is None else int(rank))
    if skew_ms is not None:
        _m_skew.set(float(skew_ms))


def reset(detach: bool = False) -> None:
    """Tests/bench hook: clear the ring and restart both seq streams
    (a fresh incarnation).  ``detach=True`` also drops the sidecar."""
    global _host_seq, _lowered_seq, _attached
    with _seq_lock:
        _host_seq = 0
        _lowered_seq = 0
    _default.clear()
    if detach:
        _default.set_sink(None)
        _attached = None
