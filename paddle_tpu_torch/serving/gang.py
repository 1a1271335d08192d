"""Replicated serving gang: N engine replicas behind one front door, with
failover, automatic recycling and idempotent request dispatch — the port
of ``paddle_tpu/serving/gang.py``.

The training side survives a worker's death through
``parallel/launch.py``'s supervised restarts; this module is the serving
twin, on the same contracts:

- **Replicas are subprocesses** (``serving/replica.py``), each an engine,
  a scheduler and a :class:`FrontDoor` on its own ephemeral port,
  reporting readiness through ``ready.json`` and liveness through a
  heartbeat file.
- **Health**: the supervisor thread watches three signals a replica —
  process exit (43 -> ``hang``, 44 -> ``poisoned``, anything else, a
  signal's death included -> ``crash``), the ``/health`` probe (status
  ``poisoned`` or ``degraded``, or no answer) and the heartbeat's age (a
  wedged process that still answers TCP). Any of them recycles the
  replica: SIGTERM, grace, SIGKILL, wait for the exit, respawn — counted in
  ``paddle_serve_replica_restarts_total{cause}`` while the siblings keep
  serving.
- **Failover with idempotent request ids**: every request carries an id
  (the client's ``request_id`` or one the gang assigns). A replica dying
  mid-request breaks the forwarded connection; the router drops the
  partial and sends the SAME request to a sibling, which prefills it
  again (``paddle_serve_failover_requests_total``). An answered id is
  cached, so a client's retry gets the recorded response, never a second
  generation; a duplicate arriving while the first is in flight waits for
  it. A client never sees a lost or a doubled answer.
- **Warm restart**: each slot owns a persistent prefix store directory
  (``serving/prefix_store.py``); a recycled replica restores its
  published pages on boot.
- **Phases**: ``GangConfig.roles`` types each slot ``prefill`` /
  ``decode`` / ``colocated``. With both phase fleets present,
  ``/generate`` runs phased — the prefill replica to the first token, the
  KV pages pushed over the decode replica's socket
  (``serving/kv_transfer.py``; inline JSON for stubs), decode there. Any
  phase failure degrades the SAME request to colocated dispatch, counted
  in ``paddle_serve_disagg_fallback_total{reason}``, never dropped.
- **Kernels**: a gang of card replicas builds the kernels once, in the
  supervisor, before the first spawn; each replica loads the cached
  library and never races an ``nvcc`` build.

Replicas are separate processes: on a host with several cards, pin each to
its own with ``per_replica={i: {"env": {"CUDA_VISIBLE_DEVICES": "<i>"}}}``
(``replica.py`` sets it before importing ``torch``). Without it every
replica opens the first visible card, as two share the one H100 in
``chip_smoke.py`` phase 4g; the pinning itself is untried on one card.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple

from ..observability import fleet as _fleet
from ..observability import prom as _prom
from ..observability import slo as _slo
from ..observability import spans as _spans
from ..parallel import health as _health
from . import metrics as smetrics
from .replica import HEARTBEAT_NAME, POISONED_EXIT_CODE, READY_NAME

__all__ = ["GangConfig", "ReplicaGang", "ReplicaHandle", "GangFrontDoor"]

_REPLICA_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "replica.py")


def _exit_cause(ret: Optional[int]) -> str:
    """Popen returncode -> restart-cause label. Mirrors
    ``parallel.launch._restart_cause`` with the serving-specific
    poisoned code added."""
    if ret == _health.HANG_EXIT_CODE:
        return "hang"
    if ret == POISONED_EXIT_CODE:
        return "poisoned"
    return "crash"


@dataclasses.dataclass(frozen=True)
class GangConfig:
    n_replicas: int = 2
    # phases: one role a replica slot
    # ("prefill" | "decode" | "colocated"). Empty = every slot
    # colocated (the pre-disagg gang). When both a prefill and a decode
    # slot are configured, /generate dispatch runs phased: prefill on a
    # prefill replica, KV handoff, decode on a decode replica — any
    # phase failure degrades to classic colocated dispatch (never drops)
    roles: Tuple[str, ...] = ()
    # supervisor probe cadence + the liveness deadline: an unreachable
    # /health or a heartbeat older than hang_deadline_s recycles the
    # replica with cause=hang (the worker's own watchdog usually beats
    # this by exiting 43 first — this is the backstop for a process
    # wedged outside the engine loop)
    probe_interval_s: float = 0.5
    probe_timeout_s: float = 2.0
    hang_deadline_s: float = 10.0
    ready_timeout_s: float = 180.0
    grace_period_s: float = 3.0
    restart_backoff_s: float = 0.2
    max_restarts_per_replica: int = 8
    # failover: how many distinct replica incarnations one request may
    # try before the router gives up with 503
    max_failover_attempts: int = 4
    dedup_capacity: int = 4096
    default_timeout_s: float = 30.0
    # fleet observability: the supervisor's poll cadence for
    # the FLEET.json / merged-exposition view, and the bound on the
    # slow-request forensic dir
    fleet_poll_interval_s: float = 2.0
    forensic_keep: int = 16


class ReplicaHandle:
    """One replica slot: the subprocess, its readiness and heartbeat files,
    and restart bookkeeping. A slot survives recycles; the process (and
    its port) changes each incarnation. ``ready_record`` is the current
    incarnation's ``ready.json`` (its start-up stamps included) and
    ``spawned_at`` the wall time it was spawned."""

    def __init__(self, index: int, config_path: str, run_dir: str,
                 role: str = "colocated"):
        self.index = int(index)
        self.config_path = config_path
        self.run_dir = run_dir
        self.role = str(role)
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.kv_port: Optional[int] = None   # KV transfer socket (decode)
        self.queue_depth = 0                 # refreshed by /health probes
        self.restored_prefix_records = 0
        self.incarnation = 0
        self.restarts = 0
        self.last_cause: Optional[str] = None
        self.inflight = 0                 # router-side load counter
        self.probe_misses = 0
        self.spawned_at: Optional[float] = None
        self.ready_record: Dict[str, Any] = {}
        self._log = None

    # -- lifecycle ---------------------------------------------------------
    def spawn(self, env: Dict[str, str]) -> None:
        for name in (READY_NAME, HEARTBEAT_NAME):
            try:
                os.remove(os.path.join(self.run_dir, name))
            except OSError:
                pass
        self.port = None
        self.kv_port = None
        self.queue_depth = 0
        self.probe_misses = 0
        self.ready_record = {}
        self.incarnation += 1
        if self._log is None or self._log.closed:
            self._log = open(os.path.join(self.run_dir, "worker.log"), "a")
        self.spawned_at = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, _REPLICA_SCRIPT, "--config", self.config_path],
            env=env, stdout=self._log, stderr=subprocess.STDOUT)

    def kill(self, sig=signal.SIGKILL) -> None:
        """Deliver ``sig`` to the current incarnation (fault injection
        and supervisor recycle both come through here)."""
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.send_signal(sig)
            except OSError:
                pass

    def stop(self, grace_s: float) -> None:
        """SIGTERM, ``grace_s`` to exit, then SIGKILL and wait: the next
        incarnation never starts beside a process that still holds the
        card."""
        if self.proc is None:
            return
        self.kill(signal.SIGTERM)
        try:
            self.proc.wait(timeout=max(0.1, grace_s))
        except subprocess.TimeoutExpired:
            self.kill(signal.SIGKILL)
            self.proc.wait()
        if self._log is not None and not self._log.closed:
            self._log.close()

    # -- liveness ----------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def check_ready(self) -> bool:
        """Refresh ``self.port`` from the incarnation's ready file (the
        pid gate rejects a stale file from a killed predecessor)."""
        if self.port is not None:
            return True
        if not self.alive:
            return False
        try:
            with open(os.path.join(self.run_dir, READY_NAME)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return False
        if rec.get("pid") != self.proc.pid:
            return False
        self.port = int(rec["port"])
        self.ready_record = rec
        kvp = rec.get("kv_port")
        self.kv_port = int(kvp) if kvp else None
        self.restored_prefix_records = int(
            rec.get("restored_prefix_records", 0))
        return True

    def heartbeat(self) -> Optional[Dict[str, Any]]:
        """The incarnation's last heartbeat record (None before the first)."""
        try:
            with open(os.path.join(self.run_dir, HEARTBEAT_NAME)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def heartbeat_age_s(self) -> Optional[float]:
        rec = self.heartbeat()
        if rec is None:
            return None
        return max(0.0, time.time() - float(rec.get("ts", 0)))

    # -- HTTP --------------------------------------------------------------
    def get_json(self, path: str, timeout_s: float) -> Dict[str, Any]:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}{path}",
                timeout=timeout_s) as r:
            return json.loads(r.read().decode())

    def get_text(self, path: str, timeout_s: float = 5.0) -> str:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}{path}",
                timeout=timeout_s) as r:
            return r.read().decode()

    def post_json(self, path: str, body: Dict[str, Any],
                  timeout_s: float) -> Tuple[int, Dict[str, Any]]:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            # 4xx/5xx with a JSON body is a PROTOCOL answer, not a
            # transport fault — the router decides what to do with it
            try:
                return e.code, json.loads(e.read().decode())
            except ValueError:
                return e.code, {"error": f"HTTP {e.code}"}

    def post_generate(self, body: Dict[str, Any],
                      timeout_s: float) -> Tuple[int, Dict[str, Any]]:
        return self.post_json("/generate", body, timeout_s)


class ReplicaGang:
    """Spawn, supervise, and route over ``n_replicas`` replica workers.

    ``worker_config`` is the shared replica config (``model``,
    ``engine``, ``scheduler``, ``device`` — serving/replica.py); the gang
    stamps each slot's ``index``, ``run_dir`` and ``prefix_store_dir``
    into the replica's own config file under ``run_dir``, and
    ``per_replica`` overrides keys of one slot (fault injection; ``env``
    to pin a card)."""

    def __init__(self, worker_config: Dict[str, Any], run_dir: str,
                 cfg: Optional[GangConfig] = None,
                 prefix_store: bool = False,
                 env: Optional[Dict[str, str]] = None,
                 per_replica: Optional[Dict[int, dict]] = None):
        self.cfg = cfg or GangConfig()
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self._env = dict(os.environ if env is None else env)
        # the health env contract: the worker's engine loop stamps
        # progress; a wedged loop exits 43 on its own
        self._env.setdefault(_health.ENV_DEADLINE,
                             str(float(self.cfg.hang_deadline_s)))
        self._env.setdefault(_health.ENV_DIR,
                             os.path.join(self.run_dir, "health"))
        # every process of the gang, supervisor and replicas, appends its
        # spans to its own JSONL under one trace dir; tools/trace_assemble
        # stitches them into one timeline a request
        self.trace_dir = os.path.join(self.run_dir, "trace")
        self._sink_path = _spans.attach_process_sink(self.trace_dir, "gang")
        roles = tuple(self.cfg.roles)
        if roles and len(roles) != self.cfg.n_replicas:
            raise ValueError(
                f"GangConfig.roles has {len(roles)} entries for "
                f"{self.cfg.n_replicas} replicas")
        for role in roles:
            if role not in ("prefill", "decode", "colocated"):
                raise ValueError(f"unknown replica role {role!r}")
        self.replicas: List[ReplicaHandle] = []
        for i in range(self.cfg.n_replicas):
            rdir = os.path.join(self.run_dir, f"replica{i}")
            os.makedirs(rdir, exist_ok=True)
            role = roles[i] if roles else "colocated"
            rc = dict(worker_config, index=i, run_dir=rdir, role=role,
                      trace_dir=self.trace_dir)
            if "engine" in rc:
                rc["engine"] = dict(rc["engine"], role=role)
            if role == "decode" and "stub" not in rc:
                # decode engine replicas take KV pushes over the socket
                # channel (stubs ride the handoff inline in JSON)
                rc["kv_server"] = True
            # per-slot overrides (the fault bench injects faults into ONE
            # replica while its siblings stay clean)
            rc.update((per_replica or {}).get(i, {}))
            if prefix_store:
                rc["prefix_store_dir"] = os.path.join(
                    self.run_dir, "prefix_store", f"replica{i}")
            cpath = os.path.join(rdir, "config.json")
            with open(cpath, "w") as f:
                json.dump(rc, f, indent=1)
            self.replicas.append(ReplicaHandle(i, cpath, rdir, role=role))
        self.restart_causes: Dict[str, int] = {}
        self.failovers = 0
        self.disagg_requests = 0          # served via prefill->decode
        self.disagg_fallbacks = 0         # degraded to colocated
        self._rid = itertools.count(1)
        self._dedup_lock = threading.Lock()
        self._completed: "OrderedDict[str, Tuple[int, dict]]" = \
            OrderedDict()
        self._inflight: Dict[str, threading.Event] = {}
        self._rr = itertools.count()      # round-robin tiebreak
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # the SLO engine (burn-rate alerts, an error-budget ledger that
        # survives warm restarts) fed from dispatch outcomes, and the fleet
        # poller that folds the replicas' /metrics and heartbeats into
        # FLEET.json and the merged /fleet exposition
        self.slo = _slo.SLOEngine(
            ledger_dir=os.path.join(self.run_dir, "slo_ledger"),
            forensics=_slo.ForensicDir(
                os.path.join(self.run_dir, "forensics"),
                keep=self.cfg.forensic_keep),
            state_fn=self.health)
        _slo.set_default_engine(self.slo)
        self.fleet = _fleet.FleetPoller(
            self._collect_fleet,
            out_path=os.path.join(self.run_dir, "FLEET.json"),
            interval_s=self.cfg.fleet_poll_interval_s,
            slo=self.slo)

    # -- lifecycle ---------------------------------------------------------
    def _build_kernels(self) -> None:
        """Build the kernels here, once, when a replica serves on a card:
        the respawned replicas load the cached library, and no two of them
        race an nvcc build."""
        for r in self.replicas:
            with open(r.config_path) as f:
                rc = json.load(f)
            if rc.get("stub") is None and \
                    str(rc.get("device", "cuda")).startswith("cuda"):
                from ..ops import _build

                _build.build()
                return

    def start(self, wait_ready: bool = True) -> "ReplicaGang":
        self._build_kernels()
        for r in self.replicas:
            r.spawn(self._env)
        if wait_ready:
            self.wait_ready()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="gang-monitor")
        self._monitor.start()
        self.fleet.start()
        return self

    def wait_ready(self, timeout_s: Optional[float] = None) -> None:
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.cfg.ready_timeout_s)
        while time.monotonic() < deadline:
            pending = [r for r in self.replicas if not r.check_ready()]
            if not pending:
                return
            dead = [r for r in pending if not r.alive]
            for r in dead:
                raise RuntimeError(
                    f"replica {r.index} died during startup "
                    f"(exit {r.proc.returncode}) — see "
                    f"{os.path.join(r.run_dir, 'worker.log')}")
            time.sleep(0.1)
        raise TimeoutError(
            f"replicas {[r.index for r in self.replicas if r.port is None]}"
            f" not ready within {self.cfg.ready_timeout_s}s")

    def stop(self) -> None:
        self._stop.set()
        self.fleet.stop()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        for r in self.replicas:
            r.stop(self.cfg.grace_period_s)
        try:
            self.slo.close()
        except Exception:
            pass
        # the process's span sink goes with the gang that attached it
        tracer = _spans.default_tracer()
        if getattr(tracer._sink, "name", None) == self._sink_path:
            tracer.set_sink(None)

    # -- supervision -------------------------------------------------------
    def _recycle(self, r: ReplicaHandle, cause: str, detail: str) -> None:
        r.last_cause = cause
        r.restarts += 1
        self.restart_causes[cause] = self.restart_causes.get(cause, 0) + 1
        smetrics.m_replica_restarts.labels(cause).inc()
        sys.stderr.write(
            f"[gang] recycling replica {r.index} (cause={cause}: "
            f"{detail}); siblings keep serving\n")
        r.stop(self.cfg.grace_period_s if cause == "poisoned" else 0.2)
        if r.restarts > self.cfg.max_restarts_per_replica:
            sys.stderr.write(
                f"[gang] replica {r.index} exceeded "
                f"{self.cfg.max_restarts_per_replica} restarts — "
                "leaving it down\n")
            return
        time.sleep(self.cfg.restart_backoff_s)
        r.spawn(self._env)

    def _probe(self, r: ReplicaHandle) -> None:
        """One health probe of a ready replica; classifies and recycles
        on poisoned/degraded/unreachable/stale-heartbeat."""
        try:
            h = r.get_json("/health", self.cfg.probe_timeout_s)
            r.probe_misses = 0
        except Exception as e:
            r.probe_misses += 1
            hb = r.heartbeat_age_s()
            if (r.probe_misses * self.cfg.probe_interval_s
                    >= self.cfg.hang_deadline_s) or \
                    (hb is not None and hb >= self.cfg.hang_deadline_s):
                self._recycle(r, "hang",
                              f"/health unreachable x{r.probe_misses}, "
                              f"heartbeat age {hb}: {e}")
            return
        r.queue_depth = int(h.get("queue_depth") or 0)
        status = h.get("status")
        if status == "poisoned":
            self._recycle(r, "poisoned",
                          h.get("engine_poisoned", "engine poisoned"))
        elif status == "degraded":
            self._recycle(r, "crash", "engine loop died (degraded)")
        else:
            hb = r.heartbeat_age_s()
            if hb is not None and hb >= self.cfg.hang_deadline_s:
                self._recycle(r, "hang", f"heartbeat stale ({hb:.1f}s)")

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.cfg.probe_interval_s):
            for r in self.replicas:
                if self._stop.is_set():
                    return
                if r.proc is None:
                    continue
                ret = r.proc.poll()
                if ret is not None:
                    self._recycle(r, _exit_cause(ret),
                                  f"exit code {ret}")
                    continue
                if r.check_ready():
                    self._probe(r)

    # -- fleet view --------------------------------------------------------
    def _collect_fleet(self) -> List["_fleet.ReplicaSample"]:
        """One fleet-poll sweep: scrape every ready replica's /metrics
        and heartbeat into :class:`ReplicaSample` rows (the poller turns
        them into FLEET.json + the merged exposition)."""
        samples = []
        for r in self.replicas:
            alive = r.alive
            text = None
            if alive and r.check_ready():
                try:
                    text = r.get_text("/metrics",
                                      timeout_s=self.cfg.probe_timeout_s)
                except Exception:
                    _fleet.m_fleet_scrape_errors.inc()
            samples.append(_fleet.ReplicaSample(
                index=r.index, role=r.role, alive=alive,
                heartbeat_age_s=r.heartbeat_age_s(),
                metrics_text=text, incarnation=r.incarnation,
                inflight=r.inflight))
        return samples

    # -- routing -----------------------------------------------------------
    def ready_replicas(self,
                       role: Optional[str] = None) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.alive and r.check_ready()
                and (role is None or r.role == role)]

    def _pick(self, exclude,
              role: Optional[str] = None) -> Optional[ReplicaHandle]:
        """Least-loaded ready replica not in ``exclude`` (an (index,
        incarnation) set — a RECYCLED replica is a fresh candidate).
        Load = router-side inflight + the probed queue depth (the
        drain-rate signal a remote scheduler exposes)."""
        cands = [r for r in self.ready_replicas(role)
                 if (r.index, r.incarnation) not in exclude]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.inflight + r.queue_depth,
                                         next(self._rr)))

    @property
    def disaggregated(self) -> bool:
        """Phased dispatch is on when both phase fleets are configured
        (static — role assignment never changes after construction)."""
        roles = [r.role for r in self.replicas]
        return "prefill" in roles and "decode" in roles

    def dispatch(self, body: Dict[str, Any],
                 timeout_s: Optional[float] = None
                 ) -> Tuple[int, Dict[str, Any]]:
        """Route one generate request with failover + idempotency.
        Returns ``(http_code, payload)``."""
        timeout = (self.cfg.default_timeout_s if timeout_s is None
                   else float(timeout_s))
        rid = str(body.get("request_id") or
                  f"gang-{os.getpid()}-{next(self._rid)}")
        # ONE trace a request, minted here (or adopted from the client's
        # wire context) and put into the body BEFORE failover and the
        # phases: every retry, phase hop and colocated fallback sends the
        # same context, so a replica's scheduler adopts the trace instead
        # of minting one. A retry is a span of the SAME trace.
        ctx_in = _spans.extract(body)
        trace_id = ctx_in[0] if ctx_in is not None else _spans.gen_id()
        route_span = _spans.gen_id()
        body = dict(body)
        body[_spans.WIRE_KEY] = _spans.inject((trace_id, route_span))
        t0 = time.perf_counter_ns()
        code, payload = self._dispatch_dedup(body, timeout, rid)
        if isinstance(payload, dict):
            # expose the trace id to the client (and to tests); a dedup
            # hit keeps the ORIGINAL attempt's id — the client retry is
            # part of that trace, not a new one
            payload.setdefault("trace_id", trace_id)
            if not payload.get("deduplicated"):
                try:
                    self.slo.note_request(
                        ttft_ms=payload.get("ttft_ms"),
                        tpot_ms=payload.get("tpot_ms"),
                        code=code, shed=code in (429, 503),
                        trace_id=payload.get("trace_id"),
                        request_id=rid)
                except Exception:
                    pass
        span_trace = (payload.get("trace_id", trace_id)
                      if isinstance(payload, dict) else trace_id)
        attrs = {"request_id": rid, "code": code}
        if ctx_in is not None:
            # the parent span lives in the CLIENT's process, outside
            # this gang's trace dir — trace_assemble treats a stamped
            # remote parent as a legitimate root, not a broken edge
            attrs["remote_parent"] = True
        _spans.record("serve/route", t0, time.perf_counter_ns() - t0,
                      trace=span_trace, span_id=route_span,
                      parent=ctx_in[1] if ctx_in is not None else None,
                      attrs=attrs)
        return code, payload

    def _dispatch_dedup(self, body: Dict[str, Any], timeout: float,
                        rid: str) -> Tuple[int, Dict[str, Any]]:
        with self._dedup_lock:
            hit = self._completed.get(rid)
            if hit is not None:
                # an answered id is never re-generated: the recorded
                # response IS the answer (idempotency contract)
                self._completed.move_to_end(rid)
                return hit[0], dict(hit[1], deduplicated=True)
            ev = self._inflight.get(rid)
            if ev is None:
                ev = threading.Event()
                self._inflight[rid] = ev
                owner = True
            else:
                owner = False
        if not owner:
            # a duplicate of an in-flight request waits for the original
            # instead of racing a second generation
            ev.wait(timeout=timeout + self.cfg.probe_timeout_s)
            with self._dedup_lock:
                hit = self._completed.get(rid)
            if hit is not None:
                return hit[0], dict(hit[1], deduplicated=True)
            return 504, {"error": "duplicate waited out its original",
                         "request_id": rid}
        try:
            code, payload = self._dispatch_phased(body, timeout, rid)
        finally:
            with self._dedup_lock:
                self._inflight.pop(rid, None)
                ev.set()
        return code, payload

    def _record(self, rid: str, code: int,
                payload: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        payload = dict(payload, request_id=rid)
        with self._dedup_lock:
            self._completed[rid] = (code, payload)
            while len(self._completed) > self.cfg.dedup_capacity:
                self._completed.popitem(last=False)
        return code, payload

    def _dispatch_phased(self, body, timeout: float, rid: str):
        """Disaggregated dispatch with the degrade-never-drop rule: try
        prefill-replica -> KV handoff -> decode-replica; ANY phase
        failure falls through to classic colocated dispatch
        (:meth:`_dispatch_inner` picks from every ready replica — roles
        are routing policy, not capability — and only the FINAL response
        is recorded, so idempotency + failover semantics are intact)."""
        if self.disaggregated:
            result = self._dispatch_disagg(body, timeout, rid)
            if result is not None:
                return self._record(rid, *result)
        return self._dispatch_inner(body, timeout, rid)

    def _dispatch_disagg(self, body, timeout: float, rid: str):
        """One phased attempt. Returns ``(code, payload)`` on success,
        ``None`` to signal colocated fallback (reason already counted in
        ``paddle_serve_disagg_fallback_total``)."""
        def fall_back(reason: str, detail: str = ""):
            smetrics.m_disagg_fallback.labels(reason).inc()
            self.disagg_fallbacks += 1
            sys.stderr.write(f"[gang] request {rid}: disagg {reason}"
                             f"{' (' + detail + ')' if detail else ''} — "
                             f"degrading to colocated\n")
            return None

        deadline = time.monotonic() + timeout
        pre = self._pick(set(), role="prefill")
        dec = self._pick(set(), role="decode")
        if pre is None or dec is None:
            return fall_back("no_phase_fleet")
        tid = f"{rid}-kv"
        pbody = {k: v for k, v in body.items()
                 if k not in ("request_id",)}
        pbody["transfer_id"] = tid
        if dec.kv_port:
            # real engines: page stream over the decode replica's KV
            # socket; the prefill replica pushes, /resume pops by id
            pbody["kv_target"] = {"host": "127.0.0.1",
                                  "port": dec.kv_port,
                                  "transfer_id": tid}
        pre.inflight += 1
        try:
            code, pay = pre.post_json(
                "/prefill", pbody, max(0.5, deadline - time.monotonic()))
        except Exception as e:
            return fall_back("transfer_fault",
                             f"prefill: {type(e).__name__}")
        finally:
            pre.inflight -= 1
        if code != 200:
            return fall_back("prefill_failed", f"HTTP {code}")
        rbody = {"first_token": pay["first_token"],
                 "max_new_tokens": body.get("max_new_tokens", 16),
                 "prompt": body.get("prompt") or body.get("tokens"),
                 "timeout_s": max(0.5, deadline - time.monotonic())}
        if _spans.WIRE_KEY in body:
            # decode joins the SAME trace the router minted (the staged
            # handoff also carries the prefill replica's context — both
            # share one trace id)
            rbody[_spans.WIRE_KEY] = body[_spans.WIRE_KEY]
        for k in ("temperature", "top_k", "top_p", "seed"):
            if k in body:
                rbody[k] = body[k]
        if pay.get("kv") is not None:
            rbody["kv"] = pay["kv"]          # inline channel (stubs)
        else:
            rbody["transfer_id"] = pay.get("transfer_id", tid)
        dec.inflight += 1
        try:
            code2, pay2 = dec.post_json(
                "/resume", rbody, max(0.5, deadline - time.monotonic()))
        except Exception as e:
            # mid-transfer decode death: the handoff dies with the
            # replica; the colocated retry re-prefills from the prompt
            return fall_back("transfer_fault",
                             f"resume: {type(e).__name__}")
        finally:
            dec.inflight -= 1
        if code2 != 200:
            return fall_back("decode_failed", f"HTTP {code2}")
        self.disagg_requests += 1
        return 200, {"tokens": pay2["tokens"],
                     "num_tokens": pay2.get("num_tokens",
                                            len(pay2["tokens"])),
                     "ttft_ms": pay.get("ttft_ms"),
                     "tpot_ms": pay2.get("tpot_ms"),
                     "disagg": True}

    def _dispatch_inner(self, body, timeout: float, rid: str):
        deadline = time.monotonic() + timeout + self.cfg.probe_timeout_s
        tried = set()
        shed_response = None
        attempts = 0
        while True:
            r = self._pick(tried)
            if r is None:
                if shed_response is not None:
                    # every replica shed (429/503): surface the shed —
                    # its Retry-After is the client's cue
                    return self._record(rid, *shed_response)
                # nothing healthy right now: a recycle may be in flight —
                # wait for a respawn (a recycled replica has a new
                # incarnation and re-enters the candidate set) rather
                # than failing a whole storm during one restart window
                if time.monotonic() < deadline and not self._stop.is_set():
                    time.sleep(self.cfg.probe_interval_s)
                    continue
                return self._record(rid, 503, {
                    "error": "no healthy replica", "retry_after_s": 1})
            tried.add((r.index, r.incarnation))
            remaining = max(0.5, deadline - time.monotonic())
            r.inflight += 1
            try:
                code, payload = r.post_generate(body, remaining)
            except Exception as e:
                # transport fault: the replica died (or was killed) with
                # this request in flight — its partial tokens die with
                # it; re-dispatch to a sibling, which re-prefills
                attempts += 1
                self.failovers += 1
                smetrics.m_failover.inc()
                sys.stderr.write(
                    f"[gang] request {rid}: replica {r.index} faulted "
                    f"mid-request ({type(e).__name__}) — failing over "
                    f"(attempt {attempts})\n")
                if attempts > self.cfg.max_failover_attempts:
                    return self._record(rid, 503, {
                        "error": f"replica fault after {attempts} "
                                 f"attempts: {type(e).__name__}: {e}",
                        "retry_after_s": 1})
                continue
            finally:
                r.inflight -= 1
            if code == 500:
                # engine-loop fault aborted it server-side: safe to
                # retry on a sibling (nothing was returned)
                attempts += 1
                self.failovers += 1
                smetrics.m_failover.inc()
                if attempts > self.cfg.max_failover_attempts:
                    return self._record(rid, code, payload)
                continue
            if code in (429, 503):
                # overloaded/draining replica: try a sibling; if every
                # replica sheds, surface the shed (with its Retry-After)
                shed_response = (code, payload)
                continue
            if attempts:
                # how many replica faults this answer outlived
                payload = dict(payload, failovers=attempts)
            return self._record(rid, code, payload)

    # -- introspection -----------------------------------------------------
    def health(self) -> Dict[str, Any]:
        reps = []
        for r in self.replicas:
            reps.append({
                "index": r.index, "alive": r.alive,
                "ready": r.port is not None, "port": r.port,
                "role": r.role, "kv_port": r.kv_port,
                "incarnation": r.incarnation, "restarts": r.restarts,
                "last_cause": r.last_cause,
                "restored_prefix_records": r.restored_prefix_records,
            })
        n_ready = len(self.ready_replicas())
        return {
            "status": ("ok" if n_ready == len(self.replicas) else
                       "degraded" if n_ready else "down"),
            "replicas": reps,
            "ready": n_ready,
            "disaggregated": self.disaggregated,
            "disagg_requests": self.disagg_requests,
            "disagg_fallbacks": self.disagg_fallbacks,
            "restarts": dict(self.restart_causes),
            "failovers": self.failovers,
            "trace_dir": self.trace_dir,
        }


class _GangHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, obj: Dict[str, Any]) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if "retry_after_s" in obj:
            self.send_header("Retry-After", str(int(obj["retry_after_s"])))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass
        smetrics.request_code(code)

    def do_GET(self):
        front: "GangFrontDoor" = self.server.front
        if self.path == "/health":
            return self._json(200, front.gang.health())
        if self.path == "/metrics":
            text = _prom.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)
            return
        if self.path in ("/fleet", "/fleet/metrics"):
            # the live fleet view: the FLEET.json document (per-role
            # rollups, SLO status) or the merged per-replica exposition
            # (replica and role labels kept)
            fp = front.gang.fleet
            doc = fp.fleet_doc()
            if not doc:
                doc = fp.tick()
            if self.path == "/fleet":
                return self._json(200, doc)
            text = fp.exposition().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)
            return
        self._json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):
        front: "GangFrontDoor" = self.server.front
        if self.path != "/generate":
            return self._json(404, {"error": f"unknown path {self.path!r}"})
        n = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(n).decode() or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            return self._json(400, {"error": f"malformed JSON body: {e}"})
        timeout_s = body.get("timeout_s")
        code, payload = front.gang.dispatch(
            body, None if timeout_s is None else float(timeout_s))
        self._json(code, payload)


class GangFrontDoor:
    """The gang's public HTTP face: ``/generate`` routes through
    :meth:`ReplicaGang.dispatch` (failover, idempotency), ``/health``
    reports the gang's view, ``/metrics`` serves the SUPERVISOR process's
    registry (replica restarts, failovers; each replica's own serving
    metrics are behind its own ``/metrics``), ``/fleet`` and
    ``/fleet/metrics`` the fleet poller's view."""

    def __init__(self, gang: ReplicaGang, host: str = "127.0.0.1",
                 port: int = 0):
        self.gang = gang
        from .server import _Server

        self.httpd = _Server((host, port), _GangHandler)
        self.httpd.daemon_threads = True
        self.httpd.front = self
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "GangFrontDoor":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="gang-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
