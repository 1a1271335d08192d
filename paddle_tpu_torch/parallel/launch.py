"""Multi-process launcher and gang supervisor — the port of
``paddle_tpu/parallel/launch.py``.

    python -m paddle_tpu_torch.parallel.launch [--nproc_per_node N]
        [--backend nccl|gloo] [--started_port P] [--grace_period S]
        [--log_dir DIR] [--max_restarts K] [--restart_backoff S]
        [--hang_deadline S] [--health_dir DIR] [--straggler_ratio R]
        [--goodput_dir DIR] [--flight_dir DIR]
        [-m] training_script [script args...]

Each worker sees ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``, ``LOCAL_RANK``,
``PADDLE_RESTART_ATTEMPT`` and, with ``--backend``, ``PADDLE_DIST_BACKEND``
(read by ``env.init_distributed_env``). ``-m`` runs the script as a module.

- **Shutdown**: a failing gang gets SIGTERM, the grace period to
  checkpoint and exit (workers trap it with
  :func:`install_preemption_handler`), then SIGKILL. The job's code is the
  FIRST failing worker's (a signal death N is 128 + N).
- **Preemption**: SIGTERM or SIGINT on the launcher is trapped and
  forwarded to the workers, which checkpoint and exit; the launcher then
  returns 0 (a clean preemption), or the first bad code of a worker that
  died badly.
- **Supervised restarts**: ``max_restarts > 0`` restarts the whole gang
  after a worker fails (a collective job cannot go on without a member),
  with exponential backoff; every incarnation rendezvouses again on the
  same endpoints (``init_collective_with_retry``) and resumes from the
  latest committed checkpoint. ``paddle_restarts_total{cause}`` counts
  them: ``hang`` for a worker that exited with
  ``health.HANG_EXIT_CODE``, ``preempt`` for an untrapped SIGTERM death,
  ``crash`` for the rest. :func:`restart_history` keeps each restart's
  times (failure seen, gang respawned) for recovery measurements.
- **In-run health**: ``hang_deadline_s`` / ``health_dir`` export the
  :mod:`.health` env contract (each worker installs its watchdog), and the
  supervisor polls the heartbeat dir for stragglers and the workers'
  input-stall reports.

- **Goodput**: ``goodput_dir`` (default ``<log_dir>/goodput``) is
  exported as ``PADDLE_GOODPUT_DIR``; workers write their per-rank window
  reports there (``goodput.maybe_export``), the supervisor charges each
  restart's failure -> respawn window to ``restart_downtime`` (the same
  stamps as :func:`restart_history`) and at the end merges everything
  into ``GOODPUT.json`` and ``gang_metrics.prom``.
- **Flight recorder and blame**: ``flight_dir`` (default
  ``<log_dir>/flight``, else ``<health_dir>/flight``) is exported as
  ``PADDLE_FLIGHT_DIR`` (workers attach their sidecars with
  ``flight.maybe_attach_from_env``); on a ``hang`` restart the supervisor
  runs the blame engine (``paddle_tpu_torch.tools.flight_assemble``) over
  the dead incarnation's files, writes ``blame.attempt<K>.json`` beside
  them and sets ``paddle_blamed_rank`` / ``paddle_step_skew_ms``.
"""
from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

from ..observability import flight as _flight
from ..observability import goodput as _goodput
from ..observability import metrics as _obs_metrics
from . import health as _health

__all__ = ["get_cluster_endpoints", "launch", "main", "PreemptionSignal",
           "install_preemption_handler", "preemption_signal",
           "init_collective_with_retry", "restart_history"]

_m_restarts = _obs_metrics.default_registry().counter(
    "paddle_restarts_total",
    "Supervised gang restarts by cause (hang, crash, preempt)",
    ("cause",))
_m_input_stalls = _obs_metrics.default_registry().counter(
    "paddle_input_stall_reports_total",
    "Input-stall reports surfaced by the supervisor, by rank", ("rank",))

_RESTARTS: List[dict] = []


def restart_history() -> List[dict]:
    """Every supervised restart of this process's launches, in order:
    ``{attempt, rank, returncode, cause, t_fail, t_respawn}`` with the
    times on the wall clock (``time.time()``), so a worker's own stamps
    can be set against them."""
    return list(_RESTARTS)


def _poll_input_stall_reports(health_dir: str, seen: dict) -> list:
    """Surface the workers' ``input_stall.rank<R>.json`` reports in the
    shared health dir (``seen``: path -> the mtime last surfaced); the
    new reports."""
    out = []
    for path in sorted(glob.glob(
            os.path.join(health_dir, "input_stall.rank*.json"))):
        try:
            mtime = os.path.getmtime(path)
            if seen.get(path) == mtime:
                continue
            with open(path) as f:
                rep = json.load(f)
        except (OSError, ValueError):
            continue
        seen[path] = mtime
        _m_input_stalls.labels(str(rep.get("rank", "?"))).inc()
        sys.stderr.write(
            f"launch: rank {rep.get('rank')} input stalled "
            f"{rep.get('waited_s')}s on shard {rep.get('shard')!r} "
            "(slow storage or a stuck decode worker)\n")
        out.append(rep)
    return out


def get_cluster_endpoints(node_ips: List[str], nproc_per_node: int,
                          start_port: int = 6070) -> List[str]:
    eps = []
    for ip in node_ips:
        for i in range(nproc_per_node):
            eps.append(f"{ip}:{start_port + i}")
    return eps


# ---------------------------------------------------------------------------
# Worker-side helpers
# ---------------------------------------------------------------------------

class PreemptionSignal:
    """The process-wide preemption flag SIGTERM / SIGINT set. Training
    loops poll :attr:`triggered` at step boundaries, save a checkpoint and
    exit 0 — the launcher's grace period exists for this."""

    def __init__(self):
        self.triggered = False
        self.signum: Optional[int] = None
        self._callbacks: List[Callable[[], None]] = []

    def check(self) -> bool:
        return self.triggered

    def reset(self) -> None:
        self.triggered = False
        self.signum = None

    def add_callback(self, fn: Callable[[], None]) -> None:
        self._callbacks.append(fn)

    def _fire(self, signum):
        self.triggered = True
        self.signum = signum
        for fn in list(self._callbacks):
            try:
                fn()
            except Exception:
                pass


_preemption: Optional[PreemptionSignal] = None


def install_preemption_handler(
        signals=(signal.SIGTERM, signal.SIGINT)) -> PreemptionSignal:
    """Install (or return the installed) preemption trap. Outside the main
    thread, where no handler can be installed, the flag never fires."""
    global _preemption
    if _preemption is not None:
        return _preemption
    sig = PreemptionSignal()

    def handler(signum, frame):
        sig._fire(signum)

    if threading.current_thread() is threading.main_thread():
        for s in signals:
            signal.signal(s, handler)
    _preemption = sig
    return sig


def preemption_signal() -> Optional[PreemptionSignal]:
    return _preemption


def init_collective_with_retry(init_fn: Callable[[], None],
                               retries: int = 5, backoff_s: float = 0.5,
                               backoff_max_s: float = 8.0,
                               log=None) -> None:
    """Retry with exponential backoff around the process-group bring-up:
    a peer that starts late (or a restarted gang whose rendezvous port is
    not free yet) fails a rank's first attempt. Re-raises the last error
    after ``retries`` attempts."""
    delay = backoff_s
    for attempt in range(1, max(1, retries) + 1):
        try:
            init_fn()
            return
        except Exception as e:
            if attempt >= retries:
                raise
            if log is not None:
                log(f"collective init attempt {attempt}/{retries} failed "
                    f"({e!r}); retrying in {delay:.1f}s")
            time.sleep(delay)
            delay = min(delay * 2, backoff_max_s)


# ---------------------------------------------------------------------------
# Launcher / supervisor
# ---------------------------------------------------------------------------

def _exit_code(ret: int) -> int:
    """Popen returncode -> the propagated exit code (signal death N ->
    128 + N)."""
    return 128 - ret if ret < 0 else ret


def _restart_cause(ret: int) -> str:
    """Popen returncode -> the ``paddle_restarts_total`` cause: ``hang``
    (the watchdog's code), ``preempt`` (an untrapped SIGTERM death; a
    trapped preemption exits 0 and never restarts) or ``crash``."""
    if ret == _health.HANG_EXIT_CODE:
        return "hang"
    if ret < 0:
        return "preempt" if -ret == signal.SIGTERM else "crash"
    return "crash"


def _assemble_blame(flight_dir: str, attempt: int) -> Optional[dict]:
    """Run the blame engine over the dead incarnation's flight files:
    write ``blame.attempt<K>.json`` next to them, publish
    ``paddle_blamed_rank`` / ``paddle_step_skew_ms`` and return the
    verdict. Forensics never fail the restart: any error returns None."""
    try:
        from ..tools import flight_assemble as fa

        report = fa.assemble_dir(flight_dir, attempt=attempt)
        verdict = report.get("verdict") or {}
        out = os.path.join(flight_dir, f"blame.attempt{attempt}.json")
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
        blamed = verdict.get("blamed_ranks") or []
        _flight.note_blame(blamed[0] if blamed else None,
                           verdict.get("step_skew_ms"))
        if blamed:
            sys.stderr.write(
                f"launch: blame verdict (attempt {attempt}): rank(s) "
                f"{blamed} {verdict.get('blame_mode')} at collective seq "
                f"{verdict.get('missed_seq')}"
                + (f" [{verdict['missed_name']}]"
                   if verdict.get("missed_name") else "") + "\n")
        return verdict
    except Exception as e:
        sys.stderr.write(f"launch: blame assembly failed: {e}\n")
        return None


def _stop_gang(procs, grace_period_s: float, sig=signal.SIGTERM) -> None:
    """``sig`` to every live worker, wait up to the grace period for them
    to checkpoint and exit, then SIGKILL the rest."""
    for _, p, _ in procs:
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except OSError:
                pass
    deadline = time.monotonic() + max(0.0, grace_period_s)
    for _, p, _ in procs:
        if p.poll() is not None:
            continue
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(training_script: str, script_args: Optional[List[str]] = None,
           cluster_node_ips: str = "127.0.0.1", node_ip: str = "127.0.0.1",
           nproc_per_node: int = 1, started_port: int = 6070,
           log_dir: Optional[str] = None, grace_period_s: float = 15.0,
           backend: Optional[str] = None, module: bool = False,
           max_restarts: int = 0, restart_backoff_s: float = 1.0,
           restart_backoff_max_s: float = 30.0,
           hang_deadline_s: Optional[float] = None,
           health_dir: Optional[str] = None,
           straggler_ratio: float = 2.0,
           straggler_warn_cooldown_s: float = 30.0,
           goodput_dir: Optional[str] = None,
           flight_dir: Optional[str] = None) -> int:
    """Spawn and supervise the worker gang; the job's exit code: 0 when
    every worker exits 0 or after a clean preemption, else the FIRST
    failing worker's code (signal deaths as 128 + N) once the restarts are
    spent.

    ``module`` runs ``training_script`` as ``python -m``; ``backend``
    exports ``PADDLE_DIST_BACKEND``; ``log_dir`` appends worker r's output
    to ``<log_dir>/worker.<r>.log``. ``hang_deadline_s`` / ``health_dir``
    (default ``<log_dir>/health`` when a deadline is set) arm the health
    layer: each worker's watchdog, heartbeats in ``health_dir`` and the
    supervisor's straggler poll (EWMA beyond ``straggler_ratio`` x the
    gang median). ``goodput_dir`` (default ``<log_dir>/goodput``) arms the
    gang goodput report, ``flight_dir`` (default ``<log_dir>/flight``,
    else ``<health_dir>/flight``) the flight recorder and the blame pass
    on a hang restart (module docstring)."""
    node_ips = [ip.strip() for ip in cluster_node_ips.split(",")]
    endpoints = get_cluster_endpoints(node_ips, nproc_per_node, started_port)
    node_rank = node_ips.index(node_ip)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    if health_dir is None and hang_deadline_s is not None and log_dir:
        health_dir = os.path.join(log_dir, "health")
    if health_dir:
        os.makedirs(health_dir, exist_ok=True)
    if goodput_dir is None and log_dir:
        goodput_dir = os.path.join(log_dir, "goodput")
    if goodput_dir:
        os.makedirs(goodput_dir, exist_ok=True)
    if flight_dir is None:
        if log_dir:
            flight_dir = os.path.join(log_dir, "flight")
        elif health_dir:
            flight_dir = os.path.join(health_dir, "flight")
    if flight_dir:
        os.makedirs(flight_dir, exist_ok=True)
    straggler_mon = (_health.StragglerMonitor(
        health_dir, ratio=straggler_ratio,
        warn_cooldown_s=straggler_warn_cooldown_s)
        if health_dir else None)
    cmd = [sys.executable] + (["-m"] if module else []) + [training_script]

    def spawn_gang(attempt: int):
        procs = []
        for local_rank in range(nproc_per_node):
            rank = node_rank * nproc_per_node + local_rank
            env = dict(os.environ)
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(len(endpoints)),
                "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
                "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
                "LOCAL_RANK": str(local_rank),
                "PADDLE_RESTART_ATTEMPT": str(attempt),
            })
            if backend:
                env["PADDLE_DIST_BACKEND"] = backend
            # the health env contract: workers install their watchdog
            # (health.maybe_install_from_env)
            if hang_deadline_s is not None:
                env[_health.ENV_DEADLINE] = str(float(hang_deadline_s))
            if health_dir:
                env[_health.ENV_DIR] = health_dir
            # the goodput and flight env contracts: workers export their
            # window reports (goodput.maybe_export) and sidecar their
            # event rings (flight.maybe_attach_from_env) here
            if goodput_dir:
                env[_goodput.ENV_DIR] = goodput_dir
            if flight_dir:
                env[_flight.ENV_DIR] = flight_dir
            # append: a restarted worker's log continues the file
            out = (open(os.path.join(log_dir, f"worker.{rank}.log"), "a")
                   if log_dir else None)
            p = subprocess.Popen(
                cmd + list(script_args or []), env=env, stdout=out,
                stderr=subprocess.STDOUT if out else None)
            procs.append((rank, p, out))
        return procs

    # the preemption trap: forward to the workers, give them the grace
    # period to checkpoint, return cleanly (main thread only)
    preempted = {"flag": False}
    old_handlers = {}
    in_main = threading.current_thread() is threading.main_thread()
    if in_main:
        def _trap(signum, frame):
            preempted["flag"] = True

        for s in (signal.SIGTERM, signal.SIGINT):
            old_handlers[s] = signal.signal(s, _trap)

    all_procs: List = []
    exit_code = 0
    restarts = 0
    restart_downtime_s = 0.0
    backoff = restart_backoff_s
    last_straggler_poll = 0.0
    stall_seen: dict = {}
    try:
        procs = spawn_gang(0)
        all_procs = list(procs)
        while True:
            if preempted["flag"]:
                sys.stderr.write("launch: preemption signal — forwarding "
                                 "SIGTERM to workers\n")
                _stop_gang(procs, grace_period_s)
                # a clean preemption (every worker checkpointed and exited
                # 0) is a clean job exit; a worker that died badly passes
                # its code on
                codes = [_exit_code(p.poll()) for _, p, _ in procs
                         if p.poll() not in (0, None)]
                exit_code = codes[0] if codes else 0
                break
            alive, failed = [], None
            for rank, p, out in procs:
                ret = p.poll()
                if ret is None:
                    alive.append((rank, p, out))
                elif ret != 0 and failed is None:
                    failed = (rank, ret)
            if failed is not None:
                rank, ret = failed
                t_fail = time.time()
                code = _exit_code(ret)
                cause = _restart_cause(ret)
                sys.stderr.write(
                    f"launch: worker {rank} exited with {ret} "
                    f"(code {code}, cause {cause})\n")
                _stop_gang(procs, grace_period_s)
                if cause == "hang" and flight_dir:
                    # the gang is stopped, every surviving sidecar flushed:
                    # name the rank that wedged it and the seq it missed
                    _assemble_blame(flight_dir, attempt=restarts)
                if restarts < max_restarts:
                    restarts += 1
                    _m_restarts.labels(cause).inc()
                    sys.stderr.write(
                        f"launch: restarting gang (attempt {restarts}/"
                        f"{max_restarts}) in {backoff:.1f}s\n")
                    time.sleep(backoff)
                    backoff = min(backoff * 2, restart_backoff_max_s)
                    for _, _, out in procs:
                        if out:
                            out.close()
                    procs = spawn_gang(restarts)
                    all_procs.extend(procs)
                    t_respawn = time.time()
                    _RESTARTS.append({
                        "attempt": restarts, "rank": rank,
                        "returncode": ret, "cause": cause,
                        "t_fail": t_fail, "t_respawn": t_respawn})
                    # failure seen -> gang respawned: the whole gang was
                    # idle (a SIGKILLed worker cannot report its own death)
                    restart_downtime_s += t_respawn - t_fail
                    _goodput.attribute("restart_downtime",
                                       t_respawn - t_fail)
                    continue
                exit_code = code
                break
            procs = alive
            if not procs:
                break       # every worker exited 0
            if health_dir is not None and \
                    time.monotonic() - last_straggler_poll >= 2.0:
                last_straggler_poll = time.monotonic()
                if straggler_mon is not None:
                    straggler_mon.poll()
                _poll_input_stall_reports(health_dir, stall_seen)
            time.sleep(0.1)
    finally:
        if in_main:
            for s, h in old_handlers.items():
                signal.signal(s, h)
        # a launcher that ends for any reason leaves no worker behind and
        # every log flushed
        _stop_gang(all_procs, grace_period_s)
        for _, _, out in all_procs:
            if out and not out.closed:
                out.close()
    if goodput_dir:
        # the gang report: the workers' window reports and expositions
        # merged, the restart downtime charged to every rank
        try:
            path = _goodput.write_gang_report(
                goodput_dir, restart_downtime_s=restart_downtime_s,
                nranks=len(endpoints),
                extra={"exit_code": exit_code, "restarts": restarts})
            if path:
                sys.stderr.write(f"launch: gang goodput report: {path}\n")
        except Exception as e:   # accounting never fails the job
            sys.stderr.write(f"launch: goodput aggregation failed: {e}\n")
    return exit_code


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.parallel.launch",
        description=__doc__.splitlines()[0])
    ap.add_argument("--cluster_node_ips", default="127.0.0.1")
    ap.add_argument("--node_ip", default="127.0.0.1")
    ap.add_argument("--nproc_per_node", type=int, default=1)
    ap.add_argument("--started_port", type=int, default=6070)
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--grace_period", type=float, default=15.0,
                    help="seconds between SIGTERM and SIGKILL at shutdown")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="exported as PADDLE_DIST_BACKEND (default: the "
                         "workers' own, nccl)")
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="restart the gang up to N times after a worker "
                         "failure (exponential backoff)")
    ap.add_argument("--restart_backoff", type=float, default=1.0)
    ap.add_argument("--hang_deadline", type=float, default=None,
                    help="arm each worker's hang watchdog: no progress for "
                         "this many seconds dumps stacks and restarts the "
                         "gang with cause=hang")
    ap.add_argument("--health_dir", default=None,
                    help="shared dir for hang dumps and heartbeats "
                         "(default: <log_dir>/health with a deadline)")
    ap.add_argument("--straggler_ratio", type=float, default=2.0,
                    help="flag ranks whose step-time EWMA exceeds this "
                         "multiple of the gang median")
    ap.add_argument("--goodput_dir", default=None,
                    help="shared dir for per-rank goodput ledgers; the "
                         "supervisor merges them into GOODPUT.json "
                         "(default: <log_dir>/goodput)")
    ap.add_argument("--flight_dir", default=None,
                    help="shared dir for per-rank flight-recorder "
                         "sidecars, blame-assembled on a hang restart "
                         "(default: <log_dir>/flight)")
    ap.add_argument("-m", "--module", action="store_true",
                    help="run training_script as a module (python -m)")
    ap.add_argument("training_script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    return launch(args.training_script, args.script_args,
                  args.cluster_node_ips, args.node_ip, args.nproc_per_node,
                  args.started_port, args.log_dir, args.grace_period,
                  args.backend, args.module,
                  max_restarts=args.max_restarts,
                  restart_backoff_s=args.restart_backoff,
                  hang_deadline_s=args.hang_deadline,
                  health_dir=args.health_dir,
                  straggler_ratio=args.straggler_ratio,
                  goodput_dir=args.goodput_dir,
                  flight_dir=args.flight_dir)


if __name__ == "__main__":
    sys.exit(main())
