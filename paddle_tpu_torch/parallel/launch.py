"""Multi-process launcher — the core of ``paddle_tpu/parallel/launch.py``:
spawns one worker process per slot, sets the PADDLE_* env, and supervises
the gang.

    python -m paddle_tpu_torch.parallel.launch [--nproc_per_node N]
        [--backend nccl|gloo] [--started_port P] [--grace_period S]
        [--log_dir DIR] [-m] training_script [script args...]

Each worker sees ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``, ``LOCAL_RANK``
and, with ``--backend``, ``PADDLE_DIST_BACKEND`` (read by
``env.init_distributed_env``). ``-m`` runs the script as a module
(``python -m``). When a worker fails, the gang gets SIGTERM, a grace
period, then SIGKILL, and the launcher exits with the FIRST failing
worker's code (a signal death N maps to 128+N). SIGTERM or SIGINT on the
launcher stops the gang the same way.

Supervised restarts, preemption forwarding, the hang watchdog, straggler
polling and blame assembly come with ``checkpoint.py`` and ``health.py``
(ROADMAP A3 (a)); asking for them raises.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

__all__ = ["get_cluster_endpoints", "launch", "main"]


def get_cluster_endpoints(node_ips: List[str], nproc_per_node: int,
                          start_port: int = 6070) -> List[str]:
    eps = []
    for ip in node_ips:
        for i in range(nproc_per_node):
            eps.append(f"{ip}:{start_port + i}")
    return eps


def _exit_code(ret: int) -> int:
    """Popen returncode -> propagated exit code (signal death N -> 128+N,
    the shell convention)."""
    return 128 - ret if ret < 0 else ret


def _stop_gang(procs, grace_period_s: float, sig=signal.SIGTERM) -> None:
    """``sig`` to every live worker, wait up to the grace period, then
    SIGKILL the stragglers."""
    for _, p in procs:
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except OSError:
                pass
    deadline = time.monotonic() + max(0.0, grace_period_s)
    for _, p in procs:
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
           max_restarts: int = 0, hang_deadline_s: Optional[float] = None,
           health_dir: Optional[str] = None) -> int:
    """Spawn and supervise the worker gang; returns the job's exit code:
    0 when every worker exits 0, else the first failing worker's code
    (signal deaths as 128+N) after the rest of the gang is stopped.

    ``module`` runs ``training_script`` as ``python -m``; ``backend``
    exports ``PADDLE_DIST_BACKEND``; ``log_dir`` sends worker r's output
    to ``<log_dir>/worker.<r>.log`` (else it is inherited)."""
    if max_restarts or hang_deadline_s is not None or health_dir:
        raise NotImplementedError(
            "supervised restarts and the hang watchdog are still to be "
            "ported with checkpoint.py and health.py (ROADMAP A3 (a))")
    node_ips = [ip.strip() for ip in cluster_node_ips.split(",")]
    endpoints = get_cluster_endpoints(node_ips, nproc_per_node, started_port)
    node_rank = node_ips.index(node_ip)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    cmd = [sys.executable] + (["-m"] if module else []) + [training_script]
    procs, outs = [], []
    exit_code = 0
    # SIGTERM / SIGINT on the launcher end it through the finally below,
    # which stops the gang (main thread only: handlers install there)
    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _end(signum, frame):
            raise SystemExit(128 + signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _end)
    try:
        for local_rank in range(nproc_per_node):
            rank = node_rank * nproc_per_node + local_rank
            env = dict(os.environ)
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(len(endpoints)),
                "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
                "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
                "LOCAL_RANK": str(local_rank),
            })
            if backend:
                env["PADDLE_DIST_BACKEND"] = backend
            out = (open(os.path.join(log_dir, f"worker.{rank}.log"), "w")
                   if log_dir else None)
            outs.append(out)
            procs.append((rank, subprocess.Popen(
                cmd + list(script_args or []), env=env, stdout=out,
                stderr=subprocess.STDOUT if out else None)))
        live = list(procs)
        while live:
            failed = None
            for rank, p in live:
                ret = p.poll()
                if ret not in (None, 0) and failed is None:
                    failed = (rank, ret)
            if failed is not None:
                rank, ret = failed
                exit_code = _exit_code(ret)
                sys.stderr.write(f"launch: worker {rank} exited with {ret} "
                                 f"(code {exit_code}); stopping the gang\n")
                _stop_gang(procs, grace_period_s)
                break
            live = [(r, p) for r, p in live if p.poll() is None]
            time.sleep(0.1)
    finally:
        # a launcher that is stopped or fails leaves no worker behind
        _stop_gang(procs, grace_period_s)
        for out in outs:
            if out:
                out.close()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
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
    ap.add_argument("-m", "--module", action="store_true",
                    help="run training_script as a module (python -m)")
    ap.add_argument("training_script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    return launch(args.training_script, args.script_args,
                  args.cluster_node_ips, args.node_ip, args.nproc_per_node,
                  args.started_port, args.log_dir, args.grace_period,
                  args.backend, args.module)


if __name__ == "__main__":
    sys.exit(main())
