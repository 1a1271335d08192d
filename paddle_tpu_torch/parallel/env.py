"""The distributed environment contract — the port of
``paddle_tpu/parallel/env.py``.

The PADDLE_* variables the launcher exports (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``) plus ``LOCAL_RANK`` (the worker's slot on
its node) and ``PADDLE_DIST_BACKEND`` (``nccl`` or ``gloo``, when the
launcher was given one). Where JAX bootstraps through
``jax.distributed.initialize``, the port calls
``torch.distributed.init_process_group`` with ``tcp://<endpoints[0]>`` as
the rendezvous, through ``launch.init_collective_with_retry`` (a
restarted gang rendezvouses again on the same endpoints, and a port not
yet free fails a first attempt).

The default is NCCL with rank r on ``cuda:LOCAL_RANK``; a worker whose
``LOCAL_RANK`` has no card of its own raises. gloo, the CPU, or two
ranks on one card are taken only when the caller names them
(``backend="gloo"``, ``device="cpu"`` or ``device="cuda:0"``).

A process that needs a group of its own beside (or without) the default
one — a tensor-parallel serving engine, several of which one process may
hold — opens a store (:func:`open_store`) and joins a
:class:`PrivateGroup` (:func:`init_private_group`); ``mesh.build_mesh(...,
group=)`` lays a one-axis mesh over it.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
from typing import List, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import health, launch

__all__ = ["trainer_id", "trainer_num", "trainer_endpoints",
           "current_endpoint", "local_rank", "init_distributed_env",
           "PrivateGroup", "open_store", "init_private_group", "BACKENDS"]

BACKENDS = ("nccl", "gloo")


def trainer_id() -> int:
    return int(os.getenv("PADDLE_TRAINER_ID", "0"))


def trainer_num() -> int:
    v = os.getenv("PADDLE_TRAINERS_NUM")
    if v is not None:
        return int(v)
    if dist.is_initialized():
        return dist.get_world_size()
    return 1


def trainer_endpoints() -> List[str]:
    eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
    return [e for e in eps.split(",") if e]


def current_endpoint() -> str:
    return os.getenv("PADDLE_CURRENT_ENDPOINT", "")


def local_rank() -> int:
    return int(os.getenv("LOCAL_RANK", "0"))


def _free_endpoint() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def init_distributed_env(coordinator: Optional[str] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = 300.0,
                         device=None,
                         init_method: Optional[str] = None) -> torch.device:
    """Join the process group from the PADDLE_* contract and return this
    rank's device.

    ``backend`` defaults to ``PADDLE_DIST_BACKEND``, else ``nccl``.
    ``device`` defaults to ``cuda:LOCAL_RANK`` (raises when that card does
    not exist); pass ``"cpu"`` (with gloo) or a named card to place it
    yourself. ``coordinator`` (``host:port``) defaults to the first
    endpoint; a world of one without endpoints rendezvouses on a free
    local port; ``init_method`` (e.g. a shared ``file://`` path) replaces
    the TCP rendezvous. ``timeout_s`` bounds the rendezvous and every
    collective, so a missing peer raises instead of hanging. Calling it
    again in an initialised process returns the device without
    re-joining. A hang-watchdog deadline (``PADDLE_HEALTH_DEADLINE_S``)
    must be shorter than ``timeout_s``: a rank blocked in a collective
    stamps no progress, and only a watchdog that fires first turns the
    wait into a ``hang`` restart rather than a collective timeout."""
    backend = backend or os.getenv("PADDLE_DIST_BACKEND") or "nccl"
    deadline = os.getenv(health.ENV_DEADLINE)
    if deadline and float(deadline) >= timeout_s:
        raise ValueError(
            f"hang deadline {deadline} s must be shorter than the process "
            f"group's timeout {timeout_s} s, or a stuck collective ends as "
            "a crash before the watchdog fires")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if device is None:
        lr = local_rank()
        if not torch.cuda.is_available() or lr >= torch.cuda.device_count():
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(
                f"LOCAL_RANK {lr} has no card of its own ({n} visible); "
                "pass device='cuda:N' to share a card or device='cpu' "
                "(with backend='gloo')")
        device = f"cuda:{lr}"
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    world, rank = trainer_num(), trainer_id()
    eps = trainer_endpoints()
    coordinator = coordinator or (eps[0] if eps else None)
    if init_method is None and coordinator is None:
        if world > 1:
            raise RuntimeError(
                "multi-trainer env without PADDLE_TRAINER_ENDPOINTS: cannot "
                "determine the rendezvous address")
        coordinator = _free_endpoint()
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    launch.init_collective_with_retry(
        lambda: dist.init_process_group(
            backend=backend, init_method=init_method or f"tcp://{coordinator}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s), **kw),
        log=lambda m: sys.stderr.write(f"rank {rank}: {m}\n"))
    return dev


@dataclasses.dataclass
class PrivateGroup:
    """A process group of its own, outside the process's default group: a
    process may hold several (one a tensor-parallel serving engine), where
    ``init_process_group`` allows one. ``pg`` is the backend's group (the
    ``group=`` of ``torch.distributed`` calls), ``store`` its rendezvous,
    kept alive with it."""
    pg: object
    rank: int
    size: int
    backend: str
    store: object


def open_store(world: int, timeout_s: float = 300.0):
    """The rendezvous of a private group, served by this process on a free
    local port (``store.port``): the group's rank 0 opens it before its
    peers start, and passes them ``127.0.0.1:<port>``."""
    return dist.TCPStore("127.0.0.1", 0, int(world), is_master=True,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def init_private_group(store, rank: int, world: int, backend: str,
                       timeout_s: float = 300.0, device=None):
    """Join a :class:`PrivateGroup` of ``world`` ranks as ``rank`` and
    return ``(device, group)``. ``store`` is the rank-0 store
    (:func:`open_store`) or its ``host:port``. ``timeout_s`` bounds the
    rendezvous and every collective, so a missing peer raises instead of
    hanging. ``device`` is this rank's: the current CUDA device unless
    the caller names another, raising when there is no card; the CPU only
    as ``device="cpu"``. gloo takes any device; nccl a CUDA device (one a
    rank)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    dev = resolve_device("cuda" if device is None else device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if isinstance(store, str):
        host, port = store.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), int(world), is_master=False,
                              timeout=timeout)
    if backend == "gloo":
        pg = dist.ProcessGroupGloo(store, int(rank), int(world), timeout)
    else:
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(store, int(rank), int(world), opts)
    return dev, PrivateGroup(pg, int(rank), int(world), backend, store)
