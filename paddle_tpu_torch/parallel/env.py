"""The distributed environment contract — the port of
``paddle_tpu/parallel/env.py``.

The PADDLE_* variables the launcher exports (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``) plus ``LOCAL_RANK`` (the worker's slot on
its node) and ``PADDLE_DIST_BACKEND`` (``nccl`` or ``gloo``, when the
launcher was given one). Where JAX bootstraps through
``jax.distributed.initialize``, the port calls
``torch.distributed.init_process_group`` with ``tcp://<endpoints[0]>`` as
the rendezvous.

The default is NCCL with rank r on ``cuda:LOCAL_RANK``; a worker whose
``LOCAL_RANK`` has no card of its own raises. gloo, the CPU, or two
ranks on one card are taken only when the caller names them
(``backend="gloo"``, ``device="cpu"`` or ``device="cuda:0"``).
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["trainer_id", "trainer_num", "trainer_endpoints",
           "current_endpoint", "local_rank", "init_distributed_env",
           "BACKENDS"]

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
    re-joining."""
    backend = backend or os.getenv("PADDLE_DIST_BACKEND") or "nccl"
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
    dist.init_process_group(
        backend=backend, init_method=init_method or f"tcp://{coordinator}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev
