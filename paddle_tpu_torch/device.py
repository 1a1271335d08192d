"""Device resolution for the port's entry points.

Every entry point (``init_params``, ``params_from_numpy``, ``DecodeEngine``,
``Scheduler``) takes ``device=`` and defaults to ``"cuda"``. Without a card
the default raises instead of dropping to the CPU: a CPU run is something a
caller asks for (the tests do), never something that happens quietly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``. Raises ``RuntimeError`` for a CUDA device when no
    card is visible, and ``ValueError`` for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device {str(dev)!r}: expected 'cuda' or 'cpu'")
