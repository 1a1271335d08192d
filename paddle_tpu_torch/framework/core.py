"""Core types of the fluid surface: dtypes, places and the flags table.

The port of ``paddle_tpu/framework/core.py``. Var dtypes are the same
canonical strings as the reference's (``convert_dtype``); they map to
torch dtypes, and a Place names a torch device: ``CPUPlace`` the CPU,
``CUDAPlace(i)`` card ``i`` (Paddle's own name for it, where the
reference says ``XLAPlace``). The flags table holds the entries this
slice reads.
"""
from __future__ import annotations

import os as _os

import dataclasses
import enum

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["VarType", "convert_dtype", "dtype_to_torch", "dtype_name",
           "dtype_is_floating", "Place", "CPUPlace", "CUDAPlace",
           "set_flags", "get_flags", "get_flag", "flags_snapshot",
           "NotPortedError", "not_ported"]


class NotPortedError(NotImplementedError, AttributeError):
    """A name of the reference's surface that the port does not have yet.
    An ``AttributeError`` too, so ``hasattr`` answers False."""


def not_ported(module: str, name: str, item: str = "A5"):
    """Raise :class:`NotPortedError` for ``module.name`` (a module's
    ``__getattr__`` calls this for every public name it lacks)."""
    raise NotPortedError(
        f"{module}.{name} is not ported to paddle_tpu_torch yet "
        f"(ROADMAP {item})")


class VarType(enum.IntEnum):
    """Variable kinds — the reference's framework.proto VarType.Type."""

    BOOL = 0
    INT16 = 1
    INT32 = 2
    INT64 = 3
    FP16 = 4
    FP32 = 5
    FP64 = 6
    UINT8 = 20
    INT8 = 21
    BF16 = 22
    LOD_TENSOR = 7
    SELECTED_ROWS = 8
    FEED_MINIBATCH = 9
    FETCH_LIST = 10
    STEP_SCOPES = 11
    LOD_RANK_TABLE = 12
    LOD_TENSOR_ARRAY = 13
    PLACE_LIST = 14
    READER = 15
    RAW = 17
    TUPLE = 18


_TORCH_DTYPES = {
    "bool": torch.bool,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "bfloat16": torch.bfloat16,
}
_DTYPE_TO_VARTYPE = {
    "bool": VarType.BOOL, "int16": VarType.INT16, "int32": VarType.INT32,
    "int64": VarType.INT64, "float16": VarType.FP16,
    "float32": VarType.FP32, "float64": VarType.FP64,
    "uint8": VarType.UINT8, "int8": VarType.INT8,
    "bfloat16": VarType.BF16,
}
_VARTYPE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_VARTYPE.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``."""
    return str(dtype).replace("torch.", "")


def convert_dtype(dtype) -> str:
    """Any dtype spec (str, numpy, torch, VarType) -> the canonical
    string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, VarType):
        return _VARTYPE_TO_DTYPE[dtype]
    if isinstance(dtype, int):
        return _VARTYPE_TO_DTYPE[VarType(dtype)]
    if isinstance(dtype, torch.dtype):
        return dtype_name(dtype)
    if isinstance(dtype, str):
        if dtype in _TORCH_DTYPES:
            return dtype
        return np.dtype(dtype).name
    return np.dtype(dtype).name


def dtype_to_torch(dtype) -> torch.dtype:
    """The torch dtype a var of ``dtype`` computes in. int64 stays int64:
    torch has no x64 switch to narrow it, as the reference's JAX does."""
    return _TORCH_DTYPES[convert_dtype(dtype)]


def dtype_is_floating(dtype) -> bool:
    return convert_dtype(dtype) in ("float16", "float32", "float64",
                                    "bfloat16")


# ---------------------------------------------------------------------------
# Places — the reference's platform/place.h, naming torch devices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Place:
    device_type: str = "cuda"
    device_id: int = 0

    def torch_device(self) -> torch.device:
        """The place's device; a CUDA place raises without a card
        (``device.resolve_device``)."""
        if self.device_type == "cpu":
            return resolve_device("cpu")
        return resolve_device(f"cuda:{self.device_id}")

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__(device_type="cpu", device_id=device_id)


class CUDAPlace(Place):
    """Card ``device_id`` (the reference's accelerator place)."""

    def __init__(self, device_id: int = 0):
        super().__init__(device_type="cuda", device_id=device_id)


# ---------------------------------------------------------------------------
# Flags — the reference's _GLOBAL_FLAGS, the entries this slice reads
# ---------------------------------------------------------------------------

_GLOBAL_FLAGS = {
    # flat-buffer fused optimizer sweep (optimizer.py apply_gradients): one
    # fused update op per (dtype, lr-multiplier) parameter group; the same
    # as passing fuse=True to the optimizer
    "FLAGS_fuse_optimizer": False,
    # each fused group through its optimizer kernel
    # (ops/cuda_kernels.megakernel_*, which run the plain version on CPU
    # tensors): None or True; False takes the op's unfused expression
    "FLAGS_fuse_optimizer_pallas": None,
    # program reports (observability/program_report.py) also go to
    # <dir>/program_reports.<pid>.jsonl when set
    "FLAGS_program_report_dir": _os.environ.get(
        "FLAGS_program_report_dir", ""),
    # program reports count the aten ops' FLOPs of the call they report
    # (FlopCounterMode: every op dispatched through Python once)
    "FLAGS_program_report_flops": _os.environ.get(
        "FLAGS_program_report_flops", "") not in ("", "0"),
}


def set_flags(flags: dict):
    for k, v in flags.items():
        _GLOBAL_FLAGS[k] = v


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {k: _GLOBAL_FLAGS.get(k) for k in flags}


def get_flag(name, default=None):
    return _GLOBAL_FLAGS.get(name, default)


def flags_snapshot() -> dict:
    """Copy of the full flag state (anomaly and hang forensics record
    it)."""
    return dict(_GLOBAL_FLAGS)
