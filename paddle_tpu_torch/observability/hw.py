"""Hardware denominators for the port's rooflines.

The counterpart of ``paddle_tpu/observability/hw.py``, whose rows are TPU
chips. The port runs on NVIDIA H100 SXM only, so this table holds that one
card (NVIDIA H100 data sheet, SXM part, dense rates without sparsity, at
the full 700 W power limit):

- 989 TFLOP/s bf16 on the tensor cores;
- 67 TFLOP/s float32 outside the tensor cores;
- 3.35 TB/s HBM3.

``bound_ms`` is the least time the card could take for a piece of work:
the larger of its bytes over the memory rate and its operations over the
peak rate for their type. ``chip_smoke.py`` and ``PERF.md`` take every
bound from here.
"""
from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["PEAKS", "peaks_for", "bound_ms"]

# device-name substring (lower case) -> peak rates
PEAKS: Dict[str, Dict[str, float]] = {
    "h100": {
        "bf16_flops_per_s": 989e12,
        "f32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks_for(device_name: str) -> Dict[str, float]:
    """Peak-rate row for a card name as ``torch.cuda.get_device_name``
    gives it. Raises ``KeyError`` for a card the table does not hold —
    a roofline against some other card's peaks would be wrong."""
    name = device_name.lower()
    for key, row in PEAKS.items():
        if key in name:
            return row
    raise KeyError(f"no peak-rate row for device {device_name!r}")


def bound_ms(nbytes: float, flops: float, flop_dtype: str,
             device_name: str) -> Tuple[float, str]:
    """(least time in ms, ``"bytes"`` or ``"operations"``) for work that
    moves ``nbytes`` through HBM and does ``flops`` operations of type
    ``flop_dtype`` (``"bf16"`` or ``"f32"``)."""
    row = peaks_for(device_name)
    t_bytes = nbytes / row["hbm_bytes_per_s"]
    t_ops = flops / row[f"{flop_dtype}_flops_per_s"]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
