"""Hardware denominators for the port's rooflines.

The counterpart of ``paddle_tpu/observability/hw.py``, whose rows are TPU
chips. The port runs on NVIDIA H100 SXM only, so this table holds that one
card (NVIDIA H100 data sheet, SXM part, dense rates without sparsity, at
the full 700 W power limit):

- 989 TFLOP/s bf16 on the tensor cores;
- 67 TFLOP/s float32 outside the tensor cores;
- 3.35 TB/s HBM3;
- 80 GB of HBM3 (``hbm_capacity_bytes``, the autotuner's memory budget).

``bound_ms`` is the least time the card could take for a piece of work:
the larger of its bytes over the memory rate and its operations over the
peak rate for their type. ``chip_smoke.py`` and ``PERF.md`` take every
bound from here. ``program_train_flops`` is the reference's analytic
count of a fluid program's training FLOPs (``paddle_tpu/observability/
hw.py:91``), the numerator of the fluid lanes' MFU;
``transformer_train_flops_per_token`` the numerator of every transformer
lane's (GPT, ERNIE, the fluid encoder).
"""
from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["PEAKS", "peaks_for", "bound_ms", "program_train_flops",
           "transformer_train_flops_per_token"]

# device-name substring (lower case) -> peak rates
PEAKS: Dict[str, Dict[str, float]] = {
    "h100": {
        "bf16_flops_per_s": 989e12,
        "f32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "hbm_capacity_bytes": 80e9,
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


def transformer_train_flops_per_token(n_dense: int, num_layers: int,
                                      d_model: int, seq: int) -> int:
    """Forward + backward FLOPs a trained token of a transformer stack:
    6 N over the N weights its matrix products read (2 a multiply-add, x3
    with the backward) plus the attention term 12·L·D·T (QK^T and AV, 4·T·D
    a layer forward, x3) — the JAX package's convention
    (``models/gpt.py`` ``train_flops_per_token``)."""
    return 6 * n_dense + 12 * num_layers * d_model * seq


def program_train_flops(program, batch: int = 1) -> int:
    """Analytic fwd+bwd FLOPs of one step of a built fluid program: 2·MACs
    over its conv2d and mul/matmul ops, times 3 for forward + backward.
    -1 dims (data layers' batch) count as ``batch``."""
    import numpy as np

    def prod(shape):
        return int(np.prod([batch if d in (-1, None) else d for d in shape]))

    block = program.global_block()
    macs = 0
    for op in block.ops:
        if op.type == "conv2d":
            out = block.var(op.output("Output")[0]).shape
            w = block.var(op.input("Filter")[0]).shape
            groups = int(op.attr("groups", 1) or 1)
            # out [N, Cout, H, W]; w [Cout, Cin/groups, kh, kw]; the
            # reference divides by groups once more (ResNet: groups 1)
            macs += prod(out) * prod(w[1:]) // max(groups, 1)
        elif op.type in ("mul", "matmul"):
            x = block.var(op.input("X")[0]).shape
            y = block.var(op.input("Y")[0]).shape
            macs += prod(x) * int(y[-1])
    return 6 * macs  # 2 FLOPs a MAC x 3 (forward + backward)
