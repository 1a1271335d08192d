"""Comparison helpers shared by the parity tests and ``chip_smoke.py``:
measures of how far one run's state is from another's, for the bands
those checks hold."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["adam_state_gap"]


def adam_state_gap(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor], prog, lr: float,
                   noise_floor: float = 1e-4
                   ) -> Tuple[float, str, float, int]:
    """How far the persistables ``got`` (name -> tensor) are from
    ``want`` after Adam steps of ``prog``: (the worst max |diff| over a
    persistable's scale — the larger of its largest |value| and ``lr``,
    which a bias that starts at 0 moves by —, its name, the worst |diff|
    at a parameter element whose gradient sits at its noise floor, the
    count of such elements). A noise-floor element is one whose first
    Adam moment (its own accumulator or its slice of a fused group's) is
    at most ``noise_floor`` of its tensor's largest: Adam divides each
    gradient element by its own root mean square, so there the step
    follows the rounding of the gradient, up to lr a step, and such
    elements are left out of the worst ratio."""
    block = prog.global_block()
    m1_of = {}
    for op in block.ops:
        if op.type in ("adam", "adamw"):
            m1_of[op.input("Param")[0]] = (op.input("Moment1")[0], None)
        elif op.type in ("fused_adam", "fused_adamw"):
            off = 0
            for p in op.input("Param"):
                n = int(np.prod(block.var(p).shape))
                m1_of[p] = (op.input("Moment1")[0], (off, off + n))
                off += n
    worst, worst_name, floor_worst, n_floor = 0.0, "", 0.0, 0
    for n, ref in want.items():
        ref = ref.double()
        diff = (got[n].double() - ref).abs()
        scale = max(ref.abs().max().item(), lr)
        if n in m1_of:
            m1_name, span = m1_of[n]
            m1 = want[m1_name].double().abs()
            if span is not None:
                m1 = m1[span[0]:span[1]]
            m1 = m1.reshape(diff.shape)
            floor = m1 <= noise_floor * m1.max()
            n_floor += int(floor.sum())
            if floor.any():
                floor_worst = max(floor_worst, diff[floor].max().item())
            diff = torch.where(floor, 0.0, diff)
        ratio = diff.max().item() / scale
        if ratio > worst:
            worst, worst_name = ratio, n
    return worst, worst_name, floor_worst, n_floor
