"""The work of one launch of each hand kernel: its operations and the
bytes it must move, from the call's shapes and dtype — one function for
each ``cuda_kernels.KERNELS`` entry.

Bytes count each input read once and each output written once, whatever
the kernel reads again; where the work depends on the data (the decode
kernels read rows ``0..positions[b]``), the count is what the call's data
needs. ``flop_dtype`` names the peak the operations run against
(``observability.hw.bound_ms``): the tensor cores' bf16 rate for the
matrix-product kernels in bf16, float32 otherwise.

``chip_smoke.py`` takes every kernel's bound from these functions, and
the roofline attribution (``observability/attribution.py``) sums them
over a capture's launches: while a :class:`LaunchCosts` is armed
(:func:`arm`), each kernel wrapper adds its launch's cost after the
launch; unarmed, a wrapper pays one check of ``cuda_kernels.CAPTURE``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["Cost", "LaunchCosts", "arm", "fused_ln",
           "fused_ln_bwd", "decode_slab", "decode_paged", "logits_head",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ce_fwd",
           "opt_adamw_flat", "opt_sgd", "opt_momentum", "opt_adam"]


class Cost(NamedTuple):
    flops: float
    nbytes: float
    flop_dtype: str          # "bf16" or "f32": the peak rate they run at


def _mm_dtype(esz: int) -> str:
    return "bf16" if esz == 2 else "f32"


def fused_ln(R: int, D: int, esz: int, residual: bool = False,
             bias_add: bool = False, mask: bool = False,
             stats: bool = True) -> Cost:
    """The forward over rows [R, D] of ``esz``-byte elements: reads x, the
    residual [R, D], bias_add [D], the dropout mask [R, D] (one byte an
    element), scale and bias [D] float32; writes y, s (when any of the
    three is given), mu and rstd [R] float32 (``stats``). 8 operations an
    element, one more for each add and two for the mask."""
    emit = residual or bias_add or mask
    nbytes = (R * D * esz * (2 + residual + emit) + bias_add * D * esz
              + mask * R * D + 2 * D * 4 + stats * 2 * R * 4)
    flops = R * D * (8 + residual + bias_add + 2 * mask)
    return Cost(flops, nbytes, "f32")


def fused_ln_bwd(R: int, D: int, esz: int, dsx: bool = False,
                 mask: bool = False) -> Cost:
    """The backward over rows [R, D]: reads s, dy, dsx (when given), the
    mask, mu and rstd [R], scale [D]; writes ds, dx (with a mask),
    dscale and dbias [D] float32. 13 operations an element, one more for
    dsx and two for the mask."""
    nbytes = (R * D * esz * (3 + dsx + mask) + mask * R * D + 2 * R * 4
              + 3 * D * 4)
    return Cost(R * D * (13 + dsx + 2 * mask), nbytes, "f32")


def decode_slab(positions, active, nh: int, hd: int, esz: int) -> Cost:
    """One slab decode call: q and the new rows read, rows 0..pos of K and
    V read, the active lanes' rows written, out written, positions and
    active read; 4 hd + 3 operations a row scored."""
    pos = np.asarray(positions, np.int64)
    Bn = len(pos)
    rows = int((pos + 1).sum())
    nbytes = (3 * Bn * nh * hd * esz                          # q, new k/v
              + 2 * rows * nh * hd * esz                      # K, V rows
              + 2 * int(np.asarray(active).sum()) * nh * hd * esz
              + Bn * nh * hd * esz + 2 * Bn * 4)              # out, ints
    return Cost(rows * nh * (4 * hd + 3), nbytes, "f32")


def decode_paged(tables, positions, nh: int, hd: int, esz: int,
                 page: int) -> Cost:
    """One paged decode call: as the slab's, with each distinct (page,
    row) read once (a dead lane's rows alias page 0's, shared prefix
    pages are read once) and the table entries 0..pos / page of each
    lane."""
    tab = np.asarray(tables, np.int64)
    pos = np.asarray(positions, np.int64)
    Bn = len(pos)
    rows = int((pos + 1).sum())                               # rows scored
    keys = [tab[b, np.arange(pos[b] + 1) // page] * page
            + np.arange(pos[b] + 1) % page for b in range(Bn)]
    distinct = len(np.unique(np.concatenate(keys))) if keys else 0
    table_ints = int((pos // page + 1).sum())
    nbytes = (3 * Bn * nh * hd * esz                          # q, new k/v
              + 2 * distinct * nh * hd * esz                  # K, V rows
              + 2 * Bn * nh * hd * esz                        # rows written
              + Bn * nh * hd * esz + Bn * 4                   # out, pos
              + table_ints * 4)                               # the table
    return Cost(rows * nh * (4 * hd + 3), nbytes, "f32")


def logits_head(nb: int, D: int, V: int, esz: int) -> Cost:
    """x [nb, D] and the [D, V] weight read once, scale and bias [D]
    float32, logits [nb, V] written; 2 nb D V operations of the product
    and 8 an element of the layernorm."""
    nbytes = nb * D * esz + 2 * D * 4 + D * V * esz + nb * V * esz
    return Cost(2 * nb * D * V + 8 * nb * D, nbytes, _mm_dtype(esz))


def _flash(n_act: int, n_f32: int, n_mm: int, B: int, T: int, nh: int,
           hd: int, esz: int, causal: bool, bias_elems: int) -> Cost:
    act = B * T * nh * hd * esz                   # one [B, T, nh, hd]
    f32 = B * nh * T * 4                          # lse or D [B, nh, T]
    pairs = (B * nh * T * (T + 1) // 2 if causal  # (q, k) pairs scored
             else B * nh * T * T)
    return Cost(2 * hd * n_mm * pairs,
                n_act * act + n_f32 * f32 + 4 * bias_elems, _mm_dtype(esz))


def flash_fwd(B: int, T: int, nh: int, hd: int, esz: int,
              causal: bool = True, bias_elems: int = 0) -> Cost:
    """q, k, v read, o and lse written, the float32 bias read; two
    products a scored (q, k) pair."""
    return _flash(4, 1, 2, B, T, nh, hd, esz, causal, bias_elems)


def flash_bwd_dq(B: int, T: int, nh: int, hd: int, esz: int,
                 causal: bool = True, bias_elems: int = 0) -> Cost:
    """q, k, v, o, dO read and dq written, lse; three products a pair."""
    return _flash(6, 1, 3, B, T, nh, hd, esz, causal, bias_elems)


def flash_bwd_dkv(B: int, T: int, nh: int, hd: int, esz: int,
                  causal: bool = True, bias_elems: int = 0) -> Cost:
    """q, k, v, dO read, dk and dv written, lse and D (from dQ, where the
    reference's form reads o); four products a pair."""
    return _flash(6, 2, 4, B, T, nh, hd, esz, causal, bias_elems)


def ce_fwd(n: int, D: int, vocab: int, esz: int, bias: bool = False
           ) -> Cost:
    """The vocab's real columns: x, those head columns (and the float32
    bias) and the labels read, lse and gold written; 2 n D V
    operations."""
    nbytes = (n * D * esz + D * vocab * esz + (4 * vocab if bias else 0)
              + n * 4 + 2 * n * 4)
    return Cost(2 * n * D * vocab, nbytes, _mm_dtype(esz))


def opt_adamw_flat(n: int, moment_esz: int) -> Cost:
    """p, g and the decay mask read (float32), p written, m and v read
    and written in their dtype; 18 operations an element."""
    return Cost(18 * n, n * (4 * 4 + 4 * moment_esz), "f32")


def opt_sgd(n: int, esz: int = 4) -> Cost:
    """p and g read, p written; 2 operations an element."""
    return Cost(2 * n, 3 * n * esz, "f32")


def opt_momentum(n: int) -> Cost:
    """p, g and the velocity read, p and the velocity written (float32);
    4 operations an element."""
    return Cost(4 * n, 20 * n, "f32")


def opt_adam(n: int, coeff: bool = False) -> Cost:
    """p, g, m, v read and p, m, v written (float32); 12 operations an
    element, 14 with AdamW's decay."""
    return Cost((14 if coeff else 12) * n, 28 * n, "f32")


# ---------------------------------------------------------------------------
# the launches' costs while a capture is armed
# ---------------------------------------------------------------------------


def _host(a):
    """A cost argument as the cost function takes it: a tensor (the
    decode kernels' positions, active lanes and tables) read to numpy."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return a


class LaunchCosts:
    """Each armed launch's (kernel, cost function, arguments), in launch
    order. The arguments are kept and evaluated by :meth:`resolve`, after
    the capture: the decode kernels' cost reads positions and tables that
    lie on the card, and reading them at launch would wait for the
    device. The callers never write those tensors after the launch (the
    engine feeds fresh ones each tick)."""

    def __init__(self):
        self._pending: List[tuple] = []
        self._resolved: Optional[List[Tuple[str, Cost]]] = None
        self._lock = threading.Lock()

    def add(self, name: str, fn, *args) -> None:
        with self._lock:
            self._pending.append((name, fn, args))
            self._resolved = None

    def resolve(self) -> List[Tuple[str, Cost]]:
        """[(kernel, Cost)] in launch order."""
        with self._lock:
            if self._resolved is None:
                self._resolved = [(name, fn(*(_host(a) for a in args)))
                                  for name, fn, args in self._pending]
            return list(self._resolved)

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{kernel: {"launches", "flops", "bytes"}} summed over the
        launches."""
        out: Dict[str, Dict[str, float]] = {}
        for name, c in self.resolve():
            t = out.setdefault(name, {"launches": 0, "flops": 0.0,
                                      "bytes": 0.0})
            t["launches"] += 1
            t["flops"] += c.flops
            t["bytes"] += c.nbytes
        return out


class _Armed:
    """What the wrappers see while any capture is armed: a launch goes to
    every armed :class:`LaunchCosts` (captures nest: a program report's
    first call inside a profile capture counts in both)."""

    def __init__(self, armed: List[LaunchCosts]):
        self.armed = armed

    def add(self, name: str, fn, *args) -> None:
        for costs in self.armed:
            costs.add(name, fn, *args)


_ARMED: List[LaunchCosts] = []


@contextlib.contextmanager
def arm(costs: Optional[LaunchCosts] = None):
    """Record every hand-kernel launch's cost into ``costs`` (a new
    :class:`LaunchCosts` if None) for the block; yields it."""
    from . import cuda_kernels as _ck

    costs = costs if costs is not None else LaunchCosts()
    _ARMED.append(costs)
    _ck.CAPTURE = _Armed(list(_ARMED))
    try:
        yield costs
    finally:
        _ARMED.remove(costs)
        _ck.CAPTURE = _Armed(list(_ARMED)) if _ARMED else None
