"""Static cost model for autotune pruning — the port of
``paddle_tpu/tuning/static_cost.py``, formula for formula.

The GSPMD discipline (prune the candidate space with build-time
estimates, measure only the survivors). The model is a *pruner*, not a
simulator: it anchors on the incumbent's program report (its ``flops``,
``bytes_accessed`` and ``memory.peak_hbm_bytes``,
``observability/program_report.py``) and scales those facts by per-knob
factors, then places the result on the roofline:

    ms = max(flops / peak_bf16_flops, bytes / peak_hbm_bw) * 1e3
         + wire_bytes / ici_bw * 1e3

The port's report differs from the reference's AOT one: its ``flops``
are the ``aten`` ops' FLOPs plus the hand kernels' (counted only when
asked, so the tuner counts them for the incumbent's rung-0 probe alone),
and its ``bytes_accessed`` are the hand kernels' bytes only — an
``aten`` op's traffic is not known — so the byte side is a LOWER bound
and on the card the train roofline is FLOP-bound. Wire bytes come from
the comm_opt ring model (``parallel/comm_opt.wire_bytes``), so the
pruner and the runtime's collective accounting read off one formula.
Absolute numbers are coarse; pruning compares CANDIDATE vs INCUMBENT
through the same formula, so the systematic error cancels. Two prune
rules (driver.py applies them):

* ``static_worse`` — predicted more than ``static_margin`` slower than
  the incumbent's own prediction;
* ``over_hbm`` — predicted peak residency exceeds the card's
  ``hbm_capacity_bytes`` budget (None off the card: a host has no fixed
  device-memory budget, the rule is skipped unless a budget is forced
  for tests).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..parallel.comm_opt import wire_bytes
from .space import Candidate, parse_disagg_ratio

__all__ = ["BaseStats", "HwModel", "StaticEstimate", "predict_train",
           "predict_serve", "REMAT_FLOP_FACTOR", "REMAT_ACT_FACTOR",
           "INTERPRET_PENALTY", "COMM_DTYPE_BYTES"]

# remat policy -> fwd+bwd FLOP multiplier relative to no-remat ("full"
# replays the whole forward, "dots" recomputes only elementwise residue,
# "save_only_flash" replays everything but the tagged attention)
REMAT_FLOP_FACTOR = {"none": 1.00, "dots": 1.22, "save_only_flash": 1.28,
                     "full": 1.33}
# remat policy -> saved-activation residency multiplier (the HBM side of
# the same trade)
REMAT_ACT_FACTOR = {"none": 1.00, "dots": 0.45, "save_only_flash": 0.20,
                    "full": 0.12}
# the reference modelled interpret-mode Pallas off the TPU with this
# penalty on an opt-in fused kernel; off the card the port runs the
# kernels' plain versions instead, and keeps the penalty where ``on_acc``
# is False so that its static model equals the reference's on the CPU
INTERPRET_PENALTY = 6.0
COMM_DTYPE_BYTES = {"f32": 4, None: 4, "bf16": 2, "int8": 1}
# activation share of the reported peak residency the remat factor
# scales (the rest is params + optimizer state, remat-invariant)
_ACT_SHARE = 0.5


@dataclasses.dataclass(frozen=True)
class BaseStats:
    """Facts from the incumbent's probe: its program report plus the
    geometry the report was captured at."""
    flops: float
    bytes_accessed: float
    peak_hbm_bytes: float
    param_bytes: float = 0.0
    tokens_per_step: int = 0     # batch * T (train) — sizes the CE logits
    vocab_size: int = 0
    incumbent: Optional[Candidate] = None


# the reference's host fallbacks (``paddle_tpu/observability/hw.py``):
# off the card the roofline stays finite, with no memory budget
CPU_PEAK_FLOPS = 1e12
CPU_PEAK_HBM_BPS = 50e9


@dataclasses.dataclass(frozen=True)
class HwModel:
    """Roofline denominators + the tune's device-memory budget.

    ``ici_bps`` stays the reference's nominal 9e10 B/s a link. The ranks
    of this port's one-card lanes talk through gloo staging (the f32
    all-reduce at about 0.6 GB/s), so there the wire term is a relative
    figure between candidates, not a time."""
    peak_flops: float
    peak_hbm_bps: float
    hbm_capacity_bytes: Optional[float] = None   # None = no budget rule
    ici_bps: float = 9e10
    on_acc: bool = False

    @classmethod
    def for_device(cls, device=None, hbm_capacity_bytes=...):
        """The model of a ``torch.device`` (default: the card; the CPU
        only when asked for): on the card the peaks of
        ``observability/hw.py`` (raising for a card it does not hold, or
        when no card is visible), on the CPU the reference's
        fallbacks."""
        import torch

        from ..observability import hw

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device (pass device='cpu' for "
                                   "the CPU)")
            row = hw.peaks_for(torch.cuda.get_device_name(dev))
            cap = (row.get("hbm_capacity_bytes")
                   if hbm_capacity_bytes is ... else hbm_capacity_bytes)
            return cls(peak_flops=row["bf16_flops_per_s"],
                       peak_hbm_bps=row["hbm_bytes_per_s"],
                       hbm_capacity_bytes=cap, on_acc=True)
        cap = None if hbm_capacity_bytes is ... else hbm_capacity_bytes
        return cls(peak_flops=CPU_PEAK_FLOPS, peak_hbm_bps=CPU_PEAK_HBM_BPS,
                   hbm_capacity_bytes=cap, on_acc=False)


@dataclasses.dataclass(frozen=True)
class StaticEstimate:
    ms: float
    peak_hbm_bytes: float
    over_hbm: bool
    bound: str                   # "flops" | "bytes"
    detail: Dict[str, Any]


def _roofline_ms(flops, nbytes, hw: HwModel):
    tf = flops / hw.peak_flops * 1e3
    tb = nbytes / hw.peak_hbm_bps * 1e3
    return max(tf, tb), ("flops" if tf >= tb else "bytes")


def predict_train(cand: Candidate, base: BaseStats, hw: HwModel,
                  dp: int = 1) -> StaticEstimate:
    inc = base.incumbent
    inc_remat = inc.get("remat", "none") if inc else "none"
    remat = cand.get("remat", "none")

    flops = base.flops * (REMAT_FLOP_FACTOR[remat]
                          / REMAT_FLOP_FACTOR[inc_remat])
    bytes_mult = 1.0
    if cand.get("fused_opt"):
        bytes_mult *= 0.97     # one flat sweep instead of per-leaf updates
    if cand.get("fused_ln"):
        bytes_mult *= 0.97     # fused residual+layernorm launches
    nbytes = base.bytes_accessed * bytes_mult

    ms, bound = _roofline_ms(flops, nbytes, hw)
    if not hw.on_acc and cand.get("fused_ln"):
        ms *= INTERPRET_PENALTY   # the reference's off-TPU penalty

    # wire term: the per-step gradient reduction over dp ranks through
    # the comm_opt ring model, at the candidate's wire dtype
    wire_ms = 0.0
    wire = 0
    if dp > 1 and base.param_bytes:
        op = ("psum_scatter" if cand.get("grad_reduce") == "reduce_scatter"
              else "psum")
        scale = COMM_DTYPE_BYTES[cand.get("comm_dtype", "f32")] / 4.0
        payload = int(base.param_bytes * scale)
        wire = wire_bytes(op, payload, dp)
        if cand.get("grad_reduce") == "reduce_scatter":
            # updated params return via all_gather (same ring factor)
            wire += wire_bytes("all_gather", payload, dp)
        wire_ms = wire / hw.ici_bps * 1e3
    ms += wire_ms

    # peak-HBM model: activation share scales with the remat factor;
    # vocab-chunked CE eliminates the full [tokens, V] f32 logits; the
    # reduce-scatter path adds its double-buffered flat bucket
    act = REMAT_ACT_FACTOR[remat] / REMAT_ACT_FACTOR[inc_remat]
    peak = base.peak_hbm_bytes * ((1.0 - _ACT_SHARE) + _ACT_SHARE * act)
    if base.tokens_per_step and base.vocab_size:
        logits = base.tokens_per_step * base.vocab_size * 4.0
        vc, ivc = cand.get("ce_vocab_chunk", 0), \
            (inc.get("ce_vocab_chunk", 0) if inc else 0)
        if vc and not ivc:
            peak -= logits * (1.0 - vc / base.vocab_size)
        elif ivc and not vc:
            peak += logits * (1.0 - ivc / base.vocab_size)
    if cand.get("grad_reduce") == "reduce_scatter":
        peak += cand.get("bucket_mb", 32.0) * (1 << 20) * 2
    peak = max(peak, 0.0)

    over = (hw.hbm_capacity_bytes is not None
            and peak > hw.hbm_capacity_bytes * 0.95)
    return StaticEstimate(ms=ms, peak_hbm_bytes=peak, over_hbm=over,
                          bound=bound,
                          detail={"flops": flops, "bytes": nbytes,
                                  "wire_bytes": int(wire),
                                  "wire_ms": wire_ms})


def predict_serve(cand: Candidate, base: BaseStats, hw: HwModel,
                  kv_page_bytes: float = 0.0) -> StaticEstimate:
    """ms per decoded token. ``base`` is the incumbent's decode-tick
    report; ``kv_page_bytes`` sizes the paged pool for the HBM rule."""
    inc = base.incumbent
    wd_mult = {"f32": 1.0, "bf16": 0.55, "int8": 0.4}
    nbytes = base.bytes_accessed * (
        wd_mult.get(cand.get("weight_dtype", "f32"), 1.0)
        / wd_mult.get(inc.get("weight_dtype", "f32") if inc else "f32",
                      1.0))
    # decode throughput scales with the static batch until compute-bound:
    # per-token cost divides by the slot ratio (weights are re-read once
    # per tick regardless of occupancy)
    inc_mb = (inc.get("max_batch", 8) if inc else 8) or 8
    batch_ratio = cand.get("max_batch", inc_mb) / inc_mb
    nbytes /= max(batch_ratio, 1e-6)
    flops = base.flops   # per-token matmul work is batch-invariant

    ms, bound = _roofline_ms(flops, nbytes, hw)
    if not hw.on_acc and cand.get("fused_decode"):
        ms *= INTERPRET_PENALTY
    k = cand.get("spec", 0)
    if k:
        # optimistic acceptance bound — spec candidates survive to the
        # measured phase, which scores the REAL acceptance rate
        ms /= (1.0 + 0.5 * k)
    ratio = parse_disagg_ratio(cand.get("disagg", "off"))
    if ratio:
        # per-chip view: p+d replicas serve the decode stream the d
        # replicas absorb — static model keeps throughput neutral and
        # lets the measured probe arbitrate (TTFT is what disagg buys)
        ms *= sum(ratio) / max(ratio[1] * cand.get(
            "disagg_decode_batch", 1), 1)

    peak = base.peak_hbm_bytes
    pool = cand.get("num_pages", 0)
    if pool and kv_page_bytes:
        peak += pool * kv_page_bytes
    peak *= cand.get("max_batch", inc_mb) / inc_mb

    over = (hw.hbm_capacity_bytes is not None
            and peak > hw.hbm_capacity_bytes * 0.95)
    return StaticEstimate(ms=ms, peak_hbm_bytes=peak, over_hbm=over,
                          bound=bound,
                          detail={"flops": flops, "bytes": nbytes})
