"""Declarative autotune knob space — the port of
``paddle_tpu/tuning/space.py`` (names, keys and refusal reasons the
reference's).

Two spaces, one grammar:

* **train** — every lever ``make_train_step``/``GPTConfig`` exposes that
  trades device memory, wire bytes and FLOPs: remat policy,
  gradient-reduction strategy + collective wire dtype + bucket cap, the
  fused flat-buffer optimizer, fused layernorm, and the CE vocab chunk.
* **serve** — the serving geometry ``EngineConfig`` fixes: the
  prefill-bucket ladder, ``max_batch``, KV layout + page-pool size, the
  fused decode tick, the spec-decode window, the weight dtype, tp
  sharding, and the disagg prefill:decode ratio with a per-role
  decode-batch multiplier.

A :class:`Candidate` is an immutable, canonically-keyed knob assignment.
Enumeration runs every cross-product combo through ``normalize`` (drop
meaningless distinctions — a psum config has no bucket cap, a slab engine
no page pool) and then the validity predicates, which mirror the refusals
the PORT's runtime enforces, so an invalid candidate is refused here,
with a logged reason, instead of crashing a probe. Where they differ from
the reference's:

* ``make_train_step`` refuses ``error_feedback`` without reduce-scatter
  (``parallel/parallelize.py``), so an int8 psum candidate is refused
  (``invalid:error_feedback_needs_reduce_scatter``); the reference's
  space lets it through to a probe its own step refuses.
* the reference refuses spec with the fused decode tick (its verify
  executable has no fused lowering); the port's ``verify_step`` runs
  beside the fused tick, so that rule is not here.
* the serve incumbent is the port's ``EngineConfig`` defaults, whose
  ``fused_decode`` is True (the reference's is False).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Candidate", "SpaceContext", "train_axes", "serve_axes",
           "enumerate_space", "train_incumbent", "serve_incumbent",
           "validate_train", "validate_serve", "parse_disagg_ratio"]


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One knob assignment in one space, keyed canonically."""
    space: str
    knobs: Tuple[Tuple[str, Any], ...]

    @classmethod
    def make(cls, space: str, **knobs) -> "Candidate":
        return cls(space, tuple(sorted((k, _freeze(v))
                                       for k, v in knobs.items())))

    @property
    def key(self) -> str:
        def fmt(v):
            if isinstance(v, tuple):
                return "/".join(str(x) for x in v)
            if isinstance(v, bool):
                return "1" if v else "0"
            return str(v)
        return self.space + ":" + ",".join(
            f"{k}={fmt(v)}" for k, v in self.knobs)

    def get(self, name: str, default=None):
        for k, v in self.knobs:
            if k == name:
                return v
        return default

    def as_dict(self) -> Dict[str, Any]:
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in self.knobs}

    def replace(self, **kw) -> "Candidate":
        d = dict(self.knobs)
        d.update(kw)
        return Candidate.make(self.space, **d)


@dataclasses.dataclass(frozen=True)
class SpaceContext:
    """What the predicates need to know about the lane being tuned."""
    dp: int = 1                 # data-parallel ranks the train probe uses
    n_devices: int = 1          # visible device count
    platform: str = "cpu"
    vocab_size: int = 256
    max_seq: int = 64
    max_batch: int = 8          # serve base geometry
    page_size: int = 8
    on_acc: bool = False


def parse_disagg_ratio(ratio: str) -> Optional[Tuple[int, int]]:
    """``"p:d"`` -> (prefill_replicas, decode_replicas); None for "off"
    or malformed."""
    if not ratio or ratio == "off" or ":" not in ratio:
        return None
    try:
        p, d = ratio.split(":")
        return int(p), int(d)
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# train space
# ---------------------------------------------------------------------------

def train_axes(ctx: SpaceContext, *,
               remats=("none", "dots", "save_only_flash", "full"),
               bucket_mbs=(8.0, 32.0, 128.0),
               vchunks=None) -> Dict[str, tuple]:
    if vchunks is None:
        vchunks = (0, max(32, ctx.vocab_size // 4))
    return {
        "remat": tuple(remats),
        "grad_reduce": ("psum", "reduce_scatter"),
        "comm_dtype": ("f32", "bf16", "int8"),
        "bucket_mb": tuple(float(b) for b in bucket_mbs),
        "fused_opt": (False, True),
        "fused_ln": (False, True),
        "ce_vocab_chunk": tuple(int(v) for v in vchunks),
    }


def normalize_train(knobs: Dict[str, Any], ctx: SpaceContext):
    k = dict(knobs)
    # error feedback exists only for quantized wire payloads
    # (CommConfig.__post_init__ refuses the reverse), and the int8 path
    # is only honest WITH the residual — force the pairing
    k["error_feedback"] = (k.get("comm_dtype") == "int8")
    # a psum config has no flat-bucket layout: the bucket cap is
    # meaningless, so pin it to the default to avoid phantom candidates
    if k.get("grad_reduce") != "reduce_scatter":
        k["bucket_mb"] = 32.0
    return k


def validate_train(knobs: Dict[str, Any], ctx: SpaceContext):
    """Refusal reason or None — mirrors the port's own refusals: at dp 1
    the step runs without a mesh, where reduce-scatter and a wire dtype
    raise."""
    if knobs.get("grad_reduce") == "reduce_scatter" and ctx.dp < 2:
        return "invalid:reduce_scatter_needs_dp"
    if knobs.get("comm_dtype", "f32") != "f32" and ctx.dp < 2:
        return "invalid:quantized_comm_needs_dp"
    if knobs.get("fused_opt") and ctx.dp > 1 and \
            knobs.get("grad_reduce") != "reduce_scatter":
        # make_train_step: flat-buffer fused optimizer on a multi-device
        # psum mesh would force an all-gather per step — refused there
        return "invalid:fused_opt_multidev_psum"
    if knobs.get("ce_vocab_chunk", 0) >= ctx.vocab_size:
        return "invalid:vchunk_ge_vocab"
    if knobs.get("error_feedback") and \
            knobs.get("grad_reduce") != "reduce_scatter":
        # make_train_step: the residual rides the reduce-scatter state
        return "invalid:error_feedback_needs_reduce_scatter"
    return None


def train_incumbent(ctx: SpaceContext) -> Candidate:
    """The committed defaults for the lane (bench.py's config ladder):
    remat=dots on-chip, none on the CPU smoke lane; psum/f32 comm."""
    return Candidate.make("train", **normalize_train({
        "remat": "dots" if ctx.on_acc else "none",
        "grad_reduce": "psum", "comm_dtype": "f32", "bucket_mb": 32.0,
        "fused_opt": False, "fused_ln": False, "ce_vocab_chunk": 0,
    }, ctx))


# ---------------------------------------------------------------------------
# serve space
# ---------------------------------------------------------------------------

def serve_axes(ctx: SpaceContext, *,
               bucket_ladders=None, max_batches=(4, 8, 16),
               page_pools=(0,), specs=(0, 3),
               disagg_ratios=("off", "1:1", "1:2"),
               disagg_decode_batches=(1, 2)) -> Dict[str, tuple]:
    if bucket_ladders is None:
        half = max(ctx.page_size, ctx.max_seq // 4)
        bucket_ladders = ((half, ctx.max_seq // 2),
                          (ctx.max_seq // 2,),
                          (ctx.page_size, half, ctx.max_seq // 2))
    return {
        "buckets": tuple(tuple(int(b) for b in lad)
                         for lad in bucket_ladders),
        "max_batch": tuple(int(b) for b in max_batches),
        "kv_layout": ("slab", "paged"),
        "num_pages": tuple(int(p) for p in page_pools),
        "fused_decode": (False, True),
        "spec": tuple(int(s) for s in specs),
        "weight_dtype": ("f32", "int8"),
        "sharding": ("none", "tp"),
        "disagg": tuple(disagg_ratios),
        "disagg_decode_batch": tuple(int(m) for m in disagg_decode_batches),
    }


def normalize_serve(knobs: Dict[str, Any], ctx: SpaceContext):
    k = dict(knobs)
    if k.get("kv_layout") != "paged":
        k["num_pages"] = 0
    if k.get("disagg", "off") == "off":
        k["disagg_decode_batch"] = 1
    else:
        # the disagg router migrates KV between replicas page-wise
        # (serving/disagg.py) — a disagg candidate is a paged candidate
        k["kv_layout"] = "paged"
    if k.get("sharding", "none") == "none":
        k["tp"] = 1
    else:
        k.setdefault("tp", 2)
    return k


def validate_serve(knobs: Dict[str, Any], ctx: SpaceContext):
    """Refusal reason or None — mirrors the engine's own refusals (spec
    with the fused tick is valid here: module docstring)."""
    if knobs.get("weight_dtype") == "int8" and \
            knobs.get("sharding") == "tp":
        # DecodeEngine refuses int8 weights under tp (serving/tp.py)
        return "invalid:int8_tp_headshard"
    if knobs.get("sharding") == "tp" and \
            ctx.n_devices < knobs.get("tp", 2):
        return "invalid:tp_needs_devices"
    ratio = parse_disagg_ratio(knobs.get("disagg", "off"))
    if knobs.get("disagg", "off") != "off":
        if ratio is None or ratio[0] < 1 or ratio[1] < 1 or sum(ratio) > 4:
            return "invalid:disagg_ratio_bounds"
        if knobs.get("spec", 0) > 0:
            return "invalid:disagg_spec_unsupported"
        if knobs.get("sharding") == "tp":
            return "invalid:disagg_tp_unsupported"
        if knobs.get("kv_layout") != "paged":
            return "invalid:disagg_needs_paged"
    if knobs.get("kv_layout") == "paged":
        buckets = knobs.get("buckets", ())
        if any(b % ctx.page_size for b in buckets):
            return "invalid:bucket_page_align"
        pool = knobs.get("num_pages", 0)
        if pool and pool < knobs.get("max_batch", ctx.max_batch) * max(
                1, min(buckets or (ctx.page_size,)) // ctx.page_size):
            return "invalid:page_pool_too_small"
    if any(b > ctx.max_seq for b in knobs.get("buckets", ())):
        return "invalid:bucket_gt_max_seq"
    return None


def serve_incumbent(ctx: SpaceContext) -> Candidate:
    """Committed serving defaults: slab, f32, the fused decode tick, no
    spec, colocated — the port's EngineConfig dataclass defaults at the
    lane's geometry (``fused_decode=True``, ``serving/engine.py``)."""
    return Candidate.make("serve", **normalize_serve({
        "buckets": (max(ctx.page_size, ctx.max_seq // 4),
                    ctx.max_seq // 2),
        "max_batch": ctx.max_batch, "kv_layout": "slab", "num_pages": 0,
        "fused_decode": True, "spec": 0, "weight_dtype": "f32",
        "sharding": "none", "disagg": "off", "disagg_decode_batch": 1,
    }, ctx))


# ---------------------------------------------------------------------------
# enumeration
# ---------------------------------------------------------------------------

_NORMALIZE = {"train": normalize_train, "serve": normalize_serve}
_VALIDATE = {"train": validate_train, "serve": validate_serve}


def enumerate_space(space: str, axes: Dict[str, tuple], ctx: SpaceContext,
                    extra: Optional[List[Candidate]] = None):
    """Cross every axis, normalize, dedupe, refuse invalid combos.

    Returns ``(valid, refused)`` where refused is a list of
    ``(candidate, reason)`` — every reason starts with ``invalid:`` and
    becomes a ``paddle_autotune_pruned_total{reason}`` increment in the
    driver."""
    normalize, validate = _NORMALIZE[space], _VALIDATE[space]
    seen = set()
    valid: List[Candidate] = []
    refused: List[Tuple[Candidate, str]] = []
    names = list(axes.keys())
    combos = itertools.product(*(axes[n] for n in names))
    cands = [Candidate.make(space, **normalize(dict(zip(names, combo)),
                                               ctx))
             for combo in combos]
    for c in cands + list(extra or ()):
        if c.key in seen:
            continue
        seen.add(c.key)
        reason = validate(dict(c.knobs), ctx)
        if reason is None:
            valid.append(c)
        else:
            refused.append((c, reason))
    return valid, refused
