"""TUNED.json — the autotuner's reproducible artifact, the port of
``paddle_tpu/tuning/tuned.py`` (schema v1, the reference's).

One document every lane accepts: ``tools/train_bench.py --tuned=``,
``tools/serve_bench.py --tuned=``, ``tools/profile_step.py --tuned``
and ``make_train_step(tuned=)`` / ``init_sharded(tuned=)``. Schema (v1)::

    {"version": 1, "generated_by": "...", "args": "...",
     "hw": {"platform", "device_kind", "n_devices", "degraded",
            "fingerprint"},
     "spaces": {"train": {"config": {...}, "incumbent": {...},
                          "winner_key", "incumbent_key", "improved",
                          "score": {"winner_ms", "incumbent_ms"},
                          "probes_executed", "pruned": {reason: n},
                          "provenance": {knob: {"value", "static_ms",
                                                "measured_ms",
                                                "delta_vs_incumbent_ms",
                                                "probe_ids"}}},
                "serve": {...same shape...}},
     "arbitration": {"ran", "ok", "exit_code"}}

Application is FINGERPRINT-GATED: :func:`load_for_device` compares the
document's ``hw`` block (``platform`` "gpu" on the card, "cpu" off it;
``device_kind``; ``n_devices``) against the live device and warns +
returns ``None`` on mismatch — a CPU-tuned config never silently applies
on the card. Appliers only override knobs the caller left at the
documented defaults: an explicit caller choice always wins over the
tuner. The repository root's ``TUNED.json`` is the JAX package's CPU
artifact; the port's tunes are written under a run directory.
"""
from __future__ import annotations

import hashlib
import json
import math
import warnings
from typing import Any, Dict, Optional

from .driver import TuneResult

__all__ = ["SCHEMA_VERSION", "build_doc", "save", "load",
           "load_for_device", "file_hash", "tuned_stamp",
           "train_cfg_kwargs", "resolve_train_step_kwargs",
           "engine_kwargs", "serve_lane_kwargs", "config_stamp"]

SCHEMA_VERSION = 1

# the documented defaults appliers respect (an explicit caller value
# that differs from these is never overridden)
TRAIN_STEP_DEFAULTS = {"grad_reduce": "psum", "grad_allreduce_dtype": None,
                       "bucket_mb": 32.0, "error_feedback": False,
                       "fused_opt": False}


def _num(v):
    if v is None or (isinstance(v, float) and math.isinf(v)) or v == "inf":
        return None
    return round(float(v), 4)


def build_doc(results: Dict[str, TuneResult], hw: Dict[str, Any], *,
              generated_by: str = "paddle_tpu_torch/tools/autotune.py",
              args: str = "") -> Dict[str, Any]:
    spaces: Dict[str, Any] = {}
    for space, tr in results.items():
        win_res = tr.results.get(tr.winner.key, {})
        inc_res = tr.results.get(tr.incumbent.key, {})
        win_est = tr.static.get(tr.winner.key)
        win_ms = win_res.get("score")
        inc_ms = inc_res.get("score")
        delta = (_num(win_ms) - _num(inc_ms)
                 if _num(win_ms) is not None and _num(inc_ms) is not None
                 else None)
        pids = tr.probe_ids.get(tr.winner.key, [])
        prov = {}
        for k, v in tr.winner.as_dict().items():
            prov[k] = {
                "value": v,
                "static_ms": _num(win_est.ms) if win_est else None,
                "measured_ms": _num(win_ms),
                "delta_vs_incumbent_ms": (round(delta, 4)
                                          if delta is not None else None),
                "probe_ids": list(pids),
            }
        spaces[space] = {
            "config": tr.winner.as_dict(),
            "incumbent": tr.incumbent.as_dict(),
            "winner_key": tr.winner.key,
            "incumbent_key": tr.incumbent.key,
            "improved": bool(tr.improved),
            "score": {"winner_ms": _num(win_ms),
                      "incumbent_ms": _num(inc_ms)},
            "probes_executed": tr.probes_executed,
            "pruned": dict(tr.pruned),
            "rungs": [list(r) for r in tr.rungs],
            "provenance": prov,
        }
    return {"version": SCHEMA_VERSION, "generated_by": generated_by,
            "args": args, "hw": dict(hw), "spaces": spaces,
            "arbitration": {"ran": False, "ok": None, "exit_code": None}}


def save(path: str, doc: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    v = doc.get("version")
    if v != SCHEMA_VERSION:
        raise ValueError(f"TUNED.json schema version {v!r} != "
                         f"{SCHEMA_VERSION} ({path})")
    return doc


def file_hash(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:12]


def tuned_stamp(path: str) -> Dict[str, str]:
    """The ``tuned_from`` attribution stamp: path + content hash, so
    perf_diff cause-attributes a regression to the exact tune."""
    return {"path": str(path), "sha256": file_hash(path)}


def load_for_device(path_or_doc, device_info=None) -> Optional[Dict[str, Any]]:
    """Load + fingerprint-gate a TUNED.json. Returns the doc, or None
    (with a RuntimeWarning) when the document was tuned on different
    hardware — callers fall back to their committed defaults.
    ``device_info`` (the device the document is applied on) defaults to
    the card's (:func:`.probe.device_info`, which raises when no card is
    visible)."""
    if isinstance(path_or_doc, str):
        try:
            doc = load(path_or_doc)
        except (OSError, ValueError) as e:
            warnings.warn(f"TUNED.json unusable ({e}); "
                          "falling back to defaults", RuntimeWarning)
            return None
    else:
        doc = path_or_doc
    if device_info is None:
        from .probe import device_info as _di

        device_info = _di()
    hw = doc.get("hw") or {}
    live = {"platform": device_info.platform,
            "device_kind": device_info.device_kind,
            "n_devices": device_info.n_devices}
    mismatch = [k for k, v in live.items() if hw.get(k) != v]
    if mismatch:
        warnings.warn(
            "TUNED.json hw fingerprint mismatch on "
            f"{','.join(mismatch)} (tuned: "
            f"{ {k: hw.get(k) for k in mismatch} }, live: "
            f"{ {k: live[k] for k in mismatch} }); "
            "falling back to defaults", RuntimeWarning)
        return None
    return doc


def _space_config(doc: Dict[str, Any], space: str) -> Dict[str, Any]:
    return ((doc or {}).get("spaces") or {}).get(space, {}).get(
        "config") or {}


# ---------------------------------------------------------------------------
# appliers
# ---------------------------------------------------------------------------

def train_cfg_kwargs(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Model-config side of the train winner: kwargs for
    ``GPTConfig.scaled``."""
    cfg = _space_config(doc, "train")
    if not cfg:
        return {}
    out: Dict[str, Any] = {}
    if "remat" in cfg:
        out["remat"] = cfg["remat"] != "none"
        out["remat_policy"] = cfg["remat"]
    if "fused_ln" in cfg:
        out["fused_ln"] = bool(cfg["fused_ln"])
    vc = int(cfg.get("ce_vocab_chunk", 0) or 0)
    if vc:
        # the chunked CE path only engages under the direct-bytes gate
        out["ce_vocab_chunk"] = vc
        out["ce_direct_bytes_limit"] = 0
    return out


def resolve_train_step_kwargs(doc: Dict[str, Any], pcfg,
                              current: Dict[str, Any]) -> Dict[str, Any]:
    """Step-builder side of the train winner. ``current`` holds the
    caller's actual kwargs; a knob is applied only where the caller left
    the documented default, and skipped (with a warning) when invalid
    for the actual mesh — e.g. reduce_scatter on dp=1."""
    cfg = _space_config(doc, "train")
    out = dict(current)
    if not cfg:
        return out
    dp = getattr(pcfg, "dp", 1)
    n_dev = getattr(pcfg, "n_devices", dp)

    def want(name, default, tuned_val):
        return (current.get(name, default) == default
                and tuned_val != default)

    gr = cfg.get("grad_reduce", "psum")
    if want("grad_reduce", "psum", gr):
        if dp < 2:
            warnings.warn("tuned grad_reduce=reduce_scatter skipped: "
                          "dp=1 mesh has no gradient reduction",
                          RuntimeWarning)
        else:
            out["grad_reduce"] = gr
    dtype = cfg.get("comm_dtype", "f32")
    tuned_dtype = None if dtype == "f32" else dtype
    if want("grad_allreduce_dtype", None, tuned_dtype):
        if dp < 2:
            warnings.warn(f"tuned comm_dtype={dtype} skipped: dp=1",
                          RuntimeWarning)
        else:
            out["grad_allreduce_dtype"] = tuned_dtype
            if cfg.get("error_feedback") and \
                    current.get("error_feedback", False) is False:
                out["error_feedback"] = True
    bm = float(cfg.get("bucket_mb", 32.0))
    if want("bucket_mb", 32.0, bm) and \
            out.get("grad_reduce") == "reduce_scatter":
        out["bucket_mb"] = bm
    if want("fused_opt", False, bool(cfg.get("fused_opt", False))):
        if n_dev > 1 and out.get("grad_reduce", "psum") != "reduce_scatter":
            warnings.warn("tuned fused_opt skipped: multi-device psum "
                          "mesh refuses the flat-buffer optimizer",
                          RuntimeWarning)
        else:
            out["fused_opt"] = True
    return out


def engine_kwargs(doc: Dict[str, Any], *, page_size: int = 8
                  ) -> Dict[str, Any]:
    """Serving-engine side of the serve winner: kwargs for
    ``EngineConfig`` (geometry + dtype + layout + fused decode +
    sharding; the spec/disagg lane shape comes from
    :func:`serve_lane_kwargs`)."""
    cfg = _space_config(doc, "serve")
    if not cfg:
        return {}
    out: Dict[str, Any] = {}
    if cfg.get("buckets"):
        out["prefill_buckets"] = tuple(int(b) for b in cfg["buckets"])
    if cfg.get("max_batch"):
        out["max_batch"] = int(cfg["max_batch"])
    if cfg.get("kv_layout") == "paged":
        out["kv_layout"] = "paged"
        out["page_size"] = int(page_size)
        if cfg.get("num_pages"):
            out["num_pages"] = int(cfg["num_pages"])
    if "fused_decode" in cfg:
        # stated either way: the port's EngineConfig defaults to the fused
        # tick, where the reference's defaults to the unfused one
        out["fused_decode"] = bool(cfg["fused_decode"])
    if cfg.get("weight_dtype") and cfg["weight_dtype"] != "f32":
        out["weight_dtype"] = cfg["weight_dtype"]
    if cfg.get("sharding", "none") != "none":
        out["sharding"] = cfg["sharding"]
        out["tp"] = int(cfg.get("tp", 2))
    return out


def serve_lane_kwargs(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Lane-shape side of the serve winner: the spec-decode window and
    the disagg ratio + per-role decode-batch multiplier."""
    cfg = _space_config(doc, "serve")
    if not cfg:
        return {}
    return {"spec": int(cfg.get("spec", 0) or 0),
            "disagg": cfg.get("disagg", "off"),
            "disagg_decode_batch": int(
                cfg.get("disagg_decode_batch", 1) or 1)}


def config_stamp(doc: Optional[Dict[str, Any]], path: Optional[str] = None
                 ) -> Dict[str, Any]:
    """The attribution ``config`` stamp: the full tuned knob vector per
    space + the tuned_from provenance pointer."""
    if not doc:
        return {}
    stamp: Dict[str, Any] = {
        "train": _space_config(doc, "train"),
        "serve": _space_config(doc, "serve"),
    }
    stamp = {k: v for k, v in stamp.items() if v}
    if path:
        stamp["tuned_from"] = tuned_stamp(path)
    return stamp
