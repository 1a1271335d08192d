"""Roofline attribution: every kernel of a step placed on the roofline —
the port of ``paddle_tpu/observability/attribution.py``.

The machine-readable join of three sensors:

- **measured** exclusive device time of each kernel, memcpy and memset a
  ``torch.profiler`` capture holds, joined to the host op that launched
  it (``utils/device_trace.kernel_rows``: interval-union attribution over
  parallel streams, as the reference's);
- **static** costs: a hand kernel's flops and bytes are the sum of its
  launches' costs (``ops/kernel_costs.py``), which the kernel wrappers
  record while a capture is armed; an ``aten`` op's flops are the
  profiler's ``with_flops`` count, put on its first kernel; its bytes are
  None, which the trace cannot give (the reference's graceful path);
- the card's peaks (``observability/hw.py``).

The join places every row on the roofline (achieved against peak on the
binding roof, ridge = peak_flops / peak_bandwidth), the inter-kernel gap
share and a ranked **residue list** of the small-op tail; the result is a
schema-versioned ``ATTRIBUTION.json`` (``tools/profile_step.py``, train and
``--serve``) that ``tools/perf_diff.py`` diffs across runs
(``observability/baseline.py``). A row is one (launch scope, kernel)
pair: its key (:func:`stable_key`) is the scope path's tail and the
kernel's base name, template arguments stripped, so keys do not change
from run to run.

``build``, ``_place_row``, ``validate``, ``write``, ``classify_label`` and
``stable_key`` are the reference's, with its ``SCHEMA_VERSION``: the two
packages validate each other's documents.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

__all__ = [
    "SCHEMA_VERSION", "classify_label", "stable_key",
    "measured_kernel_rows", "build", "build_from_trace", "validate",
    "write", "peaks",
]

# the reference's fallback denominators off the accelerator: a CPU
# trace's roofline stays finite, and ``degraded`` says it is no device's
_FALLBACK_FLOPS = 1e12
_FALLBACK_HBM_BPS = 50e9

# ---------------------------------------------------------------------------
# Residue / family classification
# ---------------------------------------------------------------------------

# keyword -> label, in specificity order; matched against the lowercased
# HLO metadata op_name (jax scope path) first, then the hlo op name
_LABEL_KEYWORDS = (
    # the Pallas megakernels (ops/pallas_kernels.py, docs/kernels.md) get
    # their own family line so a before/after residue diff separates the
    # residue each kernel ELIMINATES (its old group shrinks) from the
    # kernel's own cost (one custom call on TPU; interpret-mode emulation
    # ops on the CPU lane) — matched first because the scope names embed
    # the group keywords ("fused_layernorm" contains "layernorm")
    (("fused_layernorm", "fused_opt_megakernel", "fused_decode",
      "fused_logits"), "megakernel"),
    (("adam", "adamw", "sgd", "momentum", "fused_opt", "opt_update",
      "apply_grad", "optimizer", "lamb"), "optimizer"),
    (("layer_norm", "layernorm", "rms_norm", "rmsnorm"), "layernorm"),
    (("flash", "attention", "attn", "tpu_custom_call", "mosaic"),
     "attention"),
    (("softmax", "logsumexp", "cross_entropy", "log_softmax", "lm_loss",
      "nll"), "softmax_ce"),
    (("embed", "take", "lookup", "one_hot"), "embedding"),
    (("dot_general", "matmul", "convolution", "conv_general", "conv2d"),
     "matmul"),
    (("transpose", "reshape", "broadcast", "concatenate", "pad", "slice",
      "gather", "scatter", "copy", "bitcast", "convert", "select"),
     "data_movement"),
    (("add", "sub", "mul", "div", "tanh", "gelu", "relu", "exp", "neg",
      "rsqrt", "sqrt", "max", "min", "integer_pow", "clip", "cumsum"),
     "elementwise"),
    (("reduce", "sum", "mean", "norm"), "reduce"),
    (("rng", "random", "threefry", "iota"), "rng"),
)


def stable_key(op_name: str = "", hlo_op: str = "") -> str:
    """Run-stable identity for a fusion: HLO instruction numbering AND
    suffix qualifiers shift with compilation order across processes
    ('while.81' vs 'while.83', 'copy_bitcast_fusion' growing a '.clone'),
    so the sentinel keys fusions by the tail of the jax scope path
    (metadata op_name — stable for the same program) and falls back to
    the instruction name with every dot-suffix stripped."""
    if op_name:
        return "/".join(str(op_name).split("/")[-3:])
    return str(hlo_op).lstrip("%").split(".")[0] or "other"


def classify_label(op_name: str = "", hlo_op: str = "",
                   opcode: str = "") -> str:
    """Residue/family label for one fusion: the HLO opcode wins for real
    matmuls (a wgrad dot's jax scope path says 'transpose'), then a
    keyword scan over the scope path (metadata op_name), then the HLO
    opcode/name."""
    if opcode == "dot" or hlo_op.startswith(("dot", "convolution")):
        return "matmul"
    probe = (op_name or "").lower()
    for keys, label in _LABEL_KEYWORDS:
        if any(k in probe for k in keys):
            return label
    if opcode == "custom-call" or hlo_op.startswith("custom-call"):
        return "attention"
    # fused-instruction names concatenate their op chain
    # ('dynamic-slice_convert_fusion'): substring-match the chain, with
    # hyphen/underscore spellings normalized
    base = hlo_op.split(".")[0].lstrip("%").replace("-", "_")
    for keys, label in _LABEL_KEYWORDS:
        if any(k.replace("-", "_") in base for k in keys):
            return label
    return base or "other"


# ---------------------------------------------------------------------------
# Measured rows: trace x launch join
# ---------------------------------------------------------------------------

def measured_kernel_rows(trace_dir: str, steps: int = 1, costs=None
                         ) -> List[Dict[str, Any]]:
    """The capture's rows (``utils/device_trace.kernel_rows``) in the
    shape :func:`build` takes: ``name``, ``op_name``, ``label`` (a port
    kernel's ``KERNELS`` entry; else :func:`classify_label` of the scope
    path, a matrix product's launches ``matmul``), ``events``, ``ns``,
    ``ns_per_step``, ``flops`` and ``bytes`` a launch, and their totals
    over the capture (``flops_total`` / ``bytes_total``), aggregated over
    ``steps`` profiled steps, and ``source`` (``device_streams``, or
    ``cpu_ops`` off the card). ``costs`` are the capture's launch costs
    (``kernel_costs.LaunchCosts``)."""
    from ..utils import device_trace as DT

    rows, source = DT.kernel_rows(trace_dir, steps=steps, costs=costs)
    out = []
    for r in rows:
        out.append({
            "source": source,
            "name": r["name"],
            "op_name": r["op_name"],
            "kernel": r["kernel"],
            "label": (r["kernel"] or classify_label(
                r["op_name"], r["name"], r["opcode"])),
            "events": int(r["events"]),
            "ns": float(r["ns"]),
            "ns_per_step": float(r["ns_per_step"]),
            "flops": r["flops"],
            "bytes": r["bytes"],
            "flops_total": r["flops_total"],
            "bytes_total": r["bytes_total"],
        })
    out.sort(key=lambda r: (-r["ns"], r["name"]))
    return out


# ---------------------------------------------------------------------------
# Roofline math (pure — the synthetic-trace tests drive this directly)
# ---------------------------------------------------------------------------

def _frac(x: Optional[float]) -> Optional[float]:
    """Clamp a roofline fraction into [0, 1] (static bytes are unfused
    upper bounds, so raw achieved/peak can exceed 1; the raw value rides
    alongside)."""
    if x is None or not math.isfinite(x):
        return None
    return max(0.0, min(1.0, x))


def _place_row(row: Dict[str, Any], peak_flops: float,
               peak_bw: float) -> Dict[str, Any]:
    """Place one measured row on the roofline; mutates and returns it."""
    ridge = peak_flops / peak_bw if peak_bw else float("inf")
    ns, events = row["ns"], max(1, row["events"])
    dur_s = ns / 1e9
    flops, nbytes = row.get("flops"), row.get("bytes")
    rate_f = (flops * events / dur_s) if flops and dur_s > 0 else None
    rate_b = (nbytes * events / dur_s) if nbytes and dur_s > 0 else None
    intensity = (flops / nbytes) if flops and nbytes else None
    if intensity is not None:
        bound = "compute" if intensity >= ridge else "hbm"
    elif rate_b is not None:
        bound = "hbm"
    elif rate_f is not None:
        bound = "compute"
    else:
        bound = "unknown"
    compute_frac = rate_f / peak_flops if rate_f is not None else None
    hbm_frac = rate_b / peak_bw if rate_b is not None and peak_bw else None
    binding = compute_frac if bound == "compute" else hbm_frac
    row.update({
        "intensity": round(intensity, 4) if intensity is not None else None,
        "achieved_flops_per_s": rate_f,
        "achieved_bytes_per_s": rate_b,
        "compute_fraction": _frac(compute_frac),
        "hbm_fraction": _frac(hbm_frac),
        "bound": bound,
        "roofline_fraction": _frac(binding),
        "roofline_fraction_raw": (round(binding, 6)
                                  if binding is not None
                                  and math.isfinite(binding) else None),
    })
    return row


def build(rows: Iterable[Dict[str, Any]],
          steps: int,
          wall_ms_per_step: Optional[float],
          peak_flops: float,
          peak_hbm_bytes_per_s: float,
          step_flops: Optional[float] = None,
          step_bytes: Optional[float] = None,
          residue_share_threshold: float = 0.01,
          mode: str = "train",
          spec: Optional[str] = None,
          programs: Optional[List[Dict[str, Any]]] = None,
          config: Optional[Dict[str, Any]] = None,
          generated_by: str = "attribution",
          top_fusions: int = 40) -> Dict[str, Any]:
    """Assemble the schema-versioned attribution document.

    ``rows`` carry at least {name, events, ns} (``measured_fusion_rows``
    adds flops/bytes/label; synthetic tests can hand-build them).  The
    residue is every row whose individual share of device-busy time is
    below ``residue_share_threshold``, grouped by label and ranked by
    total time — deterministically (ties break on the label/name)."""
    rows = [dict(r) for r in rows]
    steps = max(1, int(steps))
    for r in rows:
        r.setdefault("events", steps)
        r.setdefault("ns_per_step", r["ns"] / steps)
        r.setdefault("label", classify_label(r.get("op_name", ""),
                                             r.get("name", "")))
        r.setdefault("key", stable_key(r.get("op_name", ""),
                                       r.get("name", "")))
        _place_row(r, peak_flops, peak_hbm_bytes_per_s)
    rows.sort(key=lambda r: (-r["ns"], r["name"]))
    busy_ns = sum(r["ns"] for r in rows)
    for r in rows:
        r["share_of_busy"] = (round(r["ns"] / busy_ns, 6)
                              if busy_ns > 0 else 0.0)
    busy_ms_per_step = busy_ns / 1e6 / steps

    gap_ms = gap_share = None
    if wall_ms_per_step is not None and wall_ms_per_step > 0:
        gap_ms = max(0.0, wall_ms_per_step - busy_ms_per_step)
        gap_share = _frac(gap_ms / wall_ms_per_step)

    # whole-step placement from the executable's cost_analysis totals
    busy_s = busy_ns / 1e9 / steps
    ridge = (peak_flops / peak_hbm_bytes_per_s
             if peak_hbm_bytes_per_s else None)
    step_doc: Dict[str, Any] = {
        "flops": step_flops, "bytes_accessed": step_bytes,
        "intensity": (round(step_flops / step_bytes, 4)
                      if step_flops and step_bytes else None),
    }
    if step_flops and busy_s > 0:
        step_doc["mfu_vs_busy"] = _frac(step_flops / busy_s / peak_flops)
    if step_flops and wall_ms_per_step:
        step_doc["mfu"] = _frac(
            step_flops / (wall_ms_per_step / 1e3) / peak_flops)
    if step_bytes and busy_s > 0 and peak_hbm_bytes_per_s:
        step_doc["hbm_fraction"] = _frac(
            step_bytes / busy_s / peak_hbm_bytes_per_s)
    if step_doc["intensity"] is not None and ridge is not None:
        step_doc["bound"] = ("compute" if step_doc["intensity"] >= ridge
                             else "hbm")

    # residue: the small-op tail (each row individually under the
    # threshold share), grouped by label, ranked by aggregate time
    residue_rows = [r for r in rows
                    if busy_ns > 0
                    and r["ns"] / busy_ns < residue_share_threshold]
    groups: Dict[str, Dict[str, Any]] = {}
    for r in residue_rows:
        g = groups.setdefault(r["label"], {
            "label": r["label"], "ns": 0.0, "events": 0, "ops": []})
        g["ns"] += r["ns"]
        g["events"] += r["events"]
        g["ops"].append((r["ns"], r["name"]))
    group_rows = []
    for g in groups.values():
        g["ops"].sort(key=lambda t: (-t[0], t[1]))
        group_rows.append({
            "label": g["label"],
            "ns_per_step": round(g["ns"] / steps, 1),
            "ms_per_step": round(g["ns"] / 1e6 / steps, 6),
            "events_per_step": round(g["events"] / steps, 2),
            "share_of_busy": (round(g["ns"] / busy_ns, 6)
                              if busy_ns > 0 else 0.0),
            "top_ops": [name for _ns, name in g["ops"][:5]],
        })
    group_rows.sort(key=lambda g: (-g["ns_per_step"], g["label"]))
    residue_ns = sum(r["ns"] for r in residue_rows)

    # run-stable fusion groups (the sentinel's tracking unit): aggregate
    # ALL rows by stable key — instruction numbering shifts across
    # processes, the scope-path key does not
    fgroups: Dict[str, Dict[str, Any]] = {}
    for r in rows:
        g = fgroups.setdefault(r["key"], {
            "key": r["key"], "label": r["label"], "ns": 0.0,
            "events": 0, "rows": 0})
        g["ns"] += r["ns"]
        g["events"] += r["events"]
        g["rows"] += 1
    fusion_groups = sorted(
        ({"key": g["key"], "label": g["label"],
          "ms_per_step": round(g["ns"] / 1e6 / steps, 6),
          "events_per_step": round(g["events"] / steps, 2),
          "rows": g["rows"],
          "share_of_busy": (round(g["ns"] / busy_ns, 6)
                            if busy_ns > 0 else 0.0)}
         for g in fgroups.values()),
        key=lambda g: (-g["ms_per_step"], g["key"]))

    def _round_row(r: Dict[str, Any]) -> Dict[str, Any]:
        out = {k: r.get(k) for k in (
            "name", "key", "label", "events", "op_name", "flops", "bytes",
            "intensity", "bound", "compute_fraction", "hbm_fraction",
            "roofline_fraction", "roofline_fraction_raw",
            "share_of_busy")}
        out["ms_per_step"] = round(r["ns_per_step"] / 1e6, 6)
        for k in ("achieved_flops_per_s", "achieved_bytes_per_s"):
            v = r.get(k)
            out[k] = round(v, 1) if v is not None else None
        if out["op_name"]:
            out["op_name"] = out["op_name"][-120:]
        return out

    doc: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "generated_by": generated_by,
        "generated_at": round(time.time(), 1),
        "mode": mode,
        "spec": spec,
        "steps": steps,
        "wall_ms_per_step": (round(wall_ms_per_step, 6)
                             if wall_ms_per_step is not None else None),
        "device_busy_ms_per_step": round(busy_ms_per_step, 6),
        "gap_ms_per_step": (round(gap_ms, 6)
                            if gap_ms is not None else None),
        "gap_share": gap_share,
        "peak": {
            "bf16_flops_per_s": peak_flops,
            "hbm_bytes_per_s": peak_hbm_bytes_per_s,
            "ridge_intensity": (round(ridge, 2)
                                if ridge is not None else None),
        },
        "step": step_doc,
        "fusions": [_round_row(r) for r in rows[:top_fusions]],
        "fusion_groups": fusion_groups[:100],
        "fusion_count": len(rows),
        "residue": {
            "threshold_share": residue_share_threshold,
            "count": len(residue_rows),
            "ms_per_step": round(residue_ns / 1e6 / steps, 6),
            "share_of_busy": (round(residue_ns / busy_ns, 6)
                              if busy_ns > 0 else 0.0),
            "groups": group_rows,
        },
    }
    if programs:
        doc["programs"] = [
            {k: p.get(k) for k in ("program", "flops", "bytes_accessed",
                                   "compile_ms", "cache")}
            for p in programs]
    if config:
        doc["config"] = dict(config)
    # recompile-cause snapshot for the sentinel's cause attribution
    try:
        from . import metrics as _metrics

        snap = _metrics.default_registry().snapshot()
        doc["recompiles"] = {
            s["labels"][0]: s["value"] for s in
            snap.get("paddle_recompiles_total", {}).get("series", [])}
    except Exception:
        doc["recompiles"] = {}
    return doc


def peaks(device) -> Tuple[float, float]:
    """(bf16 FLOP/s, HBM bytes/s) of ``device``: the card's row of
    ``hw.PEAKS`` on CUDA (raising for a card the table lacks), the
    reference's fallback denominators on the CPU."""
    import torch

    from . import hw

    dev = torch.device(device)
    if dev.type != "cuda":
        return _FALLBACK_FLOPS, _FALLBACK_HBM_BPS
    row = hw.peaks_for(torch.cuda.get_device_name(dev))
    return row["bf16_flops_per_s"], row["hbm_bytes_per_s"]


def build_from_trace(trace_dir: str, steps: int,
                     wall_ms_per_step: Optional[float] = None,
                     costs=None, device=None,
                     rows: Optional[List[Dict[str, Any]]] = None,
                     **kw) -> Dict[str, Any]:
    """measured_kernel_rows (or the ``rows`` a caller measured already) +
    peak tables + build, stamped with the device (``degraded: true`` off
    the card — a CPU trace validates the mechanism, not the numbers)."""
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if rows is None:
        rows = measured_kernel_rows(trace_dir, steps=steps, costs=costs)
    peak_flops, peak_bw = peaks(dev)
    doc = build(rows, steps=steps, wall_ms_per_step=wall_ms_per_step,
                peak_flops=peak_flops, peak_hbm_bytes_per_s=peak_bw, **kw)
    doc["source"] = rows[0]["source"] if rows else None
    doc["backend"] = "gpu" if dev.type == "cuda" else dev.type
    doc["device_kind"] = (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")
    doc["degraded"] = dev.type != "cuda"
    return doc


# ---------------------------------------------------------------------------
# Schema gate + sink
# ---------------------------------------------------------------------------

_FRACTION_KEYS = ("share_of_busy", "gap_share", "compute_fraction",
                  "hbm_fraction", "roofline_fraction", "mfu",
                  "mfu_vs_busy")


def validate(doc: Dict[str, Any], require_residue: bool = False) -> None:
    """The metrics_check gate: schema version, finite numeric values,
    roofline fractions in [0, 1], residue present when required.  Raises
    ``AssertionError`` naming the offending field."""
    assert doc.get("schema_version") == SCHEMA_VERSION, \
        f"schema_version {doc.get('schema_version')!r}"
    assert doc.get("mode") in ("train", "decode"), doc.get("mode")

    def _walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                _walk(v, f"{path}.{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                _walk(v, f"{path}[{i}]")
        elif isinstance(obj, float):
            assert math.isfinite(obj), f"non-finite value at {path}"

    _walk(doc, "attribution")
    for row in [doc] + list(doc.get("fusions", ())) \
            + [doc.get("step", {})] + list(
                doc.get("residue", {}).get("groups", ())):
        for k in _FRACTION_KEYS:
            v = row.get(k)
            if v is not None:
                assert 0.0 <= v <= 1.0, f"{k}={v!r} outside [0,1]"
    assert doc.get("fusions"), "attribution carries no fusion rows"
    res = doc.get("residue") or {}
    assert 0.0 <= res.get("share_of_busy", 0.0) <= 1.0, res
    if require_residue:
        assert res.get("count", 0) > 0 and res.get("groups"), \
            "residue list is empty (the small-op tail must be non-empty " \
            "on a transformer step)"


def write(doc: Dict[str, Any], path: str) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path
