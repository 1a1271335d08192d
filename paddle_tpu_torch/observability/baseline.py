"""Perf regression sentinel: every run diffed against a baseline — the
port of ``paddle_tpu/observability/baseline.py``, copied whole: the same
artifacts give the same verdict in both packages.

The sentinel compares a run's artifacts — ``ATTRIBUTION.json``
(observability/attribution.py), goodput reports, TrainMonitor JSONL
rollups, the dispatch/comm/serve bench headline fields, program-report
flops/bytes/compile-ms — against a baseline document with per-metric
tolerance bands, and **attributes** each out-of-band metric to a cause (a
config lever changed, a goodput category grew, a named program's
bytes/compile-ms moved, a new recompile cause appeared, a named kernel
group got slower, the residue share went up).

Band policy by metric *kind*:

  =========  =============================  =========================
  kind       meaning                        default band
  =========  =============================  =========================
  timing     machine/load dependent         rel 25% (both directions
                                            gated by ``direction``)
  static     deterministic counted facts    rel 2% (flops, bytes,
                                            wire-byte ratios)
  count      discrete but config-coupled    rel 50%
  exact      must match exactly             equality
  flag       booleans / strings             equality
  =========  =============================  =========================

``degraded: true`` baselines (a CPU lane) demote every *timing* and
*count* metric to a STRUCTURAL check: present and finite, nothing else.
Static facts, exacts and flags keep their bands — a CPU run still proves
the counted facts, it just cannot time anything. The port's attribution
calls its rows ``fusions`` / ``fusion_groups`` as the reference's schema
does: a row there is a (launch scope, kernel) pair.
``paddle_tpu_torch/tools/perf_diff.py`` is the CLI;
``paddle_tpu_torch/tools/goodput_report.py --diff`` reuses
:func:`compare_goodput`.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

BASELINE_SCHEMA_VERSION = 1

__all__ = [
    "BASELINE_SCHEMA_VERSION", "DEFAULT_POLICY", "collect_metrics",
    "make_baseline", "compare", "compare_goodput", "load_json",
    "load_artifacts",
]

# per-kind default tolerances; a baseline may override per metric
DEFAULT_POLICY: Dict[str, Dict[str, float]] = {
    "timing": {"tol_rel": 0.25, "tol_abs": 0.0},
    "static": {"tol_rel": 0.02, "tol_abs": 0.0},
    "count": {"tol_rel": 0.50, "tol_abs": 0.5},
    "exact": {},
    "flag": {},
}

# how many named fusions ride into the baseline as individual metrics
_TOP_FUSIONS = 12


def _metric(value, kind: str, direction: str = "both") -> Dict[str, Any]:
    return {"value": value, "kind": kind, "direction": direction}


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


# ---------------------------------------------------------------------------
# Artifact -> metrics + context
# ---------------------------------------------------------------------------

def _collect_attribution(doc: Dict[str, Any], metrics, ctx) -> None:
    metrics["attribution.schema_version"] = _metric(
        doc.get("schema_version"), "exact")
    for name, kind, direction in (
            ("wall_ms_per_step", "timing", "higher_worse"),
            ("device_busy_ms_per_step", "timing", "higher_worse"),
            ("gap_share", "timing", "higher_worse"),
            ("fusion_count", "count", "both")):
        v = doc.get(name)
        if v is not None:
            metrics[f"attribution.{name}"] = _metric(v, kind, direction)
    step = doc.get("step") or {}
    for name, kind, direction in (
            ("flops", "static", "both"),
            ("bytes_accessed", "static", "both"),
            ("mfu", "timing", "lower_worse")):
        v = step.get(name)
        if v is not None:
            metrics[f"attribution.step.{name}"] = _metric(
                v, kind, direction)
    res = doc.get("residue") or {}
    if res.get("share_of_busy") is not None:
        metrics["attribution.residue.share_of_busy"] = _metric(
            res["share_of_busy"], "timing", "higher_worse")
    if res.get("count") is not None:
        metrics["attribution.residue.count"] = _metric(
            res["count"], "count", "both")
    # fusion tracking rides the run-stable GROUPS (scope-path keys —
    # raw HLO instruction numbering shifts across processes): a metric
    # per group; the baseline trims to its top-N, but the current run
    # exports every group so a baseline fusion always resolves
    fusions = {g["key"]: g for g in doc.get("fusion_groups", ())}
    for g in doc.get("fusion_groups", ()):
        metrics[f"attribution.fusion.{g['key']}.ms_per_step"] = _metric(
            g.get("ms_per_step"), "timing", "higher_worse")
    for k, v in (doc.get("config") or {}).items():
        metrics[f"config.{k}"] = _metric(v, "flag")
    ctx["fusions"] = {n: {"ms_per_step": g.get("ms_per_step"),
                          "share_of_busy": g.get("share_of_busy"),
                          "label": g.get("label")}
                      for n, g in fusions.items()}
    ctx["residue_groups"] = {
        g["label"]: g.get("share_of_busy")
        for g in res.get("groups", ())}
    ctx["recompiles"] = dict(doc.get("recompiles") or {})
    ctx["config"] = dict(doc.get("config") or {})
    for p in doc.get("programs", ()):
        _collect_program(p, metrics, ctx)


def _collect_program(rec: Dict[str, Any], metrics, ctx) -> None:
    name = rec.get("program")
    if not name:
        return
    progs = ctx.setdefault("programs", {})
    progs[name] = {k: rec.get(k)
                   for k in ("flops", "bytes_accessed", "compile_ms")}
    for field, kind, direction in (("flops", "static", "both"),
                                   ("bytes_accessed", "static", "both"),
                                   ("compile_ms", "timing",
                                    "higher_worse")):
        v = rec.get(field)
        if v is not None:
            metrics[f"program.{name}.{field}"] = _metric(
                v, kind, direction)


def _collect_goodput(doc: Dict[str, Any], metrics, ctx) -> None:
    cats = doc.get("categories") or {}
    wall = doc.get("wall_s") or 0.0
    shares = {c: (v / wall if wall > 0 else 0.0) for c, v in cats.items()}
    ctx["goodput_shares"] = {c: round(s, 6) for c, s in shares.items()}
    for c, s in shares.items():
        metrics[f"goodput.share.{c}"] = _metric(
            round(s, 6), "timing",
            "lower_worse" if c == "productive_step" else "higher_worse")
    frac = doc.get("gang_goodput_fraction", doc.get("goodput_fraction"))
    if frac is not None:
        metrics["goodput.fraction"] = _metric(frac, "timing",
                                              "lower_worse")


def _collect_monitor(records: List[Dict[str, Any]], metrics, ctx) -> None:
    if not records:
        return
    times = sorted(r.get("step_time_ms", 0.0) for r in records)
    p50 = times[len(times) // 2]
    mfus = [r["mfu"] for r in records if _finite(r.get("mfu"))]
    metrics["monitor.steps"] = _metric(len(records), "count", "both")
    metrics["monitor.p50_step_time_ms"] = _metric(
        round(p50, 3), "timing", "higher_worse")
    if mfus:
        metrics["monitor.mfu_mean"] = _metric(
            round(sum(mfus) / len(mfus), 6), "timing", "lower_worse")
    metrics["monitor.nan_steps"] = _metric(
        sum(1 for r in records if r.get("nan_inf")), "exact",
        "higher_worse")


def _collect_dispatch(doc: Dict[str, Any], metrics, ctx) -> None:
    for name, direction in (("fast_us_per_step", "higher_worse"),
                            ("slow_us_per_step", "higher_worse"),
                            ("speedup_overhead", "lower_worse"),
                            ("metrics_overhead_pct", "higher_worse"),
                            ("tracing_overhead_pct", "higher_worse")):
        v = doc.get(name)
        if _finite(v):
            metrics[f"dispatch.{name}"] = _metric(v, "timing", direction)


def _collect_comm(doc: Dict[str, Any], metrics, ctx) -> None:
    for k, v in (doc.get("summary") or {}).items():
        if isinstance(v, bool):
            metrics[f"comm.{k}"] = _metric(v, "flag")
        elif _finite(v):
            # wire-byte ratios are ring-model arithmetic — deterministic
            metrics[f"comm.{k}"] = _metric(v, "static", "both")


def _lane_key(lane: Dict[str, Any]) -> str:
    parts = [str(lane.get("weight_dtype", "?")),
             str(lane.get("kv_layout", "?"))]
    if lane.get("sharding"):
        parts.append(f"tp{lane.get('tp')}")
    if lane.get("spec"):
        parts.append(f"spec{lane.get('spec')}")
    if lane.get("sampled"):
        parts.append("sampled")
    parts.append(f"r{lane.get('rate_rps')}")
    return ",".join(parts)


def _collect_serve(doc: Dict[str, Any], metrics, ctx) -> None:
    if doc.get("steady_state_recompiles") is not None:
        metrics["serve.steady_state_recompiles"] = _metric(
            doc["steady_state_recompiles"], "exact", "higher_worse")
    for flag in ("zero_recompile_pass", "int8_pass", "engine_parity_pass"):
        if flag in doc:
            metrics[f"serve.{flag}"] = _metric(bool(doc[flag]), "flag")
    for lane in doc.get("load", ()):
        key = _lane_key(lane)
        ttft = (lane.get("ttft_ms") or {}).get("p99")
        if _finite(ttft):
            metrics[f"serve.lane[{key}].ttft_p99_ms"] = _metric(
                ttft, "timing", "higher_worse")
        tps = lane.get("tokens_per_s_per_chip")
        if _finite(tps):
            metrics[f"serve.lane[{key}].tokens_per_s_per_chip"] = _metric(
                tps, "timing", "lower_worse")


def _collect_bench(doc: Dict[str, Any], metrics, ctx) -> None:
    if _finite(doc.get("value")):
        metrics["bench.value"] = _metric(doc["value"], "timing",
                                         "lower_worse")
    if _finite(doc.get("vs_baseline")):
        metrics["bench.mfu"] = _metric(doc["vs_baseline"], "timing",
                                       "lower_worse")
    if "degraded" in doc:
        metrics["bench.degraded"] = _metric(bool(doc["degraded"]), "flag")


def collect_metrics(artifacts: Dict[str, Any]
                    ) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, Any]]:
    """Flatten a run's artifacts into ``{metric_name: {value, kind,
    direction}}`` plus the cause-attribution context (fusion table,
    goodput shares, program table, recompile causes, config levers)."""
    metrics: Dict[str, Dict[str, Any]] = {}
    ctx: Dict[str, Any] = {}
    collectors = (
        ("attribution", _collect_attribution),
        ("goodput", _collect_goodput),
        ("monitor", _collect_monitor),
        ("dispatch", _collect_dispatch),
        ("comm", _collect_comm),
        ("serve", _collect_serve),
        ("bench", _collect_bench),
    )
    for name, fn in collectors:
        doc = artifacts.get(name)
        if doc:
            fn(doc, metrics, ctx)
    for rec in artifacts.get("programs", ()) or ():
        _collect_program(rec, metrics, ctx)
    ctx["artifacts"] = sorted(k for k, v in artifacts.items() if v)
    return metrics, ctx


# ---------------------------------------------------------------------------
# Baseline make / compare
# ---------------------------------------------------------------------------

def make_baseline(artifacts: Dict[str, Any], lane: str = "cpu_smoke",
                  degraded: Optional[bool] = None,
                  policy: Optional[Dict[str, Dict[str, float]]] = None,
                  notes: str = "") -> Dict[str, Any]:
    """Build a committed-baseline document from a run's artifacts."""
    metrics, ctx = collect_metrics(artifacts)
    att = artifacts.get("attribution") or {}
    # the baseline pins only the top-N fusion groups by measured time — a
    # long tail of sub-threshold rows would turn timing noise into churn
    keep = {f"attribution.fusion.{g['key']}.ms_per_step"
            for g in list(att.get("fusion_groups", ()))[:_TOP_FUSIONS]}
    metrics = {k: v for k, v in metrics.items()
               if not k.startswith("attribution.fusion.") or k in keep}
    if degraded is None:
        degraded = bool(att.get("degraded", lane != "tpu"))
    return {
        "schema_version": BASELINE_SCHEMA_VERSION,
        "created_at": round(time.time(), 1),
        "lane": lane,
        "degraded": bool(degraded),
        "notes": notes,
        "band_policy": policy or DEFAULT_POLICY,
        "metrics": metrics,
        "context": ctx,
    }


def _band_for(name: str, base_m: Dict[str, Any],
              policy: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    kind = base_m.get("kind", "timing")
    band = dict(policy.get(kind, DEFAULT_POLICY.get(kind, {})))
    for k in ("tol_rel", "tol_abs"):       # per-metric override wins
        if k in base_m:
            band[k] = base_m[k]
    return band


def _check_metric(name: str, cur_v, base_m: Dict[str, Any],
                  policy, degraded: bool) -> Optional[Dict[str, Any]]:
    """None when in band; an out-of-band/structural record otherwise."""
    kind = base_m.get("kind", "timing")
    base_v = base_m.get("value")
    direction = base_m.get("direction", "both")
    if kind in ("flag", "exact"):
        if cur_v != base_v:
            return {"metric": name, "kind": kind, "value": cur_v,
                    "baseline": base_v, "check": "equality"}
        return None
    if not _finite(cur_v):
        return {"metric": name, "kind": kind, "value": cur_v,
                "baseline": base_v, "check": "structural",
                "detail": "value missing or non-finite"}
    if degraded and kind in ("timing", "count"):
        return None          # structural only on the degraded lane
    if not _finite(base_v):
        return None
    band = _band_for(name, base_m, policy)
    width = band.get("tol_rel", 0.0) * abs(base_v) \
        + band.get("tol_abs", 0.0)
    delta = cur_v - base_v
    worse = (delta > width if direction == "higher_worse"
             else delta < -width if direction == "lower_worse"
             else abs(delta) > width)
    if worse:
        return {"metric": name, "kind": kind, "value": cur_v,
                "baseline": base_v, "band": round(width, 9),
                "delta": round(delta, 9), "direction": direction,
                "check": "band"}
    return None


def _config_changes(cur_ctx, base_ctx) -> List[Dict[str, Any]]:
    cur = cur_ctx.get("config") or {}
    base = base_ctx.get("config") or {}
    out = []
    for k in sorted(set(cur) | set(base)):
        if cur.get(k) != base.get(k):
            out.append({"lever": k, "baseline": base.get(k),
                        "value": cur.get(k)})
    return out


def _cause_evidence(cur_ctx: Dict[str, Any], base_ctx: Dict[str, Any],
                    degraded: bool) -> List[Dict[str, Any]]:
    """Rank everything that moved between the two runs' contexts — the
    evidence pool out-of-band metrics get attributed to."""
    ev: List[Dict[str, Any]] = []
    for ch in _config_changes(cur_ctx, base_ctx):
        ev.append({"kind": "config_lever", "magnitude": float("inf"),
                   "detail": f"config lever {ch['lever']}: "
                             f"{ch['baseline']!r} -> {ch['value']!r}"})
    # goodput: which category grew?
    cur_gp = cur_ctx.get("goodput_shares") or {}
    base_gp = base_ctx.get("goodput_shares") or {}
    for c in sorted(set(cur_gp) | set(base_gp)):
        if c == "productive_step":
            continue
        d = cur_gp.get(c, 0.0) - base_gp.get(c, 0.0)
        if d > 0.02:
            ev.append({"kind": "goodput_category", "magnitude": d,
                       "detail": f"goodput category {c!r} grew "
                                 f"{base_gp.get(c, 0.0):.3f} -> "
                                 f"{cur_gp.get(c, 0.0):.3f} of wall"})
    # program reports: a specific executable's static facts moved
    cur_p = cur_ctx.get("programs") or {}
    base_p = base_ctx.get("programs") or {}
    for p in sorted(set(cur_p) & set(base_p)):
        for field in ("flops", "bytes_accessed", "compile_ms"):
            if field == "compile_ms" and degraded:
                continue
            a, b = base_p[p].get(field), cur_p[p].get(field)
            if _finite(a) and _finite(b) and a:
                rel = (b - a) / abs(a)
                tol = 0.05 if field != "compile_ms" else 0.5
                if abs(rel) > tol:
                    ev.append({
                        "kind": "program", "magnitude": abs(rel),
                        "detail": f"executable {p!r} {field} moved "
                                  f"{a:.6g} -> {b:.6g} "
                                  f"({rel:+.1%})"})
    new_progs = sorted(set(cur_p) - set(base_p))
    gone_progs = sorted(set(base_p) - set(cur_p))
    if new_progs or gone_progs:
        ev.append({"kind": "program_set", "magnitude": float(
            len(new_progs) + len(gone_progs)),
            "detail": f"executable set changed (+{new_progs} "
                      f"-{gone_progs})"})
    # recompile explainer: a cause that did not exist at baseline
    cur_rc = cur_ctx.get("recompiles") or {}
    base_rc = base_ctx.get("recompiles") or {}
    for c in sorted(set(cur_rc) - set(base_rc)):
        ev.append({"kind": "recompile_cause",
                   "magnitude": float(cur_rc[c]),
                   "detail": f"new recompile cause {c!r} "
                             f"(x{cur_rc[c]:.0f})"})
    # named fusions slower / fusion set changed
    cur_f = cur_ctx.get("fusions") or {}
    base_f = base_ctx.get("fusions") or {}
    if not degraded:
        for n in sorted(set(cur_f) & set(base_f)):
            a = base_f[n].get("ms_per_step")
            b = cur_f[n].get("ms_per_step")
            if _finite(a) and _finite(b) and a and (b - a) / a > 0.25:
                ev.append({"kind": "fusion", "magnitude": (b - a) / a,
                           "detail": f"fusion {n!r} "
                                     f"({base_f[n].get('label')}) slower "
                                     f"{a:.3f} -> {b:.3f} ms/step"})
    new_f = sorted(set(cur_f) - set(base_f))
    gone_f = sorted(set(base_f) - set(cur_f))
    if new_f or gone_f:
        ev.append({"kind": "fusion_set",
                   "magnitude": float(len(new_f) + len(gone_f)),
                   "detail": f"fusion set changed (+{len(new_f)} "
                             f"-{len(gone_f)}; new e.g. {new_f[:3]})"})
    # residue share
    cur_rg = cur_ctx.get("residue_groups") or {}
    base_rg = base_ctx.get("residue_groups") or {}
    d = sum(v for v in cur_rg.values() if v) \
        - sum(v for v in base_rg.values() if v)
    if d > 0.02:
        ev.append({"kind": "residue_share", "magnitude": d,
                   "detail": f"residue share up {d:+.3f} "
                             f"(groups now {sorted(cur_rg)})"})
    ev.sort(key=lambda e: -e["magnitude"])
    return ev


def _metric_specific_cause(name: str) -> Optional[Dict[str, str]]:
    if name.startswith("attribution.fusion."):
        fusion = name[len("attribution.fusion."):].rsplit(".", 1)[0]
        return {"kind": "fusion", "detail": f"fusion {fusion!r} itself"}
    if name.startswith("goodput.share."):
        return {"kind": "goodput_category",
                "detail": f"goodput category "
                          f"{name[len('goodput.share.'):]!r} itself"}
    if name.startswith("program."):
        prog = name[len("program."):].rsplit(".", 1)[0]
        return {"kind": "program", "detail": f"executable {prog!r} itself"}
    if name.startswith("config."):
        return {"kind": "config_lever",
                "detail": f"lever {name[len('config.'):]!r} itself"}
    return None


def compare(artifacts: Dict[str, Any], baseline: Dict[str, Any],
            out_path: Optional[str] = None) -> Dict[str, Any]:
    """Diff a run's artifacts against a baseline; returns (and optionally
    writes) the REGRESSION.json report.  ``report["ok"]`` is the gate."""
    policy = baseline.get("band_policy") or DEFAULT_POLICY
    degraded = bool(baseline.get("degraded"))
    cur_metrics, cur_ctx = collect_metrics(artifacts)
    base_metrics = baseline.get("metrics") or {}
    base_ctx = baseline.get("context") or {}

    out_of_band: List[Dict[str, Any]] = []
    structural: List[Dict[str, Any]] = []
    missing: List[str] = []
    checked = 0
    cur_artifacts = {k for k, v in artifacts.items() if v}
    for name in sorted(base_metrics):
        src = name.split(".", 1)[0]
        artifact_of = {"attribution": "attribution", "config":
                       "attribution", "goodput": "goodput",
                       "monitor": "monitor", "dispatch": "dispatch",
                       "comm": "comm", "serve": "serve",
                       "bench": "bench"}.get(src)
        if artifact_of and artifact_of not in cur_artifacts:
            missing.append(name)   # whole artifact absent: skip its rows
            continue
        if src == "program" and "attribution" not in cur_artifacts \
                and not artifacts.get("programs"):
            missing.append(name)
            continue
        checked += 1
        cur_v = (cur_metrics.get(name) or {}).get("value")
        bad = _check_metric(name, cur_v, base_metrics[name], policy,
                            degraded)
        if bad is None:
            continue
        if bad.get("check") in ("structural", "equality"):
            structural.append(bad)
        else:
            out_of_band.append(bad)

    evidence = _cause_evidence(cur_ctx, base_ctx, degraded)
    config_changes = _config_changes(cur_ctx, base_ctx)
    for bad in out_of_band + structural:
        specific = _metric_specific_cause(bad["metric"])
        causes = ([{"kind": e["kind"], "detail": e["detail"]}
                   for e in evidence[:5]])
        if specific and not config_changes:
            causes.insert(0, specific)
        bad["cause"] = causes[0] if causes else {
            "kind": "unknown",
            "detail": "no correlated artifact movement found"}
        if len(causes) > 1:
            bad["evidence"] = causes[1:]

    new_metrics = sorted(set(cur_metrics) - set(base_metrics))
    report = {
        "schema_version": BASELINE_SCHEMA_VERSION,
        "generated_at": round(time.time(), 1),
        "baseline_lane": baseline.get("lane"),
        "degraded": degraded,
        "checked": checked,
        "out_of_band": out_of_band,
        "structural_failures": structural,
        "config_changes": config_changes,
        "skipped_missing_artifact": missing,
        "new_metrics": new_metrics[:40],
        "ok": not out_of_band and not structural,
    }
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, out_path)
        report["path"] = out_path
    return report


# ---------------------------------------------------------------------------
# Goodput diff (tools/goodput_report.py --diff)
# ---------------------------------------------------------------------------

def compare_goodput(a: Dict[str, Any], b: Dict[str, Any],
                    tol_rel: float = 0.25,
                    tol_abs_share: float = 0.02) -> Dict[str, Any]:
    """Per-category goodput delta between two reports (rank windows or
    gang GOODPUT.json — both carry ``categories`` + ``wall_s``), using
    the sentinel's band arithmetic on wall-share: a category is
    out-of-band when its share moved more than
    ``tol_rel * baseline_share + tol_abs_share`` in the worse direction
    (productive_step down, everything else up)."""
    wall_a, wall_b = a.get("wall_s") or 0.0, b.get("wall_s") or 0.0
    cats = sorted(set(a.get("categories") or {})
                  | set(b.get("categories") or {}))
    rows = []
    n_bad = 0
    for c in cats:
        sa = (a.get("categories", {}).get(c, 0.0) / wall_a
              if wall_a > 0 else 0.0)
        sb = (b.get("categories", {}).get(c, 0.0) / wall_b
              if wall_b > 0 else 0.0)
        width = tol_rel * sa + tol_abs_share
        delta = sb - sa
        worse = (delta < -width if c == "productive_step"
                 else delta > width)
        n_bad += bool(worse)
        rows.append({"category": c, "share_a": round(sa, 6),
                     "share_b": round(sb, 6),
                     "delta_share": round(delta, 6),
                     "seconds_a": round(
                         a.get("categories", {}).get(c, 0.0), 6),
                     "seconds_b": round(
                         b.get("categories", {}).get(c, 0.0), 6),
                     "band": round(width, 6),
                     "out_of_band": bool(worse)})
    rows.sort(key=lambda r: -abs(r["delta_share"]))
    return {"wall_s_a": round(wall_a, 6), "wall_s_b": round(wall_b, 6),
            "rows": rows, "out_of_band": n_bad, "ok": n_bad == 0}


# ---------------------------------------------------------------------------
# Artifact loading (shared by the CLIs)
# ---------------------------------------------------------------------------

def load_json(path: Optional[str]) -> Optional[Dict[str, Any]]:
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _load_jsonl(path: Optional[str]) -> Optional[List[Dict[str, Any]]]:
    if not path or not os.path.exists(path):
        return None
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    return out


def load_artifacts(attribution: Optional[str] = None,
                   goodput: Optional[str] = None,
                   monitor: Optional[str] = None,
                   dispatch: Optional[str] = None,
                   comm: Optional[str] = None,
                   serve: Optional[str] = None,
                   bench: Optional[str] = None,
                   programs: Sequence[str] = ()) -> Dict[str, Any]:
    """Load whatever artifact files exist; absent paths load as None and
    their baseline sections are skipped (listed, not failed)."""
    bench_doc = load_json(bench)
    if bench_doc and "value" not in bench_doc and "result" in bench_doc:
        bench_doc = bench_doc["result"]     # driver-wrapped headline
    prog_records: List[Dict[str, Any]] = []
    for p in programs:
        prog_records.extend(_load_jsonl(p) or [])
    return {
        "attribution": load_json(attribution),
        "goodput": load_json(goodput),
        "monitor": _load_jsonl(monitor),
        "dispatch": load_json(dispatch),
        "comm": load_json(comm),
        "serve": load_json(serve),
        "bench": bench_doc,
        "programs": prog_records or None,
    }
