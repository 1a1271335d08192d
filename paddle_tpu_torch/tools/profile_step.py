"""Measured device-time breakdown and roofline attribution of a train step
or a decode tick — the port of the JAX package's ``tools/profile_step.py``.

Train mode captures ``torch.profiler`` over N steps of the GPT train step
(``parallelize.make_train_step``) and writes:

- ``PROFILE_STEP.json``: device ms a step by kernel family (the base name
  of each kernel, a port kernel by its ``KERNELS`` entry);
- ``ATTRIBUTION.json`` (``observability/attribution.py``): every (launch
  scope, kernel) row placed on the roofline against the card's peaks,
  the gap share, the ranked small-kernel residue, the step's counted
  FLOPs from its program report.

With no spec on the card it profiles ``train_bench``'s 7b configuration:
GPT_SMALL at batch 16 x 1024, bf16, flash, ``dots`` remat, fused LN,
vocab-chunked CE (chunk 1024) and the flat ``adamw_mask`` sweep — every
training kernel. A spec (the reference's grammar, keys ``d L nh ff b T
vocab steps remat celim fln fopt``) builds ``GPT_SMALL.scaled(...)``;
``--smoke`` is the reference's ``SMOKE_SPEC`` on the CPU.

``--serve`` profiles the decode tick of a warmed GPT_SMALL bf16 engine
(8 slots by default, every one holding a seeded prompt): ``--kv-layout``,
``--weight-dtype``, ``--max-batch``, ``--fused-decode`` / ``--no-fused-
decode``; ``--disagg --role`` only stamps the attribution's ``config``.
``--compare A B`` residue-diffs two attribution documents.

    python -m paddle_tpu_torch.tools.profile_step [SPEC] [--steps 6]
        [--dir perf_runs] [--attr-out PATH] [--device cuda|cpu]
    python -m paddle_tpu_torch.tools.profile_step --smoke
    python -m paddle_tpu_torch.tools.profile_step --serve [--ticks 16]
        [--kv-layout paged] [--weight-dtype bf16] [--max-batch 8]
        [--disagg --role decode]
    python -m paddle_tpu_torch.tools.profile_step --compare A.json B.json

Files go under ``--dir`` (default ``perf_runs``: the trace under
``<dir>/trace``, ``ATTRIBUTION.json`` or ``ATTRIBUTION_DECODE.json`` and
``PROFILE_STEP.json`` beside it) or to ``--attr-out``; never to the
repository root, whose files are the JAX package's. The default device is
the card (raising without one); ``--smoke`` and ``--device cpu`` run on
the CPU, where the document is ``degraded``: the mechanism, not device
numbers. ``--tuned`` waits for the ``tuning/`` port (ROADMAP A4).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

SMOKE_SPEC = "d=32,L=2,nh=2,ff=64,b=2,T=16,vocab=512,steps=3"
SPEC_KEYS = ("d", "L", "nh", "ff", "b", "T", "vocab", "steps", "remat",
             "celim", "fln", "fopt")
GENERATED_BY = "paddle_tpu_torch/tools/profile_step.py"


def parse_spec(spec_str: Optional[str]) -> Tuple[Any, Dict[str, Any]]:
    """(GPTConfig, run knobs {batch, T, steps, fused_opt, fused_ln}) of a
    spec; None is ``train_bench``'s 7b configuration. Unknown keys
    raise."""
    from ..models import gpt as G
    from . import train_bench as TB

    if spec_str is None:
        cfg = TB.bench_config("dots", fused_ln=True, ce_vchunk=1024)
        return cfg, {"batch": TB.BATCH, "T": TB.SEQ, "steps": None,
                     "fused_opt": True}
    spec = dict(kv.split("=") for kv in spec_str.split(","))
    unknown = set(spec) - set(SPEC_KEYS)
    if unknown:
        raise SystemExit(f"profile_step: unknown spec keys "
                         f"{sorted(unknown)}")
    T = int(spec.get("T", 1024))
    d = int(spec.get("d", 768))
    remat = spec.get("remat", "full")
    kw = dict(max_seq_len=T, use_flash=True, d_model=d,
              num_layers=int(spec.get("L", 12)),
              d_ff=int(spec.get("ff", 4 * d)),
              remat=remat != "none",
              remat_policy="dots" if remat == "dots" else "full",
              fused_ln=spec.get("fln", "0") == "1")
    if "nh" in spec:
        kw["num_heads"] = int(spec["nh"])
    if "vocab" in spec:
        kw["vocab_size"] = int(spec["vocab"])
    if "celim" in spec:
        kw["ce_direct_bytes_limit"] = int(spec["celim"])
    cfg = G.GPT_SMALL.scaled(**kw)
    return cfg, {"batch": int(spec.get("b", 16)), "T": T,
                 "steps": int(spec["steps"]) if "steps" in spec else None,
                 "fused_opt": spec.get("fopt", "0") == "1"}


@contextlib.contextmanager
def _counting_flops():
    """Program reports count the ``aten`` FLOPs inside the block."""
    from ..framework import core

    prev = core.get_flag("FLAGS_program_report_flops")
    core.set_flags({"FLAGS_program_report_flops": True})
    try:
        yield
    finally:
        core.set_flags({"FLAGS_program_report_flops": prev})


def _refuse_tuned(tuned) -> None:
    if tuned:
        raise NotImplementedError(
            "--tuned profiles the autotuner's winner; tuning/ "
            "(tools/autotune.py, TUNED.json) is still to be ported "
            "(ROADMAP A4)")


def _family_rows(rows: List[Dict[str, Any]], steps: int):
    """PROFILE_STEP.json's view: ms a step and events by kernel family."""
    agg: Dict[str, List[float]] = {}
    for r in rows:
        a = agg.setdefault(r["kernel"] or r["name"], [0.0, 0])
        a[0] += r["ns"]
        a[1] += r["events"]
    return sorted(({"op": k, "ms_per_step": v[0] / 1e6 / steps,
                    "events": v[1]} for k, v in agg.items()),
                  key=lambda r: -r["ms_per_step"])


def _busy_union_ns(trace) -> float:
    """The union of the device streams' work intervals (the CPU ops'
    on the CPU): the busy time the rows must add up to."""
    from ..utils import device_trace as DT

    rows, _src = DT.device_rows(trace, exclusive=False)
    return DT.busy_ns((r[0], r[0] + r[1]) for r in rows)


def _timed_ms(fn, n: int, dev) -> float:
    """Host ms of one of ``n`` calls of ``fn``, ending in a synchronize:
    the wall a captured iteration takes without the profiler."""
    import torch

    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / n


def attribute_capture(cap, steps: int, mode: str, spec: Optional[str],
                      step_report: Dict[str, Any],
                      config: Dict[str, Any],
                      programs: Optional[List[Dict[str, Any]]] = None,
                      wall_ms: Optional[float] = None) -> Dict[str, Any]:
    """One capture's attribution: the measured rows, the document, the
    launch counts and costs the capture saw, the busy union and the
    capture's wall. The document's wall (and so its gap share) is
    ``wall_ms`` a step when given — the same work timed without the
    profiler, whose host cost (shapes, FLOP counts) inflates the captured
    steps' wall — else the capture's."""
    from ..observability import attribution as ATT
    from ..utils import device_trace as DT

    t0 = time.perf_counter()
    capture_wall_ms = cap.wall_ns / 1e6 / steps
    if wall_ms is None:
        wall_ms = capture_wall_ms
    rows = ATT.measured_kernel_rows(cap.pd, steps=steps, costs=cap.costs)
    doc = ATT.build_from_trace(
        cap.pd, steps, wall_ms, device=cap.device, rows=rows, mode=mode,
        spec=spec, step_flops=step_report.get("flops"),
        step_bytes=step_report.get("bytes_accessed"),
        programs=programs if programs is not None
        else ([step_report] if step_report else None),
        config=config, generated_by=GENERATED_BY)
    bounds: Dict[str, float] = {}
    if cap.device.type == "cuda":
        from ..observability import hw

        for name, c in cap.costs.resolve():
            bounds[name] = bounds.get(name, 0.0) + hw.bound_ms(
                c.nbytes, c.flops, c.flop_dtype, doc["device_kind"])[0]
    return {"attribution": doc, "rows": rows, "trace": cap.path,
            "launches": cap.launches, "costs": cap.costs.totals(),
            "bound_ms": bounds,
            "unanswered_launches": len(DT.unanswered_launches(cap.pd)),
            "busy_union_ns": _busy_union_ns(cap.pd),
            "wall_ms_per_step": wall_ms,
            "capture_wall_ms_per_step": capture_wall_ms, "steps": steps,
            "host_s": {"export": cap.export_s,
                       "attribute": time.perf_counter() - t0}}


def train_profile(spec_str: Optional[str], run_dir: str,
                  steps: Optional[int] = None, attr_out: str = None,
                  runs: int = 1, device: str = "cuda", warmup: int = 2,
                  tuned: str = None, remat: Optional[str] = None):
    """Profile the GPT train step at ``spec_str`` (None: the 7b
    configuration; ``remat`` overrides its policy: ``none``, ``full``,
    ``dots``) on ``device``: ``warmup`` steps (the first one the
    step's program report), then ``runs`` captures of ``steps`` steps of
    the same warmed step, each attributed. Writes the last run's
    ``ATTRIBUTION.json`` (``attr_out`` or under ``run_dir``) and
    ``PROFILE_STEP.json``; returns the run's record (a list for ``runs``
    > 1): ``attribution``, ``rows``, ``profile``, ``launches`` (a
    capture's hand-kernel launches), ``costs``, ``busy_union_ns``,
    ``wall_ms_per_step``, ``report`` (the step's program report) and,
    on the card, ``bound_ms`` (each hand kernel's launches' bounds
    summed)."""
    import numpy as np
    import torch

    from ..parallel import parallelize as PZ
    from ..utils import device_trace as DT

    _refuse_tuned(tuned)
    t_setup = time.perf_counter()
    dev = torch.device(device)
    cfg, knobs = parse_spec(spec_str)
    if remat is not None:
        cfg = cfg.scaled(remat=remat != "none",
                         remat_policy="full" if remat == "none" else remat)
    steps = int(steps or knobs["steps"] or 6)
    batch, T = knobs["batch"], knobs["T"]
    fused_opt = knobs["fused_opt"]
    params, opt = PZ.init_sharded(
        cfg, seed=0, fused_opt=fused_opt, device=dev,
        moment_dtype=torch.bfloat16 if dev.type == "cuda" else None)
    step = PZ.make_train_step(cfg, lr=1e-4, weight_decay=0.1,
                              fused_opt=fused_opt, grad_clip=1.0,
                              device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, batch, T))
                              ).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, batch, T))
                              ).to(dev)
    state = [params, opt]

    def one():
        with torch.profiler.record_function("train_step"):
            out = step(state[0], state[1], tokens, labels)
        state[0], state[1] = out[0], out[1]
        return out

    print(f"[profile] warming {spec_str or '7b'} on {dev}",
          file=sys.stderr, flush=True)
    # the step's first call reports its counted FLOPs (the document's
    # step flops)
    with _counting_flops():
        out = one()
    for _ in range(max(1, warmup) - 1):
        out = one()
    float(out[2])
    setup_s = time.perf_counter() - t_setup
    from ..observability import program_report as PREP

    report = next((r for r in reversed(PREP.recent_reports())
                   if r.get("program") == step.report_name), {})
    config = {
        "mode": "train", "spec": spec_str or "7b",
        "remat": cfg.remat_policy if cfg.remat else "none",
        "flash": cfg.use_flash, "fused_ln": cfg.fused_ln,
        "fused_opt": fused_opt, "ce_vocab_chunk": cfg.ce_vocab_chunk,
        "batch": batch, "seq": T, "d_model": cfg.d_model,
        "layers": cfg.num_layers, "dtype": str(cfg.dtype).replace(
            "torch.", ""),
    }
    results = []
    for run_i in range(max(1, runs)):
        tdir = os.path.join(run_dir, "trace" if runs <= 1
                            else f"trace_r{run_i}")
        wall_ms = _timed_ms(one, steps, dev)
        with DT.capture(tdir, device=dev, warmup=one) as cap:
            for _ in range(steps):
                out = one()
        rec = attribute_capture(cap, steps, "train", spec_str or "7b",
                                report, config, wall_ms=wall_ms)
        rec["host_s"]["setup"] = setup_s if run_i == 0 else 0.0
        rec["report"] = report
        fam = _family_rows(rec["rows"], steps)
        doc = rec["attribution"]
        rec["profile"] = {
            "spec": spec_str or "7b",
            "wall_ms_per_step": round(rec["wall_ms_per_step"], 3),
            "device_busy_ms_per_step": doc["device_busy_ms_per_step"],
            "device": doc["device_kind"],
            "rows": [{**r, "ms_per_step": round(r["ms_per_step"], 4)}
                     for r in fam[:40]]}
        results.append(rec)
        print(f"[profile] run {run_i + 1}/{runs}: wall "
              f"{rec['wall_ms_per_step']:.2f} ms/step, device busy "
              f"{doc['device_busy_ms_per_step']:.2f} ms/step, "
              f"{doc['fusion_count']} rows, residue "
              f"{doc['residue']['count']} ({doc['residue']['share_of_busy']:.1%}"
              f" of busy)", file=sys.stderr, flush=True)
    os.makedirs(run_dir, exist_ok=True)
    last = results[-1]
    from ..observability import attribution as ATT

    apath = attr_out or os.path.join(run_dir, "ATTRIBUTION.json")
    ATT.write(last["attribution"], apath)
    with open(os.path.join(run_dir, "PROFILE_STEP.json"), "w") as f:
        json.dump(last["profile"], f, indent=1)
    print(f"[profile] wrote {apath}", file=sys.stderr)
    return results if runs > 1 else results[0]


def serve_engine(device: str = "cuda", kv_layout: str = "paged",
                 weight_dtype: str = "bf16", max_batch: int = 8,
                 fused_decode: bool = True, role: str = "colocated",
                 smoke: bool = False):
    """A warmed engine (GPT_SMALL from seed weights, max_seq 1024, page
    16; ``smoke``: GPT_TINY on the CPU) with every slot holding a seeded
    prompt; returns (engine, {slot: next token})."""
    import numpy as np

    from ..models.gpt import GPT_SMALL, GPT_TINY, init_params
    from ..serving import DecodeEngine, EngineConfig

    cfg = GPT_TINY if smoke else GPT_SMALL
    max_seq = 64 if smoke else 1024
    params = init_params(cfg, seed=0, device=device)
    eng = DecodeEngine(params, cfg, EngineConfig(
        max_batch=max_batch, max_seq=max_seq,
        prefill_buckets=(16, 32) if smoke else (64, 128, 256, 512),
        weight_dtype=weight_dtype, fused_decode=fused_decode,
        kv_layout=kv_layout, page_size=16, role=role), device=device)
    del params
    eng.drop_reference_params()
    eng.warmup()
    rng = np.random.default_rng(0)
    feed: Dict[int, int] = {}
    hi = 24 if smoke else 401
    for n in rng.integers(4 if smoke else 16, hi, size=max_batch):
        slot, logits = eng.start_sequence(
            rng.integers(0, cfg.vocab_size, size=int(n)).tolist())
        feed[slot] = int(np.argmax(logits))
    return eng, feed


def decode_tick(eng, feed: Dict[int, int]) -> None:
    """One greedy decode tick of every fed slot."""
    import numpy as np

    out = eng.decode_step(feed)
    for slot in feed:
        feed[slot] = int(np.argmax(out[slot]))


def profile_ticks(eng, feed: Dict[int, int], run_dir: str, ticks: int,
                  config: Dict[str, Any], spec: str,
                  report: Dict[str, Any]) -> Dict[str, Any]:
    """Capture ``ticks`` decode ticks of a warmed engine and attribute
    them (mode ``decode``)."""
    from ..utils import device_trace as DT

    wall_ms = _timed_ms(lambda: decode_tick(eng, feed), ticks, eng.device)
    with DT.capture(os.path.join(run_dir, "trace_decode"),
                    device=eng.device,
                    warmup=lambda: decode_tick(eng, feed)) as cap:
        for _ in range(ticks):
            decode_tick(eng, feed)
    return attribute_capture(cap, ticks, "decode", spec, report, config,
                             wall_ms=wall_ms)


def serve_profile(run_dir: str, ticks: int = 16, attr_out: str = None,
                  kv_layout: str = "paged", weight_dtype: str = "bf16",
                  max_batch: int = 8, fused_decode: bool = True,
                  role: str = "colocated", device: str = "cuda",
                  smoke: bool = False, tuned: str = None):
    """Profile a warmed engine's decode tick: every slot fed, one tick
    counted as the program report ``serve/decode``, then ``ticks``
    captured and attributed. Writes ``ATTRIBUTION_DECODE.json``
    (``attr_out`` or under ``run_dir``); returns the run's record."""
    from ..observability import attribution as ATT
    from ..observability import program_report as PREP

    _refuse_tuned(tuned)
    eng, feed = serve_engine(device, kv_layout, weight_dtype, max_batch,
                             fused_decode, role, smoke)
    decode_tick(eng, feed)
    with PREP.counted(eng.device, flops=True) as counts:
        decode_tick(eng, feed)
    report = PREP.capture("serve/decode", counts,
                          extra={"mode": "decode", "max_batch": max_batch})
    cfg = eng.cfg
    config = {
        "mode": "decode", "weight_dtype": weight_dtype,
        "kv_layout": kv_layout, "max_batch": max_batch,
        "max_seq": eng.ecfg.max_seq, "d_model": cfg.d_model,
        "layers": cfg.num_layers, "fused_decode": fused_decode,
        "disagg": 1 if role in ("prefill", "decode") else 0, "role": role,
    }
    spec = (f"serve:d={cfg.d_model},L={cfg.num_layers},b={max_batch},"
            f"{weight_dtype},{kv_layout}"
            + (",fused" if fused_decode else "")
            + (f",{role}" if role != "colocated" else ""))
    rec = profile_ticks(eng, feed, run_dir, ticks, config, spec, report)
    os.makedirs(run_dir, exist_ok=True)
    apath = attr_out or os.path.join(run_dir, "ATTRIBUTION_DECODE.json")
    ATT.write(rec["attribution"], apath)
    doc = rec["attribution"]
    print(f"[profile --serve] decode tick {rec['wall_ms_per_step']:.3f} ms"
          f" | busy {doc['device_busy_ms_per_step']:.3f} ms | "
          f"{doc['fusion_count']} rows | residue "
          f"{doc['residue']['count']} ({doc['residue']['share_of_busy']:.1%})"
          f" -> {apath}", file=sys.stderr)
    rec["engine"] = eng
    return rec


def compare_attributions(path_a: str, path_b: str, out=sys.stdout):
    """Residue-diff two attribution docs: per-residue-group ms/step and
    event-count deltas, plus the config levers that changed between the
    two captures. Returns the joined per-group rows."""
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)

    def _groups(doc):
        return {g["label"]: g for g in
                doc.get("residue", {}).get("groups", [])}

    ga, gb = _groups(a), _groups(b)
    ca, cb = a.get("config") or {}, b.get("config") or {}
    print(f"=== residue diff: A={path_a}  B={path_b}", file=out)
    levers = sorted(k for k in set(ca) | set(cb)
                    if ca.get(k) != cb.get(k))
    for k in levers:
        print(f"CONFIG {k}: {ca.get(k)!r} -> {cb.get(k)!r}", file=out)
    ra, rb = a.get("residue", {}), b.get("residue", {})
    print(f"residue total: {ra.get('ms_per_step', 0):.4f} -> "
          f"{rb.get('ms_per_step', 0):.4f} ms/step | "
          f"{ra.get('count', 0)} -> {rb.get('count', 0)} ops | "
          f"fusions {a.get('fusion_count', 0)} -> "
          f"{b.get('fusion_count', 0)}", file=out)
    print(f"{'group':<16}{'ms/step A':>11}{'ms/step B':>11}"
          f"{'d(ms)':>9}{'ev A':>8}{'ev B':>8}{'d(ev)':>8}", file=out)
    rows = []
    for label in sorted(set(ga) | set(gb),
                        key=lambda l: -(ga.get(l, {})
                                        .get("ms_per_step", 0.0))):
        xa, xb = ga.get(label, {}), gb.get(label, {})
        ms_a = xa.get("ms_per_step", 0.0)
        ms_b = xb.get("ms_per_step", 0.0)
        ev_a = xa.get("events_per_step", 0.0)
        ev_b = xb.get("events_per_step", 0.0)
        rows.append({"label": label, "ms_a": ms_a, "ms_b": ms_b,
                     "ev_a": ev_a, "ev_b": ev_b})
        print(f"{label:<16}{ms_a:>11.4f}{ms_b:>11.4f}"
              f"{ms_b - ms_a:>+9.4f}{ev_a:>8.1f}{ev_b:>8.1f}"
              f"{ev_b - ev_a:>+8.1f}", file=out)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.profile_step",
        description="roofline attribution of a train step or decode tick")
    ap.add_argument("spec", nargs="?", default=None,
                    help="train spec (keys " + " ".join(SPEC_KEYS) + ")")
    ap.add_argument("--smoke", action="store_true",
                    help="SMOKE_SPEC on the CPU (a tiny engine with "
                         "--serve)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--dir", default="perf_runs",
                    help="run directory for the trace and documents")
    ap.add_argument("--attr-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; --smoke implies cpu")
    ap.add_argument("--tuned", default=None,
                    help="TUNED.json (waits for the tuning/ port)")
    ap.add_argument("--compare", nargs=2, metavar=("A.json", "B.json"))
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--ticks", type=int, default=16)
    ap.add_argument("--kv-layout", default="paged",
                    choices=("slab", "paged"))
    ap.add_argument("--weight-dtype", default="bf16",
                    choices=("f32", "bf16", "int8"))
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--fused-decode", dest="fused_decode",
                    action="store_true", default=True)
    ap.add_argument("--no-fused-decode", dest="fused_decode",
                    action="store_false")
    ap.add_argument("--disagg", action="store_true",
                    help="stamp disagg=1 and --role into the config")
    ap.add_argument("--role", default="colocated",
                    choices=("colocated", "prefill", "decode"))
    args = ap.parse_args(argv)

    if args.compare:
        compare_attributions(*args.compare)
        return 0
    _refuse_tuned(args.tuned)
    device = args.device or ("cpu" if args.smoke else "cuda")
    if args.smoke and device != "cpu":
        ap.error("--smoke runs on the CPU")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("profile_step: no CUDA device (pass --device cpu or "
                  "--smoke for the CPU lane)", file=sys.stderr)
            return 2
    if args.serve:
        role = args.role
        if args.disagg and role == "colocated":
            role = "decode"       # a decode replica's tick is the one traced
        serve_profile(args.dir, ticks=args.ticks, attr_out=args.attr_out,
                      kv_layout=args.kv_layout,
                      weight_dtype=args.weight_dtype,
                      max_batch=args.max_batch,
                      fused_decode=args.fused_decode, role=role,
                      device=device, smoke=args.smoke)
        return 0
    spec = SMOKE_SPEC if args.smoke else args.spec
    train_profile(spec, args.dir, steps=args.steps, attr_out=args.attr_out,
                  device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
