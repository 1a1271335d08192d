"""Measurement-driven autotuner CLI — the port of the JAX package's
``tools/autotune.py`` (core logic in ``paddle_tpu_torch/tuning/``).

Enumerates the train/serve knob spaces, prunes with the static roofline
model anchored on the incumbent's program report, probes survivors
successive-halving style, and writes TUNED.json — the reproducible
artifact ``train_bench --tuned=``, ``serve_bench --tuned=``,
``profile_step --tuned`` and ``make_train_step(tuned=)`` accept
(hardware-fingerprint gated).

    python -m paddle_tpu_torch.tools.autotune --smoke --device cpu
        # the CPU lane
    python -m paddle_tpu_torch.tools.autotune --space train --layers 2 \\
        --out perf_runs/autotune/TUNED.json
    python -m paddle_tpu_torch.tools.autotune --smoke --device cpu \\
        --log probes.jsonl
        # resumable: a killed tune re-run with the same --log continues —
        # completed probes come back from the JSONL without re-running
        # (probe count conserved), only the remainder executes

The device is the card (exit 2 without one) unless ``--device cpu``
asks for the CPU. The default geometry is the GPT lane of ``bench.py``
at full width (D 768, 12 layers, 12 heads, d_ff 3072, V 50,304, T 1024,
batch 16; serving max seq 1024, page 16, 8 slots, prompts of 16-256
tokens, 16 new ones); ``--smoke`` takes the reference's tiny one instead
and trims the serve axes as the reference's does. On the card the train
probes run flash attention, in bf16. Each geometry flag overrides its
default. Files go under
``--out``'s directory (default ``perf_runs/autotune``): TUNED.json, its
probe log, the arbitration's monitor rows, baseline and report — never
the repository root's ``TUNED.json``, which is the JAX package's record.

Arbitration: after the tune, the incumbent runs one monitored confirm
probe whose rows become the run directory's baseline (``perf_diff
--update-baseline``), then the winner runs one and ``perf_diff`` diffs
it against that baseline; the verdict is stamped into TUNED.json
``arbitration`` and the exit code is perf_diff's.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, Tuple

DEFAULT_OUT = os.path.join("perf_runs", "autotune", "TUNED.json")


def _parse_rungs(spec: str):
    rungs = []
    for part in spec.split(","):
        steps, keep = part.split(":")
        rungs.append((int(steps), float(keep)))
    return tuple(rungs)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.autotune",
        description="measurement-driven autotuner")
    ap.add_argument("--space", default="all",
                    choices=("train", "serve", "all"))
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tiny geometry and trimmed serve "
                         "axes (with --device cpu: the CPU lane end to end "
                         "in under a minute)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--log", default=None,
                    help="probe-log JSONL (default <out>.probes.jsonl); "
                         "re-running with the same log resumes")
    ap.add_argument("--train-rungs", default="2:0.5,4:1.0",
                    help="steps:keep_frac[,steps:keep_frac...]")
    ap.add_argument("--serve-rungs", default="4:0.5,8:1.0",
                    help="requests:keep_frac[,...]")
    ap.add_argument("--static-margin", type=float, default=0.20)
    ap.add_argument("--improve-margin", type=float, default=0.03)
    ap.add_argument("--hbm-budget", type=float, default=None,
                    help="override the card's device-memory budget in "
                         "bytes (tests seed an over-budget candidate here)")
    ap.add_argument("--no-arbitrate", action="store_true")
    ap.add_argument("--baseline", default=None,
                    help="arbitration baseline (default: recorded from the "
                         "incumbent's confirm probe in the run directory)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exit 2 without a card) or cpu")
    # geometry: each default from GEOMETRY (full width) or, with --smoke,
    # SMOKE_GEOMETRY (the reference's gpt_tiny_cpu shape)
    for flag, kind in (("--d", int), ("--layers", int), ("--nh", int),
                       ("--ff", int), ("--T", int), ("--batch", int),
                       ("--vocab", int), ("--max-seq", int),
                       ("--max-batch", int), ("--page-size", int),
                       ("--max-new", int), ("--prompt-len", str)):
        ap.add_argument(flag, type=kind, default=None)
    ap.add_argument("--requests", type=int, default=None,
                    help="override terminal-rung request count (serve)")
    return ap


# the geometry flags' defaults: bench.py's GPT lane at full width, and
# the reference's tiny smoke shape (serve: max_new tokens a request,
# prompt lengths "MIN,MAX")
GEOMETRY = dict(d=768, layers=12, nh=12, ff=3072, T=1024, batch=16,
                vocab=50304, max_seq=1024, max_batch=8, page_size=16,
                max_new=16, prompt_len="16,256")
SMOKE_GEOMETRY = dict(d=64, layers=2, nh=4, ff=128, T=32, batch=4,
                      vocab=256, max_seq=64, max_batch=8, page_size=8,
                      max_new=8, prompt_len="2,12")


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, each geometry flag left unset taking its default from
    ``SMOKE_GEOMETRY`` under ``--smoke``, else from ``GEOMETRY``."""
    args = _parser().parse_args(argv)
    for k, v in (SMOKE_GEOMETRY if args.smoke else GEOMETRY).items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    return args


def _say(m: str) -> None:
    print(f"[autotune] {m}", flush=True)


def train_geometry(args, ctx):
    """The train probes' geometry; on the card they run flash
    attention."""
    from ..tuning import probe

    return probe.TrainProbeGeometry(
        d_model=args.d, num_layers=args.layers, num_heads=args.nh,
        d_ff=args.ff, T=args.T, vocab_size=args.vocab, batch=args.batch,
        dp=ctx.dp, use_flash=ctx.on_acc)


def serve_geometry(args):
    from ..tuning import probe

    lo, hi = (int(x) for x in args.prompt_len.split(","))
    return probe.ServeProbeGeometry(
        d_model=args.d, num_layers=args.layers,
        num_heads=args.nh, d_ff=args.ff, vocab_size=args.vocab,
        max_seq=args.max_seq, page_size=args.page_size,
        max_new_tokens=args.max_new, prompt_len_max=hi, prompt_len_min=lo)


def train_static_fn(args, geom, hwm, incumbent) -> Callable:
    """The train space's static estimate from the incumbent's rung-0
    report; None ("measure instead") without counted FLOPs and bytes
    (always on the CPU, where no hand kernel launches)."""
    from ..tuning import static_cost

    def static_fn(cand, inc_result):
        rep = (inc_result or {}).get("report") or {}
        if not rep.get("flops") or not rep.get("bytes_accessed"):
            return None               # no report: measure instead
        base = static_cost.BaseStats(
            flops=float(rep["flops"]),
            bytes_accessed=float(rep["bytes_accessed"]),
            peak_hbm_bytes=float(rep.get("peak_hbm_bytes") or 0.0),
            param_bytes=float(inc_result.get("params") or 0) * 4.0,
            tokens_per_step=geom.batch * geom.T,
            vocab_size=args.vocab, incumbent=incumbent)
        return static_cost.predict_train(cand, base, hwm, dp=geom.dp)
    return static_fn


def tune_train(args, ctx, di, hwm, plog, say=_say):
    from ..tuning import driver, probe, space

    axes = space.train_axes(ctx)
    valid, refused = space.enumerate_space("train", axes, ctx)
    say(f"train: {len(valid) + len(refused)} enumerated, "
        f"{len(refused)} refused by validity predicates")
    incumbent = space.train_incumbent(ctx)
    geom = train_geometry(args, ctx)

    def probe_fn(cand, steps, rung):
        # the static model's anchor: FLOPs counted for the incumbent's
        # rung-0 probe only
        return probe.run_train_probe(
            cand, geom, steps, warmup=1, seed=args.seed, device=di.device,
            count_flops=rung == 0 and cand.key == incumbent.key)

    return driver.tune(
        space="train", candidates=valid, refusals=refused,
        incumbent=incumbent, probe_fn=probe_fn,
        static_fn=train_static_fn(args, geom, hwm, incumbent),
        rungs=_parse_rungs(args.train_rungs),
        improve_margin=args.improve_margin,
        static_margin=args.static_margin, log=plog, phase="train",
        progress=say)


def serve_axes_for(args, ctx) -> Dict[str, tuple]:
    from ..tuning import space

    if args.smoke:
        return space.serve_axes(
            ctx, max_batches=(args.max_batch,),
            bucket_ladders=((max(args.page_size, args.max_seq // 4),
                             args.max_seq // 2),
                            (args.max_seq // 2,)),
            specs=(0, 2), disagg_ratios=("off", "1:1"),
            disagg_decode_batches=(1,))
    return space.serve_axes(ctx)


def tune_serve(args, ctx, di, hwm, plog, say=_say):
    from ..models import gpt as G
    from ..parallel.parallelize import flat_leaves
    from ..tuning import driver, probe, space, static_cost

    valid, refused = space.enumerate_space(
        "serve", serve_axes_for(args, ctx), ctx)
    say(f"serve: {len(valid) + len(refused)} enumerated, "
        f"{len(refused)} refused by validity predicates")
    incumbent = space.serve_incumbent(ctx)
    geom = serve_geometry(args)

    # analytic decode-tick base: one token re-reads the weights once
    # (flops 2N, bytes ~param_bytes) — enough for RELATIVE pruning
    cfg = G.GPT_TINY.scaled(d_model=args.d, num_layers=args.layers,
                            num_heads=args.nh, d_ff=args.ff,
                            vocab_size=args.vocab,
                            max_seq_len=args.max_seq)
    n_params = sum(math.prod(s) for s in flat_leaves(G.param_shapes(cfg)))
    param_bytes = n_params * 4.0
    kv_page_bytes = 2.0 * args.layers * args.d * args.page_size * 4.0

    def probe_fn(cand, steps, rung):
        return probe.run_serve_probe(cand, geom, n_requests=steps,
                                     seed=args.seed, device=di.device)

    def static_fn(cand, inc_result):
        base = static_cost.BaseStats(
            flops=2.0 * n_params, bytes_accessed=param_bytes,
            peak_hbm_bytes=3.0 * param_bytes,
            param_bytes=param_bytes, incumbent=incumbent)
        return static_cost.predict_serve(cand, base, hwm,
                                         kv_page_bytes=kv_page_bytes)

    rungs = _parse_rungs(args.serve_rungs)
    if args.requests:
        rungs = rungs[:-1] + ((args.requests, rungs[-1][1]),)
    return driver.tune(
        space="serve", candidates=valid, refusals=refused,
        incumbent=incumbent, probe_fn=probe_fn, static_fn=static_fn,
        rungs=rungs, improve_margin=args.improve_margin,
        static_margin=args.static_margin, log=plog, phase="serve",
        progress=say)


def arbitrate(args, di, train_result, doc, say=_say) -> int:
    """Confirm the incumbent and then the train winner with monitored
    probes; ``perf_diff`` records the incumbent's rows as the run
    directory's baseline (unless ``--baseline`` names one) and diffs the
    winner's against it. Stamps ``doc["arbitration"]`` (with each confirm
    probe's result) and returns perf_diff's exit code."""
    from ..tuning import probe
    from . import perf_diff

    geom = train_geometry(args, _space_context(args, di))
    run_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                           "arbitration")
    os.makedirs(run_dir, exist_ok=True)
    lane = "gpu" if di.on_acc else "cpu_smoke"
    baseline = args.baseline or os.path.join(run_dir, "PERF_BASELINE.json")
    confirms = {}
    for who, cand in (("incumbent", train_result.incumbent),
                      ("winner", train_result.winner)):
        if who == "incumbent" and args.baseline:
            continue
        mon = os.path.join(run_dir, f"{who}.jsonl")
        if os.path.exists(mon):
            os.unlink(mon)
        say(f"arbitration: confirm probe of the {who} {cand.key}")
        confirms[who] = probe.run_train_probe(
            cand, geom, steps=4, warmup=1, monitor=mon, seed=args.seed,
            device=di.device)
        common = ["--dir", run_dir, "--monitor", mon, "--baseline",
                  baseline, "--lane", lane]
        if who == "incumbent":
            perf_diff.main(common + ["--update-baseline", "--notes",
                                     f"incumbent {cand.key}"])
    out = os.path.join(run_dir, "REGRESSION.json")
    rc = perf_diff.main(["--dir", run_dir, "--monitor",
                         os.path.join(run_dir, "winner.jsonl"),
                         "--baseline", baseline, "--out", out,
                         "--notes", f"tuned winner "
                         f"{train_result.winner.key}"])
    say(f"arbitration: perf_diff rc={rc} (confirm "
        f"{confirms['winner'].get('ms_per_step')} ms/step)")
    doc["arbitration"] = {
        "ran": True, "ok": rc == 0, "exit_code": rc,
        "baseline": baseline, "regression": out, "lane": lane,
        "confirm_ms_per_step": confirms["winner"].get("ms_per_step"),
        "confirms": confirms, "at": round(time.time(), 1),
    }
    return rc


def _space_context(args, di):
    from ..tuning import space

    return space.SpaceContext(
        dp=1, n_devices=di.n_devices, platform=di.platform,
        vocab_size=args.vocab, max_seq=args.max_seq,
        max_batch=args.max_batch, page_size=args.page_size,
        on_acc=di.on_acc)


def run(args, argv=None, say=_say) -> Tuple[Dict[str, Any], Dict[str, Any],
                                            int]:
    """One tune: (results by space, the written document, the
    arbitration's exit code — 0 when it did not run)."""
    from ..tuning import driver, probe, static_cost
    from ..tuning import tuned as tuned_mod

    di = probe.device_info(args.device)
    fp = probe.hw_fingerprint(di)
    say(f"device: {di.platform}/{di.device_kind} x{di.n_devices} "
        f"degraded={di.degraded} fingerprint={fp['fingerprint']}")
    ctx = _space_context(args, di)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    plog = driver.ProbeLog(args.log or args.out + ".probes.jsonl")
    hwm = static_cost.HwModel.for_device(
        di.device, hbm_capacity_bytes=(
            args.hbm_budget if args.hbm_budget is not None else ...))
    results = {}
    try:
        if args.space in ("train", "all"):
            results["train"] = tune_train(args, ctx, di, hwm, plog, say)
        if args.space in ("serve", "all"):
            results["serve"] = tune_serve(args, ctx, di, hwm, plog, say)
    finally:
        plog.close()
    doc = tuned_mod.build_doc(
        results, fp, args=" ".join(argv if argv is not None
                                   else sys.argv[1:]))
    tuned_mod.save(args.out, doc)
    say(f"wrote {args.out}")
    rc = 0
    if not args.no_arbitrate and "train" in results:
        rc = arbitrate(args, di, results["train"], doc, say)
        tuned_mod.save(args.out, doc)    # with the arbitration stamp
    for s, tr in results.items():
        say(f"{s}: winner={tr.winner.key} improved={tr.improved} "
            f"probes_executed={tr.probes_executed} "
            f"pruned={json.dumps(tr.pruned)}")
    return results, doc, rc


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("autotune: no CUDA device (pass --device cpu for the CPU "
              "lane)", file=sys.stderr)
        return 2
    return run(args, argv)[2]


if __name__ == "__main__":
    sys.exit(main())
