"""Communication-lever A/B bench — the port of the JAX package's
``tools/comm_bench.py``: the reduce-scatter gradient path and the
quantized collectives, end to end on one mesh of gloo ranks.

Per config it measures:
  * per-step per-rank wire bytes, split into gradient-reduction bytes and
    total collective bytes — the ``paddle_collective_bytes_total``
    {op,dtype} counter's delta over the first step (every step records
    the ring model's bytes of its collectives);
  * median step wall time over the measured steps;
  * the comm/compute overlap fraction from a profiler capture of one step
    (``comm_opt.measure_overlap_fraction``: the staged collectives' own
    time against the device streams' work, near 0 over gloo, whose
    collectives block the host);
  * the loss trajectory, and for the f32 reduce-scatter config a
    bit-parity check against the psum baseline (``grad_clip`` off on
    every config, as the reference's).

The ranks are ``parallel.launch`` gloo ranks: run as below, the command
launches ``--dp x --pp x --tp`` of itself (a rendezvous port below the
ephemeral range) and rank 0 writes the JSON; every rank sits on
``--device`` (default ``cuda:0``: the ranks share the card, every
collective staged through host memory — they price the program and the
staging, not NCCL). It reuses ``train_bench``'s parallel lane's counters
and overlap capture.

    python -m paddle_tpu_torch.tools.comm_bench [--dp 2] [--steps 5]
        [--out perf_runs/COMM_BENCH.json]
    python -m paddle_tpu_torch.tools.comm_bench --tiny --device cpu

``--tiny`` takes ``train_bench --tiny``'s widths (the CPU rehearsal);
the CPU checks bytes and parity, not times.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "paddle_tpu_torch.tools.comm_bench"

CONFIGS = (
    # (name, make_train_step kwargs)
    ("psum_f32", {}),
    ("reduce_scatter_f32", {"grad_reduce": "reduce_scatter"}),
    ("reduce_scatter_bf16", {"grad_reduce": "reduce_scatter",
                             "grad_allreduce_dtype": "bf16"}),
    ("reduce_scatter_int8_ef", {"grad_reduce": "reduce_scatter",
                                "grad_allreduce_dtype": "int8",
                                "error_feedback": True}),
    ("psum_bf16", {"grad_allreduce_dtype": "bf16"}),
)

GRAD_REDUCE_OPS = ("psum", "psum_scatter", "all_to_all")
WIRE = "paddle_collective_bytes_total"


def model_config(args):
    import torch

    from ..models import gpt as G

    if args.tiny:
        return G.GPT_TINY.scaled(d_model=64, num_layers=2, num_heads=4,
                                 d_ff=128, max_seq_len=args.T,
                                 vocab_size=512, dtype=torch.float32)
    return G.GPT_TINY.scaled(
        d_model=args.d, num_layers=args.layers, num_heads=4,
        d_ff=4 * args.d, max_seq_len=args.T, vocab_size=args.vocab,
        dtype=(torch.float32 if args.device == "cpu" else torch.bfloat16))


def run_config(name, kw, cfg, pcfg, mesh, tokens, labels, steps, dev,
               overlap_dir=None, lr=1e-2, grad_clip=None):
    """One config's row on this rank, and its final params."""
    import numpy as np

    from ..parallel import parallelize as PZ
    from ..tuning import probe as tuning_probe
    from . import train_bench as TB

    init_kw = {k: v for k, v in kw.items()
               if k in ("grad_reduce", "bucket_mb", "error_feedback",
                        "grad_allreduce_dtype")}
    params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=0, device=dev,
                                  **init_kw)
    step = PZ.make_train_step(cfg, pcfg, mesh, lr=lr, grad_clip=grad_clip,
                              device=dev, **kw)

    def _step(i):
        _, _, loss, gnorm = step(params, opt, tokens, labels)
        return loss, gnorm

    wire = {}
    before = TB._counter_snapshot(WIRE)
    timing = tuning_probe.timed_loop(
        _step, steps - 1, sync=lambda v: float(v[0]),
        after_compile=lambda: wire.update(
            TB._per_step(before, TB._counter_snapshot(WIRE), 1)))
    losses = [float(v[0]) for v in timing.values]
    times = timing.step_times_s
    overlap = None
    if overlap_dir:
        overlap = TB._overlap_step(lambda: _step(0)[0],
                                   os.path.join(overlap_dir, name),
                                   mesh.rank, dev)

    def op_of(key):
        return key.split("/")[0]

    grad_bytes = sum(v for k, v in wire.items()
                     if op_of(k) in GRAD_REDUCE_OPS)
    row = {
        "config": name,
        "step_kwargs": {k: str(v) for k, v in kw.items()},
        "steps": steps,
        "ms_per_step": round(float(np.median(times)) * 1e3, 3)
        if times else None,
        "compile_s": round(timing.compile_s, 2),
        "grad_reduce_bytes_per_step": int(grad_bytes),
        "total_collective_bytes_per_step": int(sum(wire.values())),
        "wire_bytes_by_op_dtype": {k: int(v) for k, v in
                                   sorted(wire.items())},
        "losses": [round(v, 6) for v in losses],
        "gnorm_last": round(float(timing.values[-1][1]), 6),
        "overlap_fraction": (round(overlap["overlap_fraction"], 4)
                             if overlap else 0.0),
        "overlap_source": (overlap["source"] if overlap
                           else "no_collective_events_in_trace"
                           if overlap_dir else "not_profiled"),
    }
    if overlap:
        row["collective_ms"] = round(overlap["collective_ms"], 3)
        row["exposed_collective_ms"] = round(overlap["exposed_ms"], 3)
    return row, PZ.flat_leaves(params)


def rank_main(args) -> int:
    """This rank's part: every config over one mesh; rank 0 writes the
    JSON."""
    import numpy as np
    import torch

    from ..parallel import env
    from ..parallel import parallelize as PZ

    dev = env.init_distributed_env(device=args.device)
    pcfg = PZ.ParallelConfig(dp=args.dp, pp=args.pp, tp=args.tp,
                             microbatches=max(1, args.pp))
    mesh = PZ.build_mesh(pcfg, device=dev)
    cfg = model_config(args)
    rng = np.random.default_rng(0)
    m = pcfg.microbatches
    tokens, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (m, args.batch, cfg.max_seq_len)))
        for _ in range(2))
    overlap_dir = (os.path.join(os.path.dirname(os.path.abspath(args.out)),
                                "comm_bench_traces")
                   if args.profile_overlap else None)
    rows, final = [], {}
    for name, kw in CONFIGS:
        if args.bucket_mb is not None and \
                kw.get("grad_reduce") == "reduce_scatter":
            kw = dict(kw, bucket_mb=args.bucket_mb)
        print(f"[comm_bench] {name} ...", file=sys.stderr, flush=True)
        row, leaves = run_config(name, kw, cfg, pcfg, mesh, tokens, labels,
                                 args.steps, dev, overlap_dir)
        rows.append(row)
        final[name] = leaves
        if mesh.rank == 0:
            print(json.dumps(row), flush=True)
    by_name = {r["config"]: r for r in rows}
    base = by_name["psum_f32"]
    rs = by_name["reduce_scatter_f32"]
    bit_identical = all(torch.equal(a, b) for a, b in zip(
        final["psum_f32"], final["reduce_scatter_f32"])) and \
        base["losses"] == rs["losses"]
    rs["bit_identical_to_psum"] = bool(bit_identical)

    def ratio(a, b):
        return round(a / b, 3) if b else None

    summary = {
        "grad_reduce_bytes_baseline": base["grad_reduce_bytes_per_step"],
        "rs_f32_grad_bytes_reduction_x": ratio(
            base["grad_reduce_bytes_per_step"],
            rs["grad_reduce_bytes_per_step"]),
        "rs_bf16_vs_rs_f32_grad_bytes_reduction_x": ratio(
            rs["grad_reduce_bytes_per_step"],
            by_name["reduce_scatter_bf16"]["grad_reduce_bytes_per_step"]),
        "rs_bf16_vs_baseline_grad_bytes_reduction_x": ratio(
            base["grad_reduce_bytes_per_step"],
            by_name["reduce_scatter_bf16"]["grad_reduce_bytes_per_step"]),
        "bit_identical_rs_f32": bool(bit_identical),
    }
    if mesh.rank == 0:
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        out = {
            "bench": "comm_bench", "backend": mesh.backend,
            "device": str(dev), "device_kind": kind,
            # gloo ranks: bytes and parity are facts, times price the
            # staging (and on the CPU are no device numbers)
            "degraded": dev.type != "cuda",
            "mesh": {"dp": args.dp, "pp": args.pp, "tp": args.tp},
            "model": {"d_model": cfg.d_model, "layers": cfg.num_layers,
                      "T": cfg.max_seq_len, "vocab": cfg.vocab_size,
                      "batch": args.batch},
            "steps": args.steps, "summary": summary, "configs": rows,
        }
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"[comm_bench] wrote {args.out}", file=sys.stderr)
        print(json.dumps({"summary": summary}), flush=True)
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m {MODULE}",
        description="communication-lever A/B over gloo ranks")
    ap.add_argument("--out", default=os.path.join("perf_runs",
                                                  "COMM_BENCH.json"))
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16, help="global batch")
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--T", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="override CommConfig.bucket_mb for the rs configs")
    ap.add_argument("--no-profile-overlap", dest="profile_overlap",
                    action="store_false")
    ap.add_argument("--device", default="cuda:0",
                    help="every rank's device (default the one card)")
    ap.add_argument("--tiny", action="store_true",
                    help="train_bench --tiny's widths (a CPU rehearsal)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="the gang's wall limit in seconds")
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if "PADDLE_TRAINERS_NUM" in os.environ:
        return rank_main(args)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("comm_bench: no CUDA device (pass --device cpu for the "
              "CPU rehearsal)", file=sys.stderr)
        return 2
    from .fault_bench import _reserve_port

    world = args.dp * args.pp * args.tp
    cmd = [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
           "--nproc_per_node", str(world), "--backend", "gloo",
           "--started_port", str(_reserve_port()), "--grace_period", "5",
           "-m", MODULE, *argv, "--out", os.path.abspath(args.out)]
    proc = subprocess.Popen(cmd, cwd=REPO)
    try:
        return proc.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        # the launcher forwards SIGTERM to its ranks
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        print(f"comm_bench: the gang passed {args.timeout} s",
              file=sys.stderr)
        return 124


if __name__ == "__main__":
    sys.exit(main())
