"""Host cost of one decode-path kernel wrapper call, trees compared in
turns.

    python -m paddle_tpu_torch.tools.enqueue_cost [--tree DIR ...]
        [--rounds 2] [--calls 3200]

For each tree (a checkout that holds ``paddle_tpu_torch``; default: this
one) in the order A B B A (``--rounds`` times), a fresh process imports
that tree's package, builds its kernels and times
``cuda_kernels.fused_decode_attention``,
``cuda_kernels.fused_paged_decode_attention`` and ``cuda_kernels.fused_ln``
at the serving path's shapes (GPT_SMALL bf16: batch 8, max_seq 1024, 12
heads of 64; page 16, 513 pages; q/k/v sliced from one qkv as the engine
slices them; the layernorm on [8, 768] rows, float32 scale and bias) on
the host clock: ``--calls`` calls in bursts of 32, the device synchronised
between bursts and not within one, so a burst's time is what the host
spends enqueueing (the kernels run behind it). Each process prints the
median µs a call over its bursts; the last line holds every tree's list.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

BURST = 32


def _worker(calls: int) -> dict:
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import cuda_kernels as CK

    dev = torch.device("cuda")
    B, S, nh, hd, page = 8, 1024, 12, 64, 16
    M = S // page
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    qkv = randn(B, 3, nh, hd)
    q, nk, nv = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    kc, vc = randn(B, S, nh, hd), randn(B, S, nh, hd)
    kp, vp = randn(B * M + 1, page, nh, hd), randn(B * M + 1, page, nh, hd)
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.integers(0, S, B).astype(np.int32)).to(dev)
    act = torch.ones(B, dtype=torch.int32, device=dev)
    x = randn(B, nh * hd)
    ln_scale = torch.randn(nh * hd, generator=g, device=dev)
    ln_bias = torch.randn(nh * hd, generator=g, device=dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, B * M + 1)).astype(
        np.int32).reshape(B, M)).to(dev)
    fns = {
        "slab_us": lambda: CK.fused_decode_attention(q, kc, vc, nk, nv, pos,
                                                     act),
        "paged_us": lambda: CK.fused_paged_decode_attention(
            q, kp, vp, nk, nv, tables, pos),
        "fused_ln_us": lambda: CK.fused_ln(x, ln_scale, ln_bias, eps=1e-5),
    }
    out = {}
    for key, fn in fns.items():
        for _ in range(BURST):           # builds, binds and warms up
            fn()
        torch.cuda.synchronize()
        per_call = []
        for _ in range(max(1, calls // BURST)):
            t0 = time.perf_counter()
            for _ in range(BURST):
                fn()
            per_call.append((time.perf_counter() - t0) * 1e6 / BURST)
            torch.cuda.synchronize()
        out[key] = statistics.median(per_call)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout holding paddle_tpu_torch (repeatable; "
                         "default: this one)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=3200)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.calls)))
        return 0
    here = Path(__file__).resolve().parents[2]
    trees = [str(Path(t).resolve()) for t in (args.tree or [str(here)])]
    order = (trees + trees[::-1]) * args.rounds
    runs: Dict[str, List[dict]] = {t: [] for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             "--calls", str(args.calls)],
            cwd=tree, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(rec)
        print(json.dumps({"tree": tree, **rec}))
    print(json.dumps({t: {k: [r[k] for r in rs] for k in rs[0]}
                      for t, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
