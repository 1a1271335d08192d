"""Measure the card's reachable bf16 matrix-product FLOP/s — the port of
the JAX package's ``tools/peak_probe.py``.

A chain of four dependent bf16 products large enough to fill the tensor
cores runs within some share of the card's dense peak; the best rate it
reaches is what cuBLAS attains here, printed beside the nominal 989
TFLOP/s every MFU in ``PERF.md`` divides by. A yardstick, not a port of a
kernel: ``torch.matmul`` is the call measured. Each call is fed the last
one's output, so no two calls are alike; the ``1/sqrt(k)`` rescale that
keeps magnitudes stable is folded into the right-hand operand once, so
the chain is products only.

    python -m paddle_tpu_torch.tools.peak_probe [--iters 20]
        [--shapes 4096,4096,4096;8192,8192,8192] [--device cpu]

Prints one JSON line: {"device", "results": [{m, n, k, dtype, tflops}
...], "best_tflops"}. The default device is the card (exit 2 without
one); ``--device cpu`` runs the mechanism on the CPU, whose rates are
no device numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

# n == k so the four-product chain composes shape-wise
SHAPES = ((4096, 4096, 4096), (8192, 8192, 8192), (16384, 8192, 8192))


def measure(m: int, n: int, k: int, dtype, iters: int = 20,
            device="cuda") -> float:
    """FLOP/s of ``iters`` chains of four dependent ``[m, k] x [k, n]``
    products (host clock, the chain's output read back to end it)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x0 = torch.randn(m, k, generator=gen, device=device).to(dtype)
    b = (torch.randn(k, n, generator=gen, device=device)
         * k ** -0.5).to(dtype)

    def chain(x):
        for _ in range(4):
            x = torch.matmul(x, b)
        return x

    x = chain(x0)
    float(x[0, 0])          # warm (cuBLAS's heuristics) and synchronise
    t0 = time.perf_counter()
    for _ in range(iters):
        x = chain(x)
    float(x[0, 0])
    dt = time.perf_counter() - t0
    return iters * 4 * 2 * m * n * k / dt


def probe(shapes=SHAPES, iters: int = 20, device="cuda") -> dict:
    """The probe's record over ``shapes`` on ``device``."""
    import torch

    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[peak] {dev.type} {name}", file=sys.stderr, flush=True)
    results = []
    for m, n, k in shapes:
        tf = measure(m, n, k, torch.bfloat16, iters, dev) / 1e12
        print(f"[peak] {m}x{k}x{n} bfloat16: {tf:.1f} TFLOP/s",
              file=sys.stderr, flush=True)
        results.append({"m": m, "n": n, "k": k, "dtype": "bfloat16",
                        "tflops": round(tf, 1)})
    return {"device": name, "results": results,
            "best_tflops": max(r["tflops"] for r in results)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.peak_probe",
        description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", default=None,
                    help="m,n,k[;m,n,k...] (n == k); default the "
                         "reference's three")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("peak_probe: no CUDA device (pass --device cpu for the "
              "mechanism)", file=sys.stderr)
        return 2
    shapes = SHAPES if args.shapes is None else tuple(
        tuple(int(x) for x in s.split(",")) for s in args.shapes.split(";"))
    print(json.dumps(probe(shapes, args.iters, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
