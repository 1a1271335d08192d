"""Where a serving decode tick's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_decode [--ticks 30]

Builds two GPT_SMALL bf16 engines from seed weights (8 slots, max_seq
1024) — the kernel tick (``fused_decode=True``) and the plain-PyTorch
tick (``fused_decode=False``) — fills every slot with a seeded prompt of
16-400 tokens, and then, alternating plain / kernel / kernel / plain:

- times ``--ticks`` decode steps on the host clock (each step ends in the
  device-to-host copy of the logits, so it waits for the device);
- traces ``--ticks`` more under ``torch.profiler`` and sums the device
  time of every kernel by name and by group (the port's own kernels,
  matrix products, the rest), and the union of kernel intervals — the
  device's busy time; idle share = 1 - busy / wall. Every time in the
  output is per tick.

Prints one JSON line per arm and a last JSON line with both. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

OURS = ("fused_ln_fwd_kernel", "decode_slab_kernel", "logits_head_kernel")


def _group(name: str, ours=OURS) -> str:
    for k in ours:
        if k in name:
            return k
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    return "other"


def _union_us(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace_summary(prof, wall_us: float, n: int, per: str = "tick",
                  ours=OURS) -> dict:
    """Device time of a ``torch.profiler`` trace of ``n`` iterations (each
    a ``per``: tick or step) over ``wall_us`` of host time: busy ms (union
    of kernel intervals), idle share, kernels, and kernel ms by group (the
    names in ``ours``, ``matmul``, ``other``) and by name — all per
    iteration."""
    spans, by_name, by_group = [], {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (e - s)
        g = _group(ev.name, ours)
        by_group[g] = by_group.get(g, 0.0) + (e - s)
    busy_us = _union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        f"traced_{per}_ms": wall_us / 1e3 / n,
        f"device_busy_ms_per_{per}": busy_us / 1e3 / n,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        f"kernels_per_{per}": len(spans) / n,
        f"group_ms_per_{per}": {k: v / 1e3 / n
                                for k, v in sorted(by_group.items())},
        f"top_kernels_ms_per_{per}": [[name[:80], v / 1e3 / n]
                                      for name, v in top],
    }


def _engine(fused: bool):
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.serving import DecodeEngine, EngineConfig

    params = init_params(GPT_SMALL, seed=0, device="cuda")
    eng = DecodeEngine(params, GPT_SMALL, EngineConfig(
        max_batch=8, max_seq=1024, prefill_buckets=(64, 128, 256, 512),
        weight_dtype="bf16", fused_decode=fused), device="cuda")
    eng.warmup()
    rng = np.random.default_rng(0)
    feed: Dict[int, int] = {}
    for n in rng.integers(16, 401, size=8):
        slot, logits = eng.start_sequence(
            rng.integers(0, GPT_SMALL.vocab_size, size=int(n)).tolist())
        feed[slot] = int(np.argmax(logits))
    return eng, feed


def _step(eng, feed):
    out = eng.decode_step(feed)
    for slot in feed:
        feed[slot] = int(np.argmax(out[slot]))


def _arm(eng, feed, ticks: int) -> dict:
    for _ in range(3):
        _step(eng, feed)
    t0 = time.perf_counter()
    for _ in range(ticks):
        _step(eng, feed)
    tick_ms = (time.perf_counter() - t0) * 1e3 / ticks
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            _step(eng, feed)
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"tick_ms": tick_ms, **trace_summary(prof, wall_us, ticks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device available", file=sys.stderr)
        return 2
    arms = {"plain": _engine(False), "kernels": _engine(True)}
    runs: Dict[str, List[dict]] = {"plain": [], "kernels": []}
    for name in ("plain", "kernels", "kernels", "plain"):
        eng, feed = arms[name]
        r = _arm(eng, feed, args.ticks)
        r["arm"] = name
        runs[name].append(r)
        print(json.dumps(r))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ticks": args.ticks,
                      "tick_ms": {k: [r["tick_ms"] for r in v]
                                  for k, v in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
