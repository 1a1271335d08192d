"""Where a serving decode tick's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_decode [--ticks 30]
        [--kv-layout {slab,paged}] [--weight-dtype int8]
        [--spec-k N --draft-layers L]

Builds two GPT_SMALL bf16 engines from seed weights (8 slots, max_seq
1024, the given KV layout; paged: page 16, the default pool) — the kernel
tick (``fused_decode=True``) and the plain-PyTorch tick
(``fused_decode=False``) — fills every slot with a seeded prompt of
16-400 tokens, and then, alternating plain / kernel / kernel / plain:

- times ``--ticks`` decode steps on the host clock (each step ends in the
  device-to-host copy of the logits, so it waits for the device);
- traces ``--ticks`` more under ``torch.profiler`` and sums the device
  time of every kernel by name and by group (the port's own kernels,
  matrix products, the rest), and the union of kernel intervals — the
  device's busy time; idle share = 1 - busy / wall. Every time in the
  output is per tick.

With ``--weight-dtype int8`` the two arms are kernel ticks of a bf16 and
an int8 engine (their float32 truth dropped), timed bf16 / int8 / int8 /
bf16, with each engine's ``weight_nbytes``. With ``--spec-k N`` the arms
are the bf16 kernel tick alone and one speculative step
(``SpecDecodeEngine``, target verify window N + 1, a draft of
``--draft-layers`` layers at GPT_SMALL's width from seed 1): each step is
split on the host clock into the draft's ticks (catch-up and proposals),
the target's verify and the host's acceptance, with the tokens it emits a
slot; ``ms_per_token`` is the step over its tokens a slot, the tick's
counterpart.

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

# substring of a kernel's (demangled) name -> its group; the two decode
# kernels are instances of one template pair (split pass and merge), told
# apart by the row policy both carry as a template argument
OURS = {"fused_ln_fwd_kernel": "fused_ln", "SlabRows": "decode_slab",
        "PagedRows": "decode_paged", "logits_head_kernel": "logits_head"}


def _group(name: str, ours=OURS) -> str:
    """The group of a kernel: ``ours[k]`` for the first key ``k`` found in
    its name, else ``matmul`` or ``other``."""
    for k in ours:
        if k in name:
            return ours[k]
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
        # named ranges (record_function) show on the device as spans too
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation):
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


def _build(fused: bool, kv_layout: str, weight_dtype: str = "bf16",
           layers: int = 0, seed: int = 0, verify_window: int = 0):
    """A GPT_SMALL engine (``layers`` > 0: that depth) from seed weights,
    its float32 truth dropped, warmed up."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.serving import DecodeEngine, EngineConfig

    cfg = GPT_SMALL.scaled(num_layers=layers) if layers else GPT_SMALL
    params = init_params(cfg, seed=seed, device="cuda")
    eng = DecodeEngine(params, cfg, EngineConfig(
        max_batch=8, max_seq=1024, prefill_buckets=(64, 128, 256, 512),
        weight_dtype=weight_dtype, fused_decode=fused, kv_layout=kv_layout,
        page_size=16, verify_window=verify_window), device="cuda")
    del params
    eng.drop_reference_params()
    return eng


def _engine(fused: bool, kv_layout: str, weight_dtype: str = "bf16",
            spec=None):
    """An engine (``spec`` = (k, draft layers): a SpecDecodeEngine) with
    every slot holding a seeded prompt; returns (engine, {slot: next
    token})."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.serving import SpecDecodeEngine

    if spec is None:
        eng = _build(fused, kv_layout, weight_dtype)
    else:
        k, draft_layers = spec
        eng = SpecDecodeEngine(
            _build(fused, kv_layout, weight_dtype, verify_window=k + 1),
            _build(fused, kv_layout, weight_dtype, layers=draft_layers,
                   seed=1))
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


class _Clock:
    """Host ms spent in one method of an object, summed (each engine call
    ends in a device-to-host copy, so it waits for the device)."""

    def __init__(self, obj, name: str):
        self.ms = 0.0
        fn = getattr(obj, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.ms += (time.perf_counter() - t0) * 1e3

        setattr(obj, name, timed)


def _spec_arm(spec, feed, steps: int) -> dict:
    """One speculative step a slot, ``steps`` times: the step's host ms
    split into the draft's ticks, the target's verify and the rest (the
    host's acceptance), and the tokens emitted a slot."""
    def step():
        out = spec.generate_step(feed)
        for slot, toks in out.items():
            feed[slot] = toks[-1]
        return sum(len(t) for t in out.values()) / len(out)

    for _ in range(3):
        step()
    draft = _Clock(spec.draft, "decode_step_sampled")
    verify = _Clock(spec.target, "verify_step")
    t0 = time.perf_counter()
    emitted = sum(step() for _ in range(steps))
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    for obj, name in ((spec.draft, "decode_step_sampled"),
                      (spec.target, "verify_step")):
        del obj.__dict__[name]
    per = emitted / steps
    return {"step_ms": step_ms, "draft_ms": draft.ms / steps,
            "draft_tick_ms": draft.ms / steps / spec.k,
            "verify_ms": verify.ms / steps,
            "accept_ms": step_ms - (draft.ms + verify.ms) / steps,
            "tokens_per_window": per, "ms_per_token": step_ms / per,
            "acceptance_rate": spec.stats.acceptance_rate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--kv-layout", choices=("slab", "paged"), default="slab")
    ap.add_argument("--weight-dtype", choices=("bf16", "int8"),
                    default="bf16")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--draft-layers", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device available", file=sys.stderr)
        return 2
    lay = args.kv_layout
    if args.spec_k:
        arms = {"target": _engine(True, lay),
                "spec": _engine(True, lay,
                                spec=(args.spec_k, args.draft_layers))}
        order = ("target", "spec", "spec", "target")
    elif args.weight_dtype == "int8":
        arms = {"bf16": _engine(True, lay), "int8": _engine(True, lay,
                                                            "int8")}
        order = ("bf16", "int8", "int8", "bf16")
    else:
        arms = {"plain": _engine(False, lay), "kernels": _engine(True, lay)}
        order = ("plain", "kernels", "kernels", "plain")
    runs: Dict[str, List[dict]] = {name: [] for name in arms}
    for name in order:
        eng, feed = arms[name]
        if name == "spec":
            r = _spec_arm(eng, feed, args.ticks)
        else:
            r = _arm(eng, feed, args.ticks)
            r["weight_nbytes"] = eng.weight_nbytes
        r["arm"] = name
        runs[name].append(r)
        print(json.dumps(r))
    key = {name: ("step_ms" if name == "spec" else "tick_ms")
           for name in arms}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "kv_layout": lay, "ticks": args.ticks,
                      "spec_k": args.spec_k,
                      "draft_layers": args.draft_layers if args.spec_k
                      else None,
                      "ms": {k: [r[key[k]] for r in v]
                             for k, v in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
