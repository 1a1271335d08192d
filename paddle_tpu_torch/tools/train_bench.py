"""Train GPT on one card and report throughput — the port's twin of
``bench.py``'s accelerator GPT lane (``bench.py:490-519``, ``:745-803``).

    python -m paddle_tpu_torch.tools.train_bench [--remat dots]
        [--profile 3] [--compare]

The configuration is GPT_SMALL at full width and depth, batch 16 x 1024,
bf16 compute with float32 master weights and bf16 Adam moments,
flash attention, ``dots`` remat (``--remat`` picks another policy), the
direct CE path, and the flat AdamW
sweep through its kernel (``fused_opt=True``) at lr 1e-4, weight decay
0.1, clip 1.0; 2 warm-up steps and 10 timed ones. Weights and tokens come
from seeds; every step trains on the same batch, as ``bench.py`` does. Prints one JSON line: tokens/s, MFU
against the card's bf16 dense peak (``observability/hw.py``), ms per
step, peak device memory, first and last loss, kernel launches per step.
With ``--profile N``, N more steps run under ``torch.profiler`` and the
record gains where the device time goes: busy and idle share of the
traced wall time, and kernel time per step by group (each flash kernel,
the AdamW sweep, matrix products, the rest) and by name, all per step. ``--compare``
runs the plain arm (plain attention, plain PyTorch sweep) and the kernel
arm in turns — plain, kernel, kernel, plain — one JSON line each.
"""
import argparse
import json
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from ..models import gpt as G
from ..observability import hw
from ..ops import cuda_kernels as CK
from ..parallel import parallelize as PZ
from .profile_decode import trace_summary

# the training kernels' names in a trace (ops/csrc)
TRAIN_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel", "adamw_flat_kernel")
BATCH, SEQ = 16, 1024           # bench.py's GPT lane
STEPS, WARMUP = 10, 2


def _profile(step, state, steps: int) -> Dict[str, Any]:
    """Trace ``steps`` train steps (``state`` = [params, opt, tokens,
    labels]); device time per step as ``profile_decode.trace_summary``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state[:2] = step(*state)[:2]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"steps": steps,
            **trace_summary(prof, wall_us, steps, "step", TRAIN_KERNELS)}


def bench_config(remat_policy: str = "dots") -> G.GPTConfig:
    """bench.py's accelerator GPT lane with the tuned train winner
    (``dots`` remat; the flat sweep is chosen in :func:`run`)."""
    return G.GPT_SMALL.scaled(max_seq_len=SEQ, use_flash=True,
                              remat=remat_policy != "none",
                              remat_policy=remat_policy)


def run(cfg: G.GPTConfig, fused_opt_kernel=None,
        profile_steps: int = 0) -> Dict[str, Any]:
    """WARMUP + STEPS train steps on one batch on the card; the timed
    steps end in one synchronize, and launch counts are zeroed just before
    them (then ``profile_steps`` traced steps, outside the counts and
    losses)."""
    dev = torch.device("cuda")
    batch, T, steps, warmup = BATCH, SEQ, STEPS, WARMUP
    params, opt = PZ.init_sharded(cfg, seed=0, moment_dtype=torch.bfloat16,
                                  fused_opt=True, device=dev)
    n_params = G.num_params(params)
    step = PZ.make_train_step(cfg, lr=1e-4, weight_decay=0.1,
                              fused_opt=True,
                              fused_opt_kernel=fused_opt_kernel,
                              grad_clip=1.0, device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, batch, T))
                              ).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, batch, T))
                              ).to(dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        params, opt, loss, _g = step(params, opt, tokens, labels)
        losses.append(loss)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    CK.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, loss, gnorm = step(params, opt, tokens, labels)
        losses.append(loss)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k: v / steps for k, v in CK.LAUNCHES.items() if v}
    losses = [float(x) for x in losses]
    tok_s = steps * batch * T / wall
    flops = G.train_flops_per_token(cfg, n_params, T)
    name = torch.cuda.get_device_name(dev)
    rec = {
        "config": f"gpt_small_L{cfg.num_layers}_b{batch}x{T}",
        "device": name,
        "model_params": n_params,
        "batch": batch, "seq_len": T, "steps": steps, "warmup": warmup,
        "remat_policy": cfg.remat_policy if cfg.remat else "none",
        "flash": cfg.use_flash,
        "moment_dtype": "bfloat16",
        "tokens_per_s": tok_s,
        "mfu": tok_s * flops / hw.peaks_for(name)["bf16_flops_per_s"],
        "ms_per_step": wall / steps * 1e3,
        "warmup_s": warm_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses,
        "grad_norm_last": float(gnorm),
        "launches_per_step": launches,
    }
    if profile_steps:
        rec["profile"] = _profile(step, [params, opt, tokens, labels],
                                  profile_steps)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--remat", default="dots",
                    help="none | full | dots | save_only_flash")
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps under torch.profiler")
    ap.add_argument("--compare", action="store_true",
                    help="plain and kernel arms in turns: P, K, K, P")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_bench: no CUDA device available", file=sys.stderr)
        return 2
    cfg = bench_config(args.remat)
    arms = {"kernel": (cfg, None),
            "plain": (cfg.scaled(use_flash=False), False)}
    order = ("plain", "kernel", "kernel", "plain") if args.compare \
        else ("kernel",)
    for arm in order:
        acfg, kern = arms[arm]
        rec = run(acfg, fused_opt_kernel=kern, profile_steps=args.profile)
        rec["arm"] = arm
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
