"""Train GPT, pretrain ERNIE or train ResNet-50 on one card and report
throughput — the port's twin of ``bench.py``'s accelerator GPT lane
(``bench.py:490-519``, ``:745-803``), its ERNIE lane (``:326-395``) and
its ResNet lane (``resnet_worker``, ``:254-323``).

    python -m paddle_tpu_torch.tools.train_bench [--remat dots]
        [--fused-ln] [--ce-vchunk N] [--profile 3] [--compare]
        [--monitor PATH]
    python -m paddle_tpu_torch.tools.train_bench --model ernie [--pad]
        [--profile 3] [--compare]
    python -m paddle_tpu_torch.tools.train_bench --model resnet50
        [--no-amp] [--no-fuse] [--profile 3] [--host-profile 5]
        [--compare] [--device cpu --tiny]
    python -m paddle_tpu_torch.tools.train_bench --model encoder
        [--profile 1] [--device cpu --tiny]
    python -m paddle_tpu_torch.tools.train_bench --model encoder --no-amp
        --recompute --optimizer lamb [--device cpu --tiny]
    python -m paddle_tpu_torch.tools.train_bench --model resnet50
        --grad-merge K [--device cpu --tiny]
    python -m paddle_tpu_torch.parallel.launch --nproc_per_node 2 -m \
        paddle_tpu_torch.tools.train_bench [--sharding fsdp] [--dp 2]
        [--tp 2] [--pp 2] [--layout SPEC ...]      (the parallel lane)
    python -m paddle_tpu_torch.parallel.launch --nproc_per_node 2 -m \
        paddle_tpu_torch.tools.train_bench --model ernie --tp 2 [--dp N]

The configuration is GPT_SMALL at full width and depth, batch 16 x 1024,
bf16 compute with float32 master weights and bf16 Adam moments,
flash attention, ``dots`` remat (``--remat`` picks another policy), the
direct CE path, and the flat AdamW
sweep through its kernel (``fused_opt=True``) at lr 1e-4, weight decay
0.1, clip 1.0; 2 warm-up steps and 10 timed ones. ``--fused-ln`` sends
every layernorm through the fused-layernorm kernels (``fused_ln=True``),
``--ce-vchunk N`` the loss through the vocab-chunked CE in chunks of N
columns (``ce_vocab_chunk=N``, direct CE off, as ``bench.py --ce-vchunk``
sets it). Weights and tokens come
from seeds; every step trains on the same batch, as ``bench.py`` does. Prints one JSON line: tokens/s, MFU
against the card's bf16 dense peak (``observability/hw.py``), ms per
step, peak device memory, first and last loss, kernel launches per step.
With ``--profile N``, N more steps run under ``torch.profiler`` and the
record gains where the device time goes: busy and idle share of the
traced wall time, and kernel time per step by group (each of the port's
training kernels, matrix products, the rest) and by name, all per step.
``--compare`` runs the plain arm (plain attention and layernorm, the
row-chunked or direct CE, plain PyTorch sweep) and the kernel arm in
turns — plain, kernel, kernel, plain — one JSON line each.
``--monitor PATH`` (GPT) writes one ``TrainMonitor`` row a timed step to
PATH, as ``bench.py --monitor=`` does: step time split into host dispatch
and device wait (each step then syncs on its loss), tokens/s, MFU, loss,
grad norm, the goodput categories since the last row and the card's
allocated and peak bytes; the record gains the timed window's goodput
report.

``--tuned PATH`` applies the autotuner's train winner
(``tools/autotune.py``) as ``bench.py --tuned=`` does: the document is
fingerprint-gated ("applied", or "REFUSED" with a warning and the
defaults), its model knobs (remat, fused LN, CE vocab chunk) apply where
the flags were left at their defaults, its step knobs go through
``make_train_step(tuned=)`` / ``init_sharded(tuned=)`` (the lane's
explicit flat sweep wins over the tuner), and the record carries the
document's ``tuned`` stamp. GPT only.

``--model ernie`` is ``bench.py``'s ERNIE lane as written: ERNIE_BASE
(L 12, nh 12, D 768, d_ff 3072, V 30522) at full width and depth, bf16
compute on float32 params, flash attention (the bias form: the padding
mask enters every flash kernel as a [B, 1, 1, T] bias), remat off, the
momentum step at lr 1e-4; batch 48 x 512, 2 warm-up and 10 timed steps,
every step on the same synthetic batch from numpy seed 0 with an all-ones
``pad_mask``. ``--pad`` gives each sample a length drawn from 128-512
(its own numpy seed 0), so the padding bias holds real -0.5·f32-max
entries. The record has samples/s, ms a step, MFU
(``pretrain_flops_per_token`` x tokens/s over the card's bf16 peak) and
peak memory; ``--profile``/``--compare`` as for GPT (the plain arm: plain
attention).

``--model resnet50`` is ``bench.py``'s ResNet lane as written, through
the fluid surface of the port: ``Program`` + ``layers`` +
``models.resnet`` (depth 50, class_dim 1000) on a batch of 128 images
224² made on the card each step by ``uniform_random`` / ``randint`` ops,
``reduce_mean`` of ``softmax_with_cross_entropy``,
``contrib.mixed_precision.decorate(optimizer.Momentum(0.01, 0.9,
fuse=True), use_bf16=True)`` (bf16 AMP: every ``conv2d`` and ``mul`` on
bf16 casts of float32 master weights, loss scale 1.0; one
``fused_momentum`` op, one ``opt_momentum`` launch a step) and
``Executor(CUDAPlace(0)).run``; one warm step, then 10 timed. ``--no-amp``
is the float32 lane (no decorator; cuDNN may take TF32 for the
convolutions, PyTorch's default, which the record states); the record's
``config`` says which. ``--no-fuse`` is ``bench.py``'s exact optimizer:
one ``momentum`` op a parameter. The record has img/s, ms a step, MFU
(``program_train_flops`` over the card's bf16 dense peak, the
reference's convention), peak memory and the step's losses; with
``--profile N`` the device time a step by group: cuDNN convolutions,
batch norm, the optimizer sweep, the flat group's ``torch.cat``, other
(eager glue); with ``--host-profile N`` the host ms a step by function
under ``cProfile``. ``--compare`` runs the no-fuse and fused arms in
turns.

``--model encoder`` is the static-graph transformer encoder
(``models.transformer_encoder.transformer_encoder_classifier``) at
ERNIE-base's widths and depth (L 12, nh 12, D 768, d_ff 3072, V 30522,
max_pos 512, 2 classes, dropout 0.1) fine-tuning on batch 48 x 512 with a
[48, 1, 1, 512] padding bias from lengths drawn in 128-512 (the ERNIE
lane's ``--pad`` draw), under ``decorate(AdamW(linear_lr_warmup(
polynomial_decay(...)), weight_decay=0.01,
grad_clip=GradientClipByGlobalNorm(1.0), fuse=True),
amp_lists=AutoMixedPrecisionLists(custom_white_list=["multihead_matmul"]))``:
``multihead_matmul`` in bf16 through the flash bias kernels (12 launches
of each a step), one ``opt_adamw`` launch a step; one warm step, then 5
timed, every step on the same batch, copied to the card once. The record has
samples/s, ms a step, MFU (``encoder_flops_per_token``: 6 N over the
encoder's product weights plus the attention term, as ERNIE's, over the
card's bf16 peak), peak memory, the losses, each step's learning rate
and the products' compute dtypes in one more step
(``product_dtypes``); ``--profile 1`` adds one traced
step's device busy ms and the flash bias kernels' ms
(``utils/device_trace.py``).

``--model encoder --no-amp --recompute --optimizer lamb`` is the
recompute lane: the same encoder in float32 (TF32 off; the reference
cannot compose AMP with recompute) under ``RecomputeOptimizer(Lamb(5e-5,
lamb_weight_decay=0.01, exclude_from_weight_decay_fn=...))`` with each
layer's output as a checkpoint, against plain ``Lamb`` from one start
state: each arm's first step fetches every parameter's gradient and
reads its allocator peak; the recompute arm then times 3 steps (24
``flash_fwd_bias`` launches a step, the recomputation's 12 included, and
12 of each backward), the plain arm 1. The record has samples/s, ms a
step and over the plain arm's, MFU with and without the recompute
forward, each arm's peak, the first losses and the gradients' worst gap
across the arms.

``--model resnet50 --grad-merge K`` is the ResNet lane (bf16 AMP, fused
Momentum) under ``GradientMergeOptimizer(k_steps=K)``, fed K x 128
images: the forward and backward run K times a step, the optimizer tail
once (one ``opt_momentum`` launch); 4 steps on the fed batch (the loss
falls), one warm-up and 3 timed. The record has img/s over the fed batch,
ms a step, peak memory and the loss scale.

Two fluid lanes run over ranks, under ``python -m
paddle_tpu_torch.parallel.launch --nproc_per_node 2`` (each rank the
global batch, its own rows): ``--model encoder --no-amp --pp 2
--microbatches 4`` is the encoder at ERNIE-base's widths and depth, 48 x
512 with the padding bias, dropout 0.1, float32 (TF32 off) under
``PipelineOptimizer(AdamW(5e-5, weight_decay=0.01, grad_clip=
GradientClipByGlobalNorm(1.0), fuse=True))`` at a constant rate, cut
after layer 5, one stage a rank (24 launches of each flash bias kernel
and one ``opt_adamw`` a rank a step); ``--model resnet50 --dp 2`` is the
ResNet lane (bf16 AMP, fused Momentum) through ``CompiledProgram(main)
.with_data_parallel(loss_name=)`` on a fed 128 x 224² global batch, 64 a
rank (one ``opt_momentum`` a rank a step). ``--parity`` runs their gates
first (``run_fluid_parallel``); one gang runs both as ``--layout
model=encoder,pp=2,microbatches=4,no_amp=1 --layout
model=resnet50,dp=2``.

The fluid lanes run on the card unless ``--device cpu``; without a card
they refuse to run. ``--tiny`` cuts them to a CPU rehearsal's sizes
(ResNet-18 at 32², batch 4; a 2-layer encoder at D 64, T 32, batch 4).
"""
import argparse
import collections
import contextlib
import functools
import gc
import json
import os
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import clip as fluid_clip
from .. import framework as FW
from ..framework.registry import compute_dtypes
from .. import layers
from .. import optimizer as fluid_optimizer
from ..contrib import mixed_precision as MP
from ..device import resolve_device
from ..models import ernie as E
from ..models import gpt as G
from ..models import resnet as R
from ..models import transformer_encoder as TE
from ..observability import flight as obs_flight
from ..observability import goodput as obs_goodput
from ..observability import hw
from ..observability import metrics as obs_metrics
from ..observability import spans as obs_spans
from ..observability.monitor import TrainMonitor
from ..ops import cuda_kernels as CK
from ..ops.chunked_ce import CE_BWD_RANGE
from ..parallel import checkpoint as ckpt_mod
from ..parallel import comm_opt
from ..parallel import mesh as mesh_mod
from ..parallel import parallelize as PZ
from ..sharding import resolve_plan
from .profile_decode import trace_summary

# the training kernels' names in a trace (ops/csrc), each its own group;
# the CE forward's merge kernel counts with it
TRAIN_KERNELS = {k: k for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                "flash_bwd_dkv_kernel", "adamw_flat_kernel",
                                "fused_ln_fwd_kernel", "ln_bwd_kernel",
                                "ce_fwd")}
BATCH, SEQ = 16, 1024           # bench.py's GPT lane
ERNIE_BATCH, ERNIE_SEQ = 48, 512   # bench.py's ERNIE lane
RESNET_BATCH, RESNET_HW, RESNET_CLASSES = 128, 224, 1000   # its ResNet lane
# the ResNet step's kernels by group (first substring found); the rest of
# the cuDNN convolution kernels carry "xmma"/"gemm" and land in matmul;
# AMP's casts are dtype copies
RESNET_KERNELS = {"momentum_kernel": "opt_sweep", "CatArrayBatchedCopy":
                  "flat_cat", "batch_norm": "batch_norm", "bn_fw": "batch_norm",
                  "bn_bw": "batch_norm", "conv": "conv", "xmma": "conv",
                  "implicit": "conv", "wgrad": "conv", "dgrad": "conv",
                  "fprop": "conv", "direct_copy": "cast"}
STEPS, WARMUP = 10, 2


def _range_summary(prof, name: str, steps: int) -> Dict[str, float]:
    """Per step, for the profiler ranges called ``name``: the device time
    of the kernels their ops launched (``device_ms``), how many kernels,
    and the device-timeline span from each range's first kernel to its
    last (``device_span_ms``: kernels plus the gaps between them)."""
    def kernels(ev):
        return len(ev.kernels) + sum(kernels(c) for c in ev.cpu_children)

    cpu = torch.autograd.DeviceType.CPU
    evs = [e for e in prof.events() if e.name == name]
    host = [e for e in evs if e.device_type == cpu]
    spans = [e for e in evs if e.device_type != cpu]
    return {"device_ms_per_step":
            sum(e.device_time_total for e in host) / 1e3 / steps,
            "device_span_ms_per_step": sum(
                e.time_range.end - e.time_range.start for e in spans)
            / 1e3 / steps,
            "kernels_per_step": sum(kernels(e) for e in host) / steps,
            "ranges_per_step": len(host) / steps}


def monitored_steps(step_once, mon: TrainMonitor, steps: int) -> list:
    """``steps`` calls of ``step_once`` (its outputs ``(params, opt, loss,
    grad_norm)``), each one :class:`TrainMonitor` row: dispatch is the
    call, device wait the copy of the loss and grad norm to the host (the
    step's sync), and the flight recorder's ``step_begin`` / ``step_end``
    bracket it."""
    outs = []
    for _ in range(steps):
        obs_flight.event("step_begin", step=mon.step_count + 1)
        with mon.step() as s:
            out = step_once()
            s.dispatched()
            s.observe(loss=out[2], grad_norm=out[3])
        obs_flight.event("step_end", step=mon.step_count)
        outs.append(out)
    return outs


def _timed(step_once, dev, warmup: int = WARMUP,
           mon: TrainMonitor = None, steps: int = STEPS):
    """``warmup`` calls of ``step_once`` (one train step, updating its
    state in place), then ``steps`` more with the launch counts and the
    peak memory zeroed just before them, ending in one synchronize. With
    ``mon``, the timed steps are :func:`monitored_steps` (one sync each)
    inside a goodput run window. Returns (every step's outputs, warm-up
    seconds, timed seconds, launches per timed step, the window's goodput
    report or None)."""
    outs = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        outs.append(step_once())
    _sync(dev)
    warm_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CK.reset_launches()
    report = None
    t0 = time.perf_counter()
    if mon is None:
        for _ in range(steps):
            outs.append(step_once())
    else:
        led = obs_goodput.ledger()
        led.start_window()
        outs += monitored_steps(step_once, mon, steps)
        report = led.end_window()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: v / steps for k, v in CK.LAUNCHES.items() if v}
    return outs, warm_s, wall, launches, report


def _peak_bytes(dev):
    """The card's peak allocated bytes since the timed window opened;
    None on the CPU (no device metric)."""
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)


def set_observability(on: bool) -> None:
    """Span tracing, the flight recorder and the metrics registry on or
    off together (the overhead pairs' switch)."""
    obs_spans.set_tracing_enabled(on)
    obs_flight.set_flight_enabled(on)
    obs_metrics.set_metrics_enabled(on)


def observability_overhead(step_once, dev, work_dir: str, pairs: int = 10,
                           steps: int = 6) -> Dict[str, Any]:
    """The train step's host cost of the observability, arms in turns
    (on, off, off, on, ...: each pair's order flipped, so a drift of the
    host's speed falls on both arms): "on" is :func:`monitored_steps` with
    a monitor row file, a flight sidecar in ``work_dir`` and a goodput
    window; "off" is the same steps with tracing, the flight recorder and
    the metrics registry switched off and the same per-step sync (the
    loss and grad norm copied to the host). ms a step per arm run, summed
    up by :func:`overhead_record`."""
    arms = {True: [], False: []}
    mon = TrainMonitor(path=os.path.join(work_dir, "overhead_rows.jsonl"),
                       peak_flops=1.0)
    sink = obs_flight.default_recorder()
    sink.set_sink(os.path.join(work_dir, "overhead_flight.jsonl"))
    led = obs_goodput.ledger()
    try:
        for i in range(pairs):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                set_observability(on)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                if on:
                    led.start_window()
                    monitored_steps(step_once, mon, steps)
                    led.end_window()
                else:
                    for _ in range(steps):
                        out = step_once()
                        float(out[2])
                        float(out[3])
                arms[on].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        set_observability(True)
        sink.set_sink(None)
        mon.close()
    return overhead_record(arms[True], arms[False])


def overhead_record(on_ms: List[float], off_ms: List[float]
                    ) -> Dict[str, Any]:
    """On/off arm times, in run order (pair i = ``on_ms[i]``,
    ``off_ms[i]``) -> the record: both lists; the overhead of the mins,
    and the median of the pairs' differences (each pair's two arms ran
    back to back, so a drift of the host's speed cancels in it), in
    percent of the off arm's median; the share of pairs in which the on
    arm was the slower; the off arm's spread (max - min over its
    median)."""
    off_med = float(np.median(off_ms))
    diffs = [a - b for a, b in zip(on_ms, off_ms)]
    return {"on_ms": on_ms, "off_ms": off_ms,
            "overhead_pct": (min(on_ms) - min(off_ms)) / min(off_ms) * 100,
            "paired_overhead_pct": float(np.median(diffs)) / off_med * 100,
            "on_slower_share": sum(d > 0 for d in diffs) / len(diffs),
            "off_spread_pct": (max(off_ms) - min(off_ms)) / off_med * 100}


def _profile(step, state, steps: int) -> Dict[str, Any]:
    """Trace ``steps`` train steps (``state`` = [params, opt, tokens,
    labels], or [params, opt, batch] for ERNIE); device time per step as
    ``profile_decode.trace_summary``,
    and the vocab-chunked CE's backward sweep on its own (its kernels are
    the generic ones of the other groups)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state[:2] = step(*state)[:2]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"steps": steps,
            **trace_summary(prof, wall_us, steps, "step", TRAIN_KERNELS),
            "ce_bwd_sweep": _range_summary(prof, CE_BWD_RANGE, steps)}


def bench_config(remat_policy: str = "dots", fused_ln: bool = False,
                 ce_vchunk: int = 0) -> G.GPTConfig:
    """bench.py's accelerator GPT lane with the tuned train winner
    (``dots`` remat; the flat sweep is chosen in :func:`run`), with the
    fused-layernorm block and the vocab-chunked CE when asked."""
    cfg = G.GPT_SMALL.scaled(max_seq_len=SEQ, use_flash=True,
                             remat=remat_policy != "none",
                             remat_policy=remat_policy, fused_ln=fused_ln)
    if ce_vchunk:
        cfg = cfg.scaled(ce_vocab_chunk=ce_vchunk, ce_direct_bytes_limit=0)
    return cfg


def plain_config(cfg: G.GPTConfig) -> G.GPTConfig:
    """``cfg`` with every kernel lever off: plain attention, the plain
    layernorm and the row-chunked CE (or the direct one, by
    ``ce_direct_bytes_limit``)."""
    return cfg.scaled(use_flash=False, fused_ln=False, ce_vocab_chunk=0)


def load_tuned(path: str, dev) -> Dict[str, Any]:
    """The fingerprint-gated TUNED.json at ``path`` for ``dev``, or None
    when it was tuned elsewhere; prints "applied" or "REFUSED"."""
    from ..tuning import probe as tuning_probe
    from ..tuning import tuned as tuned_mod

    doc = tuned_mod.load_for_device(path, tuning_probe.device_info(dev))
    print(f"[train_bench] tuned config "
          f"{'applied' if doc else 'REFUSED'} from {path}", flush=True)
    return doc


def tuned_config(cfg: G.GPTConfig, doc, args) -> G.GPTConfig:
    """``cfg`` with the tuned model knobs where the flags were left at
    their defaults (``--remat``, ``--fused-ln``, ``--ce-vchunk``)."""
    from ..tuning import tuned as tuned_mod

    ap = _parser()
    ck = tuned_mod.train_cfg_kwargs(doc)
    if args.remat != ap.get_default("remat"):
        ck.pop("remat", None)
        ck.pop("remat_policy", None)
    if args.fused_ln:
        ck.pop("fused_ln", None)
    if args.ce_vchunk:
        ck.pop("ce_vocab_chunk", None)
        ck.pop("ce_direct_bytes_limit", None)
    return cfg.scaled(**ck) if ck else cfg


def run(cfg: G.GPTConfig, fused_opt_kernel=None,
        profile_steps: int = 0, monitor: str = None,
        overhead_dir: str = None, tuned=None) -> Dict[str, Any]:
    """WARMUP + STEPS train steps on one batch on the card; the timed
    steps end in one synchronize, and launch counts are zeroed just before
    them (then ``profile_steps`` traced steps, outside the counts and
    losses). ``monitor`` (a path) makes the timed steps monitored: one
    :class:`TrainMonitor` row a step there, one sync a step, the goodput
    window's report in the record (``monitor``). ``overhead_dir`` then
    adds :func:`observability_overhead`'s pairs (``obs_overhead``).
    ``tuned`` (a loaded TUNED.json) goes to ``init_sharded`` and
    ``make_train_step``."""
    dev = torch.device("cuda")
    batch, T, steps, warmup = BATCH, SEQ, STEPS, WARMUP
    params, opt = PZ.init_sharded(cfg, seed=0, moment_dtype=torch.bfloat16,
                                  fused_opt=True, device=dev, tuned=tuned)
    n_params = G.num_params(params)
    step = PZ.make_train_step(cfg, lr=1e-4, weight_decay=0.1,
                              fused_opt=True,
                              fused_opt_kernel=fused_opt_kernel,
                              grad_clip=1.0, device=dev, tuned=tuned)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, batch, T))
                              ).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, batch, T))
                              ).to(dev)
    flops = G.train_flops_per_token(cfg, n_params, T)
    name = torch.cuda.get_device_name(dev)
    config = (f"gpt_small_L{cfg.num_layers}_b{batch}x{T}"
              + ("_fln" if cfg.fused_ln else "")
              + (f"_vchunk{cfg.ce_vocab_chunk}" if cfg.ce_vocab_chunk
                 else ""))
    mon = None
    if monitor:
        mon = TrainMonitor(
            path=monitor, examples_per_step=batch, tokens_per_step=batch * T,
            flops_per_step=flops * batch * T,
            peak_flops=hw.peaks_for(name)["bf16_flops_per_s"],
            extra_static={"config": config})

    def step_once():
        return step(params, opt, tokens, labels)

    outs, warm_s, wall, launches, report = _timed(step_once, dev, mon=mon)
    losses = [float(o[2]) for o in outs]
    tok_s = steps * batch * T / wall
    rec = {
        "config": config,
        "device": name,
        "model_params": n_params,
        "batch": batch, "seq_len": T, "steps": steps, "warmup": warmup,
        "remat_policy": cfg.remat_policy if cfg.remat else "none",
        "flash": cfg.use_flash,
        "fused_ln": cfg.fused_ln,
        "ce_vocab_chunk": cfg.ce_vocab_chunk,
        "moment_dtype": "bfloat16",
        "tokens_per_s": tok_s,
        "mfu": tok_s * flops / hw.peaks_for(name)["bf16_flops_per_s"],
        "ms_per_step": wall / steps * 1e3,
        "warmup_s": warm_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses,
        "grad_norm_last": float(outs[-1][3]),
        "launches_per_step": launches,
    }
    if mon is not None:
        mon.close()
        rec["monitor"] = {"path": monitor, "rows": mon.step_count,
                          "goodput": report}
        if overhead_dir:
            rec["obs_overhead"] = observability_overhead(
                step_once, dev, overhead_dir)
    if profile_steps:
        rec["profile"] = _profile(step, [params, opt, tokens, labels],
                                  profile_steps)
    return rec


def ernie_config(fused_ln: bool = False) -> E.ErnieConfig:
    """bench.py's ERNIE lane: ERNIE_BASE, bf16 compute, flash on, remat
    off; the post-LN residual adds through the fused-LN kernels when
    asked."""
    return E.ERNIE_BASE.scaled(dtype=torch.bfloat16, use_flash=True,
                               remat=False, fused_ln=fused_ln)


def ernie_batch(cfg: E.ErnieConfig, batch: int, T: int,
                pad: bool = False) -> Dict[str, np.ndarray]:
    """bench.py's synthetic pretraining batch (numpy seed 0, the same
    draws in the same order); with ``pad``, per-sample lengths drawn from
    128-512 (capped at T) by their own numpy seed 0 set the pad mask."""
    rng = np.random.default_rng(0)
    M = cfg.max_masked
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, T),
                               dtype=np.int32),
        "seg_ids": rng.integers(0, 2, (batch, T), dtype=np.int32),
        "pad_mask": np.ones((batch, T), bool),
        "mlm_pos": rng.integers(0, T, (batch, M), dtype=np.int32),
        "mlm_ids": rng.integers(0, cfg.vocab_size, (batch, M),
                                dtype=np.int32),
        "mlm_valid": np.ones((batch, M), bool),
        "nsp_label": rng.integers(0, 2, (batch,), dtype=np.int32),
    }
    if pad:
        lens = np.minimum(np.random.default_rng(0).integers(
            128, 513, size=batch), T)
        out["pad_mask"] = np.arange(T)[None, :] < lens[:, None]
    return out


def run_ernie(cfg: E.ErnieConfig, pad: bool = False,
              profile_steps: int = 0) -> Dict[str, Any]:
    """WARMUP + STEPS pretrain steps on one batch on the card, timed and
    counted as :func:`run` does."""
    dev = torch.device("cuda")
    batch, T, steps, warmup = ERNIE_BATCH, ERNIE_SEQ, STEPS, WARMUP
    params = E.init_params(cfg, seed=0, device=dev)
    opt = E.init_opt(params)
    n_params = E.num_params(params)
    step = E.make_pretrain_step(cfg, lr=1e-4, device=dev)
    data = E.batch_to_device(ernie_batch(cfg, batch, T, pad), dev)
    outs, warm_s, wall, launches, _ = _timed(
        lambda: step(params, opt, data), dev)
    losses = [float(o[2]) for o in outs]
    samples_s = steps * batch / wall
    flops = E.pretrain_flops_per_token(cfg, n_params, T)
    name = torch.cuda.get_device_name(dev)
    rec = {
        "config": (f"ernie_L{cfg.num_layers}_b{batch}x{T}"
                   + ("_pad" if pad else "")
                   + ("_fln" if cfg.fused_ln else "")
                   + (f"_vchunk{cfg.ce_vocab_chunk}"
                      if cfg.ce_vocab_chunk else "")),
        "device": name,
        "model_params": n_params,
        "batch": batch, "seq_len": T, "steps": steps, "warmup": warmup,
        "real_tokens_per_step": int(data["pad_mask"].sum()),
        "remat_policy": cfg.remat_policy if cfg.remat else "none",
        "flash": cfg.use_flash,
        "samples_per_s": samples_s,
        "tokens_per_s": samples_s * T,
        "mfu": samples_s * T * flops
        / hw.peaks_for(name)["bf16_flops_per_s"],
        "ms_per_step": wall / steps * 1e3,
        "warmup_s": warm_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses,
        "launches_per_step": launches,
    }
    if profile_steps:
        rec["profile"] = _profile(step, [params, opt, data], profile_steps)
    return rec


def resnet_program(batch: int = RESNET_BATCH, hw: int = RESNET_HW,
                   classes: int = RESNET_CLASSES, depth: int = 50,
                   fuse: bool = True, synthetic: bool = True,
                   amp: bool = False, merge_k: int = 0):
    """(main, startup, loss) of ``bench.py``'s ResNet lane: the images and
    labels made by ``uniform_random`` / ``randint`` ops each step, or, with
    ``synthetic=False``, fed through ``layers.data`` ("img", "label");
    with ``amp``, the optimizer decorated for bf16 AMP as ``bench.py``
    decorates it; with ``merge_k``, that under
    ``GradientMergeOptimizer(k_steps=merge_k)`` (fed data only)."""
    main, startup = FW.Program(), FW.Program()
    with FW.program_guard(main, startup):
        if synthetic:
            img = layers.uniform_random([batch, 3, hw, hw], min=-1.0,
                                        max=1.0, dtype="float32")
            img.stop_gradient = True
            label = layers.randint(0, classes, shape=[batch, 1],
                                   dtype="int64")
        else:
            img = layers.data("img", [3, hw, hw], dtype="float32")
            label = layers.data("label", [1], dtype="int64")
        logits = R.resnet(img, class_dim=classes, depth=depth)
        loss = layers.reduce_mean(
            layers.softmax_with_cross_entropy(logits, label))
        opt = fluid_optimizer.Momentum(0.01, 0.9, fuse=fuse)
        if amp:
            opt = MP.decorate(opt, use_bf16=True)
        if merge_k:
            opt = fluid_optimizer.GradientMergeOptimizer(opt,
                                                         k_steps=merge_k)
        opt.minimize(loss)
    return main, startup, loss


def _host_profile(step_once, steps: int, top: int = 8) -> Dict[str, Any]:
    """``steps`` calls of ``step_once`` under ``cProfile`` (ending in one
    synchronize): host ms a step by function, the ``top`` by own time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(steps):
        step_once()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    return {"steps": steps, "wall_ms_per_step": wall / steps * 1e3,
            "top_own_ms_per_step": [
                [f"{fn}:{line}({name})"[-90:], tt / steps * 1e3,
                 nc / steps]
                for (fn, line, name), (_cc, nc, tt, _ct, _callers) in rows]}


def _place(dev):
    return FW.CPUPlace() if dev.type == "cpu" else FW.CUDAPlace(
        dev.index or 0)


def _device_name(dev) -> str:
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def _mfu(flops_per_s: float, dev):
    """``flops_per_s`` over the card's bf16 dense peak; None on the CPU
    (no device metric)."""
    if dev.type == "cpu":
        return None
    return flops_per_s / hw.peaks_for(_device_name(dev))["bf16_flops_per_s"]


# the fluid lanes' product ops and the slots whose dtypes each computes in
PRODUCT_SLOTS = {"conv2d": ("Input", "Filter"), "mul": ("X", "Y"),
                 "matmul": ("X", "Y"),
                 "multihead_matmul": ("Input", "W", "Bias")}


def product_dtypes(main, step_once) -> Dict[str, Any]:
    """One more step under ``registry.compute_dtypes``: the program's
    product ops by type (``ops``) and that step's calls by the dtype each
    computed in (``calls``, ``"type:dtype"`` -> count) — what the
    lowerings were given, not the vars' labels."""
    ops = collections.Counter(op.type for op in main.global_block().ops
                              if op.type in PRODUCT_SLOTS)
    with compute_dtypes({t: PRODUCT_SLOTS[t] for t in ops}) as seen:
        step_once()
    return {"ops": dict(ops),
            "calls": {f"{t}:{d}": n for (t, d), n in sorted(seen.items())}}


def run_resnet(fuse: bool = True, profile_steps: int = 0,
               host_profile_steps: int = 0, amp: bool = True,
               device: str = "cuda", tiny: bool = False,
               steps: int = STEPS) -> Dict[str, Any]:
    """One warm step and ``steps`` timed ones of the ResNet lane, as
    ``bench.py``'s lane runs them (bf16 AMP unless ``amp`` is False),
    counted as :func:`run` does (each step's loss fetched as a device
    tensor, read after the timed window); then one step for
    :func:`product_dtypes`; then ``profile_steps`` steps
    under ``torch.profiler`` and ``host_profile_steps`` under
    ``cProfile``. ``tiny``: ResNet-18 at 32², batch 4, class 4."""
    dev = resolve_device(device)
    batch, hw_, classes, depth = ((4, 32, 4, 18) if tiny else
                                  (RESNET_BATCH, RESNET_HW, RESNET_CLASSES,
                                   50))
    main, startup, loss = resnet_program(batch, hw_, classes, depth,
                                         fuse=fuse, amp=amp)
    exe = FW.Executor(_place(dev))
    scope = FW.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters()
                   if p.trainable)
    outs, warm_s, wall, launches, _ = _timed(
        lambda: exe.run(main, fetch_list=[loss], scope=scope,
                        return_numpy=False)[0], dev, warmup=1, steps=steps)
    losses = [float(o) for o in outs]
    img_s = steps * batch / wall
    flops = hw.program_train_flops(main, batch)
    name = _device_name(dev)
    rec = {
        "config": f"resnet{depth}_b{batch}_{hw_}px_"
                  + ("bf16amp" if amp else "f32")
                  + ("_fused" if fuse else "_nofuse"),
        "device": name,
        "amp": "bf16" if amp else None,
        "model_params": n_params,
        "batch": batch, "image": hw_, "steps": steps, "warmup": 1,
        "fuse": fuse,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "flops_per_step": flops,
        "images_per_s": img_s,
        "mfu": _mfu(img_s * flops / batch, dev),
        "ms_per_step": wall / steps * 1e3,
        "warmup_s": warm_s,
        "peak_mem_bytes": _peak_bytes(dev),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses,
        "launches_per_step": launches,
        "product_dtypes": product_dtypes(main, lambda: exe.run(
            main, fetch_list=[loss], scope=scope, return_numpy=False)),
    }
    rec.update(_step_profiles(lambda: exe.run(main, scope=scope), dev,
                              profile_steps, host_profile_steps))
    return rec


def _step_profiles(step_once, dev, profile_steps: int,
                   host_profile_steps: int) -> Dict[str, Any]:
    """The ResNet lanes' profiles: ``profile_steps`` more steps under
    ``torch.profiler`` (``profile``: device time a step by group) and
    ``host_profile_steps`` under ``cProfile`` (``host_profile``)."""
    out: Dict[str, Any] = {}
    if profile_steps:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_steps):
                step_once()
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        out["profile"] = {"steps": profile_steps, **trace_summary(
            prof, wall_us, profile_steps, "step", RESNET_KERNELS)}
    if host_profile_steps:
        out["host_profile"] = _host_profile(step_once, host_profile_steps)
    return out


def resnet_fixed_batch(steps: int = 6, fuse: bool = True, seed: int = 0,
                       amp: bool = False):
    """``steps`` steps of the ResNet lane's model on one fixed fed batch
    (numpy seed ``seed``): (the losses, which must fall as the batch is
    learnt; the program; its scope after the steps)."""
    main, startup, loss = resnet_program(fuse=fuse, synthetic=False,
                                         amp=amp)
    exe = FW.Executor(FW.CUDAPlace(0))
    scope = FW.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(seed)
    feed = {"img": rng.uniform(-1, 1, (RESNET_BATCH, 3, RESNET_HW,
                                       RESNET_HW)).astype(np.float32),
            "label": rng.integers(0, RESNET_CLASSES, (RESNET_BATCH, 1))}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, main, scope


# ---------------------------------------------------------------------------
# the fluid transformer encoder lane (``--model encoder``)
# ---------------------------------------------------------------------------

# ERNIE-base's widths and depth, and a CPU rehearsal's
ENCODER = dict(num_layers=12, num_heads=12, d_model=768, d_ff=3072,
               vocab_size=30522, max_pos=512, num_classes=2)
ENCODER_TINY = dict(num_layers=2, num_heads=4, d_model=64, d_ff=128,
                    vocab_size=1000, max_pos=32, num_classes=2)
ENCODER_BATCH, ENCODER_SEQ, ENCODER_STEPS = 48, 512, 5
ENCODER_DROPOUT = 0.1
# the schedule: linear warm-up to ENCODER_LR over ENCODER_WARMUP steps,
# then polynomial (linear) decay to 0 over ENCODER_DECAY steps
ENCODER_LR, ENCODER_WARMUP, ENCODER_DECAY = 5e-5, 3, 100
ENCODER_FLASH = ("flash_fwd_bias", "flash_bwd_dq_bias", "flash_bwd_dkv_bias")
# the pipelined lane's microbatches a step (``--microbatches``' default)
PIPE_MICROBATCHES = 4
_PAD_BIAS = -0.5 * float(np.finfo(np.float32).max)


def encoder_no_decay(param) -> bool:
    """The LAMB recipe's exclusion: no weight decay on a layernorm's
    scale or shift, or on a bias."""
    return "_ln" in param.name or param.name.endswith((".b_0", "_b"))


def encoder_checkpoints(main, name: str = "enc") -> List[Any]:
    """Each encoder layer's ``_ln2`` output (the layer's output: the
    recompute lane's checkpoints), found by the layer norm's scale
    parameter ``{name}_l{i}_ln2.w_<n>``, in layer order."""
    block = main.global_block()
    found = {}
    for op in block.ops:
        if op.type != "layer_norm":
            continue
        scale = op.input("Scale")[0]
        head, _, tail = scale.partition("_ln2.")
        if head.startswith(name + "_l") and tail[:2] == "w_" and \
                tail[2:].isdigit():
            found.setdefault(int(head[len(name) + 2:]),
                             block.var(op.output("Y")[0]))
    return [found[i] for i in sorted(found)]


def encoder_program(cfg: Dict[str, int], seq: int,
                    dropout: float = ENCODER_DROPOUT, amp: bool = True,
                    fuse: bool = True, optimizer: str = "adamw",
                    recompute: bool = False, pipeline: int = 0,
                    microbatches: int = PIPE_MICROBATCHES):
    """(main, startup, loss, lr) of the encoder lane: the classifier over
    fed ``src`` / ``pos`` ids, a fed ``bias`` [B, 1, 1, seq] and ``label``.
    ``optimizer`` "adamw": AdamW (weight decay 0.01, global-norm clip
    1.0, ``fuse``) on the warm-up / decay schedule (``lr`` its var);
    "adamw_const": that AdamW at the constant ENCODER_LR (``lr`` None);
    "lamb": Lamb at ENCODER_LR (weight decay 0.01, none on
    layernorms and biases: ``encoder_no_decay``; ``lr`` None). No
    schedule under Lamb: a recomputed segment re-emits the schedule's
    in-place step increment, reading a renamed counter no op writes, in
    the reference as here (ROADMAP C).
    ``recompute``: under ``RecomputeOptimizer`` with each layer's output
    as a checkpoint (``encoder_checkpoints``). With ``amp``, decorated for
    bf16 with ``multihead_matmul`` on the white list (not with
    ``recompute``: the two refuse each other, as in the reference).
    ``pipeline`` S: under ``PipelineOptimizer`` in S stages cut after
    layer L / S - 1 (and so on), ``microbatches`` a step (with
    "adamw_const" and without ``amp``: the reference runs neither an LR
    schedule nor AMP under the pipeline, and the port refuses both)."""
    main, startup = FW.Program(), FW.Program()
    main.random_seed = startup.random_seed = 7
    with FW.program_guard(main, startup):
        src = layers.data("src", [seq], dtype="int64")
        pos = layers.data("pos", [seq], dtype="int64")
        label = layers.data("label", [1], dtype="int64")
        bias = layers.data("bias", [1, 1, seq], dtype="float32")
        loss, _logits = TE.transformer_encoder_classifier(
            src, pos, label, attn_bias=bias, dropout=dropout, **cfg)
        if optimizer == "lamb":
            lr = None
            opt = fluid_optimizer.Lamb(
                ENCODER_LR, lamb_weight_decay=0.01,
                exclude_from_weight_decay_fn=encoder_no_decay)
        else:
            lr = None if optimizer == "adamw_const" else \
                layers.linear_lr_warmup(
                    layers.polynomial_decay(ENCODER_LR, ENCODER_DECAY,
                                            end_learning_rate=0.0),
                    ENCODER_WARMUP, 0.0, ENCODER_LR)
            opt = fluid_optimizer.AdamW(
                ENCODER_LR if lr is None else lr, weight_decay=0.01,
                fuse=fuse, grad_clip=fluid_clip.GradientClipByGlobalNorm(1.0))
        if pipeline:
            ckpts = encoder_checkpoints(main)
            per = len(ckpts) // pipeline
            opt = fluid_optimizer.PipelineOptimizer(
                opt, cut_list=[[ckpts[(i + 1) * per - 1]]
                               for i in range(pipeline - 1)],
                num_microbatches=microbatches)
        if recompute:
            opt = fluid_optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(encoder_checkpoints(main))
        if amp:
            opt = MP.decorate(opt, amp_lists=MP.AutoMixedPrecisionLists(
                custom_white_list=["multihead_matmul"]))
        opt.minimize(loss)
    return main, startup, loss, lr


def encoder_lr(step: int) -> float:
    """The schedule's learning rate at run ``step`` (1-based: the LR
    counter's value in that run)."""
    if step < ENCODER_WARMUP:
        return step * ENCODER_LR / ENCODER_WARMUP
    return (1.0 - min(step, ENCODER_DECAY) / ENCODER_DECAY) * ENCODER_LR


def encoder_batch(cfg: Dict[str, int], batch: int, seq: int, dev,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
    """One fine-tuning batch on ``dev``: token ids and labels from numpy
    seed ``seed``, positions 0..seq-1, and the padding bias (0 at real
    keys, -0.5 f32 max past each row's length; lengths drawn in 128-512
    by their own numpy seed 0, as the ERNIE lane's ``--pad`` draws them,
    or in seq/4..seq below 128)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, cfg["vocab_size"], (batch, seq))
    label = rng.integers(0, cfg["num_classes"], (batch, 1))
    draw = np.random.default_rng(0)
    lens = (np.minimum(draw.integers(128, 513, size=batch), seq)
            if seq >= 128 else draw.integers(seq // 4, seq + 1, size=batch))
    bias = np.where(np.arange(seq)[None] < lens[:, None], 0.0, _PAD_BIAS)
    host = {"src": src, "pos": np.tile(np.arange(seq), (batch, 1)),
            "label": label,
            "bias": bias.astype(np.float32)[:, None, None, :]}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in host.items()}


def encoder_flops_per_token(cfg: Dict[str, int], seq: int) -> int:
    """Forward + backward FLOPs a token of the encoder, by the numerator
    ERNIE and GPT share (``hw.transformer_train_flops_per_token``): 6 N
    over the QKV, output and FFN weights (4·D² + 2·D·d_ff a layer) plus
    attention's 12·L·D·seq; embeddings and the head left out."""
    D, L = cfg["d_model"], cfg["num_layers"]
    n_dense = L * (4 * D * D + 2 * D * cfg["d_ff"])
    return hw.transformer_train_flops_per_token(n_dense, L, D, seq)


def encoder_trace(step_once, dev, trace_dir: str) -> Dict[str, Any]:
    """One step under ``utils/device_trace.capture`` (its work run once
    more first as the warm-up): the device busy ms, the flash bias
    kernels' device ms, the launches in the captured step, and the
    kernel ms by group (each port kernel, matrix products, other) and
    the top kernels (``profile_decode.trace_summary``)."""
    from ..utils import device_trace as DT

    with DT.capture(trace_dir, device=dev, warmup=step_once) as cap:
        step_once()
    rows, source = DT.kernel_rows(cap.pd, costs=cap.costs)
    busy = sum(r["ns"] for r in rows) / 1e6
    flash = {k: sum(r["ns"] for r in rows if r["kernel"] == k) / 1e6
             for k in ENCODER_FLASH}
    summary = trace_summary(cap.pd, cap.wall_ns / 1e3, 1, "step")
    return {"source": source, "busy_ms": busy,
            "wall_ms": cap.wall_ns / 1e6, "flash_bias_ms": flash,
            "flash_bias_share": (sum(flash.values()) / busy if busy
                                 else 0.0),
            "launches": cap.launches,
            "group_ms": summary["group_ms_per_step"],
            "top_kernels_ms": summary["top_kernels_ms_per_step"]}


def run_encoder(device: str = "cuda", tiny: bool = False,
                profile_steps: int = 0,
                trace_dir: str = "perf_runs/encoder_trace"
                ) -> Dict[str, Any]:
    """One warm step and ENCODER_STEPS timed ones of the encoder lane,
    counted as :func:`run` does (the loss and the learning rate fetched as
    device tensors, read after the timed window); then one step for
    :func:`product_dtypes`; with ``profile_steps``, one more step traced
    (:func:`encoder_trace`)."""
    dev = resolve_device(device)
    cfg = ENCODER_TINY if tiny else ENCODER
    batch, seq = (4, 32) if tiny else (ENCODER_BATCH, ENCODER_SEQ)
    main, startup, loss, lr = encoder_program(cfg, seq)
    exe = FW.Executor(_place(dev))
    scope = FW.Scope()
    exe.run(startup, scope=scope)
    feed = encoder_batch(cfg, batch, seq, dev)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters()
                   if p.trainable)

    def step_once():
        return exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope,
                       return_numpy=False)

    outs, warm_s, wall, launches, _ = _timed(step_once, dev, warmup=1,
                                             steps=ENCODER_STEPS)
    losses = [float(o[0]) for o in outs]
    lrs = [float(o[1].reshape(-1)[0]) for o in outs]
    samples_s = ENCODER_STEPS * batch / wall
    flops = encoder_flops_per_token(cfg, seq)
    rec = {
        "config": (f"encoder_L{cfg['num_layers']}_D{cfg['d_model']}"
                   f"_b{batch}x{seq}_pad_bf16amp_adamw_fused"),
        "device": _device_name(dev),
        "model_params": n_params,
        "batch": batch, "seq_len": seq, "steps": ENCODER_STEPS,
        "warmup": 1, "dropout": ENCODER_DROPOUT,
        "real_tokens_per_step": int((feed["bias"] == 0).sum()),
        "samples_per_s": samples_s,
        "mfu": _mfu(samples_s * seq * flops, dev),
        "ms_per_step": wall / ENCODER_STEPS * 1e3,
        "warmup_s": warm_s,
        "peak_mem_bytes": _peak_bytes(dev),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses, "lrs": lrs,
        "lrs_want": [encoder_lr(i + 1) for i in range(len(lrs))],
        "launches_per_step": launches,
        "product_dtypes": product_dtypes(main, step_once),
    }
    if profile_steps:
        rec["trace"] = encoder_trace(step_once, dev, trace_dir)
    return rec


# the recompute lane (``--model encoder --no-amp --recompute --optimizer
# lamb``): each arm's timed steps after its first
RECOMPUTE_STEPS, RECOMPUTE_PLAIN_STEPS = 3, 1


def _grad_fetches(main) -> Dict[str, str]:
    """Each parameter's gradient var, as its update op reads it."""
    return {op.input("Param")[0]: op.input("Grad")[0]
            for op in main.global_block().ops
            if op.type in ("lamb", "adam", "adamw", "momentum", "sgd")}


def _encoder_arm(cfg, batch, seq, dev, start, recompute: bool,
                 steps: int, profile_steps: int = 0,
                 trace_dir: str = "") -> Dict[str, Any]:
    """One arm of the recompute lane from the start state ``start`` (name
    -> host tensor): the first step fetches the loss and every
    parameter's gradient (kept on the host), its peak allocated bytes
    read (the counter reset just before it); then ``steps`` timed steps
    as :func:`_timed` counts them; with ``profile_steps``, one more
    traced (:func:`encoder_trace` into ``trace_dir``)."""
    from ..framework import unique_name

    with unique_name.guard():
        main, _startup, loss, _ = encoder_program(
            cfg, seq, amp=False, optimizer="lamb", recompute=recompute)
    exe = FW.Executor(_place(dev))
    scope = FW.Scope()
    for n, v in start.items():
        scope.set_var(n, v.to(dev, copy=True))
    feed = encoder_batch(cfg, batch, seq, dev)
    grads = _grad_fetches(main)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first = exe.run(main, feed=feed, fetch_list=[loss, *grads.values()],
                    scope=scope, return_numpy=False)
    _sync(dev)
    first_peak = _peak_bytes(dev)
    out = {"loss": float(first[0]),
           "grads": {p: g.cpu() for p, g in zip(grads, first[1:])}}
    del first

    def step_once():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    outs, _warm, wall, launches, _ = _timed(step_once, dev, warmup=0,
                                            steps=steps)
    out.update(losses=[out["loss"]] + [float(o) for o in outs],
               first_peak=first_peak,
               peak=_peak_bytes(dev), ms_per_step=wall / steps * 1e3,
               launches_per_step=launches, main=main)
    if profile_steps:
        out["trace"] = encoder_trace(step_once, dev, trace_dir)
    return out


def run_encoder_recompute(device: str = "cuda", tiny: bool = False,
                          profile_steps: int = 0) -> Dict[str, Any]:
    """The recompute lane: the encoder at ERNIE-base's widths and depth
    (``tiny``: ENCODER_TINY, 4 x 32), batch 48 x 512 with the padding
    bias, float32, under ``RecomputeOptimizer(Lamb)`` with each layer's
    output as a checkpoint, against the same model under plain ``Lamb``,
    both from one start state (the startup run once, kept on the host).
    The recompute arm: a first step, then RECOMPUTE_STEPS timed ones; the
    plain arm: a first step, then RECOMPUTE_PLAIN_STEPS timed. Each
    arm's first step fetches the loss and every parameter's gradient
    (``first_loss``, ``grad_gap``: the worst gradient's max |diff| over
    its largest |value|, across the arms) and reads its allocator peak
    (``peak_bytes``); launches per timed step are the recompute arm's.
    MFU by ``encoder_flops_per_token`` (the model's FLOPs), and with the
    recompute forward (2 N + 4·L·D·T a token more: 4/3 of it, every
    layer being recomputed). With ``profile_steps``, one more step of
    each arm traced (``trace``: :func:`encoder_trace`, by arm, into
    ``perf_runs/encoder_rc_trace``)."""
    from ..framework import unique_name

    dev = resolve_device(device)
    cfg = ENCODER_TINY if tiny else ENCODER
    batch, seq = (4, 32) if tiny else (ENCODER_BATCH, ENCODER_SEQ)
    with unique_name.guard():
        main, startup, _loss, _ = encoder_program(
            cfg, seq, amp=False, optimizer="lamb", recompute=True)
    scope = FW.Scope()
    FW.Executor(_place(dev)).run(startup, scope=scope)
    start = {n: scope.find_var(n).cpu()
             for n, v in main.global_block().vars.items()
             if v.persistable and scope.find_var(n) is not None}
    del scope
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    with _no_tf32():
        rc = _encoder_arm(cfg, batch, seq, dev, start, True,
                          RECOMPUTE_STEPS, profile_steps,
                          "perf_runs/encoder_rc_trace/recompute")
        gc.collect()
        plain = _encoder_arm(cfg, batch, seq, dev, start, False,
                             RECOMPUTE_PLAIN_STEPS, profile_steps,
                             "perf_runs/encoder_rc_trace/plain")
    gap, gap_name = 0.0, ""
    for p, g in plain["grads"].items():
        r = rc["grads"][p]
        ratio = ((r.double() - g.double()).abs().max()
                 / max(g.double().abs().max().item(), 1e-30)).item()
        if ratio > gap:
            gap, gap_name = ratio, p
    samples_s = batch / (rc["ms_per_step"] / 1e3)
    flops = encoder_flops_per_token(cfg, seq)
    mfu = _mfu(samples_s * seq * flops, dev)
    ckpts = encoder_checkpoints(rc["main"])
    return {
        "config": (f"encoder_L{cfg['num_layers']}_D{cfg['d_model']}"
                   f"_b{batch}x{seq}_pad_f32_lamb_recompute"),
        "device": _device_name(dev),
        "model_params": n_params,
        "batch": batch, "seq_len": seq, "steps": RECOMPUTE_STEPS,
        "dropout": ENCODER_DROPOUT,
        "checkpoints": [v.name for v in ckpts],
        "tf32_matmul": False,
        "samples_per_s": samples_s,
        "ms_per_step": rc["ms_per_step"],
        "plain_ms_per_step": plain["ms_per_step"],
        "ms_over_plain": rc["ms_per_step"] / plain["ms_per_step"],
        "mfu": mfu,
        "mfu_with_recompute": None if mfu is None else mfu * 4 / 3,
        "peak_bytes": {"recompute": rc["first_peak"],
                       "plain": plain["first_peak"]},
        "timed_peak_bytes": rc["peak"],
        "first_loss": {"recompute": rc["loss"], "plain": plain["loss"]},
        "grad_gap": gap, "grad_gap_param": gap_name,
        "n_grads": len(plain["grads"]),
        "losses": rc["losses"], "plain_losses": plain["losses"],
        "launches_per_step": rc["launches_per_step"],
        **({"trace": {"recompute": rc["trace"], "plain": plain["trace"]}}
           if profile_steps else {}),
    }


# the gradient-merge lane (``--model resnet50 --grad-merge K``): the fed
# batch is K microbatches of the lane's 128
MERGE_FIXED_STEPS, MERGE_STEPS = 4, 3


def run_resnet_grad_merge(k: int = 2, device: str = "cuda",
                          tiny: bool = False, profile_steps: int = 0,
                          host_profile_steps: int = 0) -> Dict[str, Any]:
    """``bench.py``'s ResNet lane (bf16 AMP, fused Momentum) under
    ``GradientMergeOptimizer(k_steps=k)``, fed k x 128 images of 224²
    (``tiny``: ResNet-18, k x 4 of 32²) made on the device from seed 0:
    MERGE_FIXED_STEPS steps on that batch (``fixed_losses``, which must
    fall), then one warm-up and MERGE_STEPS timed steps of it, counted as
    :func:`_timed` counts them (the peak from the timed window); the
    loss scale after; then the profiles of :func:`_step_profiles`."""
    dev = resolve_device(device)
    micro, hw_, classes, depth = ((4, 32, 4, 18) if tiny else
                                  (RESNET_BATCH, RESNET_HW, RESNET_CLASSES,
                                   50))
    batch = k * micro
    main, startup, loss = resnet_program(batch, hw_, classes, depth,
                                         synthetic=False, amp=True,
                                         merge_k=k)
    exe = FW.Executor(_place(dev))
    scope = FW.Scope()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    feed = {"img": torch.rand((batch, 3, hw_, hw_), generator=gen,
                              device=dev) * 2 - 1,
            "label": torch.randint(0, classes, (batch, 1), generator=gen,
                                   device=dev)}

    def step_once():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    fixed = [float(step_once()) for _ in range(MERGE_FIXED_STEPS)]
    outs, warm_s, wall, launches, _ = _timed(step_once, dev, warmup=1,
                                             steps=MERGE_STEPS)
    img_s = MERGE_STEPS * batch / wall
    flops = hw.program_train_flops(main, batch)
    return {
        "config": f"resnet{depth}_b{k}x{micro}_{hw_}px_bf16amp_fused_merge",
        "device": _device_name(dev), "k": k, "micro_batch": micro,
        "batch": batch, "image": hw_, "steps": MERGE_STEPS, "warmup": 1,
        "fixed_losses": fixed,
        "losses": [float(o) for o in outs],
        "images_per_s": img_s,
        "ms_per_step": wall / MERGE_STEPS * 1e3,
        "mfu": _mfu(img_s * flops / batch, dev),
        "warmup_s": warm_s,
        "peak_mem_bytes": _peak_bytes(dev),
        "loss_scaling": float(scope.find_var("loss_scaling_0").reshape(-1)[0]),
        "launches_per_step": launches,
        **_step_profiles(step_once, dev, profile_steps, host_profile_steps),
    }


# ---------------------------------------------------------------------------
# the parallel lane: one rank of a dp x pp x tp gang under parallel.launch
# ---------------------------------------------------------------------------

# 11p: PARITY_STEPS steps at lr 1e-2, as the CPU step tests
# (tests/test_torch_parallel_step.py) take them, so that each step moves a
# param by about lr and the moments, not only the update's sign, decide
# the params after the last
PARITY_SEED, PARITY_LR, PARITY_STEPS = 11, 1e-2, 3
PARITY_ROWS, PARITY_SEQ = 8, 256     # the 11p global batch, [1, 8, 256]
# the 11p gates: loss at every step within the reference's rtol 2e-4;
# grad norm within the step tests' rtol 1e-3; this rank's whole update
# (p - p0) and its moments within PARITY_REL_TOL of the world-1 run's in
# the 2-norm, and each leaf's update within PARITY_LEAF_TOL (an update
# or moment shard that is missing or misplaced is off by about 1, a
# layernorm scale decayed by mistake by about 0.1); the params within
# the step tests' 2e-4 + 2e-3·|p| on all but PARITY_OUTSIDE of the
# elements. Not on all: where a gradient is zero but for rounding (the
# k bias, to which attention is invariant), Adam's normalised step
# follows the rounding, which differs between layouts.
PARITY_REL_TOL, PARITY_LEAF_TOL, PARITY_OUTSIDE = 1e-3, 1e-2, 1e-4


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32 (TF32 off) inside, the flags restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def parity_config(tiny: bool = False) -> G.GPTConfig:
    """The 11p model: GPT_SMALL's widths at 2 layers in float32, every
    kernel lever on (flash, fused LN, vocab chunk 1024, dots remat);
    ``tiny`` is a CPU rehearsal's shape."""
    cfg = G.GPT_SMALL.scaled(num_layers=2, dtype=torch.float32,
                             use_flash=True, fused_ln=True,
                             ce_vocab_chunk=1024, ce_direct_bytes_limit=0,
                             remat=True, remat_policy="dots")
    if tiny:
        cfg = cfg.scaled(vocab_size=512, d_model=64, num_heads=4, d_ff=128,
                         ce_vocab_chunk=128, max_seq_len=PARITY_SEQ)
    return cfg


def parity_batch(vocab: int) -> np.ndarray:
    """tokens and labels [2, 1, PARITY_ROWS, PARITY_SEQ] from numpy seed 5."""
    return np.random.default_rng(5).integers(
        0, vocab, (2, 1, PARITY_ROWS, PARITY_SEQ))


def _parity_steps(step, params, opt, shape, vocab):
    """PARITY_STEPS steps on the 11p batch (TF32 off): losses, gnorms."""
    toks, labs = (x.reshape(shape) for x in parity_batch(vocab))
    losses, gnorms = [], []
    with _no_tf32():
        for _ in range(PARITY_STEPS):
            _, _, loss, gnorm = step(params, opt, toks, labs)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
    return losses, gnorms


@functools.lru_cache(maxsize=2)
def parity_reference(device: str, tiny: bool = False) -> Dict:
    """The world-1 run of 11p in this process (one device, no mesh, the
    flat AdamW sweep; TF32 off), once a process: the losses and grad
    norms of its PARITY_STEPS steps and the params and moments (host
    leaves) after them."""
    cfg = parity_config(tiny=tiny)
    params, opt = PZ.init_sharded(cfg, seed=PARITY_SEED, fused_opt=True,
                                  device=device)
    step = PZ.make_train_step(cfg, lr=PARITY_LR, fused_opt=True,
                              device=device)
    losses, gnorms = _parity_steps(step, params, opt,
                                   (1, PARITY_ROWS, PARITY_SEQ),
                                   cfg.vocab_size)
    leaves = PZ.flat_leaves(params)
    ref = {"losses": losses, "gnorms": gnorms,
           "params": [p.detach().cpu().clone() for p in leaves]}
    for k in ("m", "v"):
        flat = opt[k].float().cpu()
        ref[k] = [x.view(p.shape).clone() for x, p in zip(
            flat.split([p.numel() for p in leaves]), leaves)]
    return ref


def _rel(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    num = sum(float(torch.sum(torch.square(a.float() - b.float())))
              for a, b in zip(got, want))
    den = sum(float(torch.sum(torch.square(b.float()))) for b in want)
    return (num / den) ** 0.5 if den else float(num > 0)


def _leaf_names(tree, prefix: str = "") -> List[str]:
    """The dotted key paths of a nested dict's leaves, in
    ``PZ.flat_leaves`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else [prefix + k])
    return out


def _ref_moment(leaves, specs, cfg, pcfg, mesh, rs, dev
                ) -> List[torch.Tensor]:
    """The world-1 moment ``leaves`` laid out as this rank's: its leaf
    shards by ``specs``, or under reduce-scatter its slice of every
    bucket, in the step's order."""
    local = [mesh_mod.local_shard(x, spec, mesh).to(dev)
             for x, spec in zip(leaves, specs)]
    if not rs:
        return local
    layout, _ = PZ.rs_param_layout(cfg, pcfg)
    d = mesh.axis_index(pcfg.axis_names[0])
    out = []
    for b in layout.buckets:
        blen = b.size // pcfg.dp
        out.append(comm_opt.flatten_bucket(local, b)[d * blen:
                                                     (d + 1) * blen])
    return [torch.cat(out)]


def _parity_check(args, pcfg, mesh, dev) -> Dict[str, Any]:
    """PARITY_STEPS 11p steps of this layout (float32 wire) against the
    world-1 run (:func:`parity_reference`): the losses' and grad norms'
    largest relative errors, the params' largest error, whether all are
    within the step tests' tolerance and the share that is, the relative
    2-norm error of this rank's update (p - p0), of each leaf's and of
    its moments, and the share of elements whose update has the world-1
    update's sign."""
    cfg = parity_config(tiny=args.tiny)
    rs = args.grad_reduce == "reduce_scatter"
    if args.sharding:
        params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=PARITY_SEED,
                                      sharding=args.sharding)
        step = PZ.make_train_step(cfg, pcfg, mesh, lr=PARITY_LR,
                                  sharding=args.sharding)
        specs = PZ.flat_leaves(resolve_plan(args.sharding, cfg,
                                            pcfg).param_specs)
    else:
        params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=PARITY_SEED,
                                      fused_opt=rs,
                                      grad_reduce=args.grad_reduce)
        step = PZ.make_train_step(cfg, pcfg, mesh, lr=PARITY_LR,
                                  fused_opt=rs, grad_reduce=args.grad_reduce)
        specs = PZ.flat_specs(cfg, pcfg)
    p0 = [p.clone() for p in PZ.flat_leaves(params)]
    M = pcfg.microbatches
    losses, gnorms = _parity_steps(step, params, opt,
                                   (M, PARITY_ROWS // M, PARITY_SEQ),
                                   cfg.vocab_size)
    ref = parity_reference(str(dev), args.tiny)
    worst, ok, within, agree, n = 0.0, True, 0, 0, 0
    got_d, want_d, by_leaf = [], [], {}
    for name, p, q0, full, spec in zip(
            _leaf_names(G.param_shapes(cfg)), PZ.flat_leaves(params), p0,
            ref["params"], specs):
        want = mesh_mod.local_shard(full, spec, mesh).to(dev)
        worst = max(worst, (p - want).abs().max().item())
        close = torch.isclose(p, want, rtol=2e-3, atol=2e-4)
        ok = ok and bool(close.all())
        within += int(close.sum())
        agree += int((torch.sign(p - q0) == torch.sign(want - q0)).sum())
        n += p.numel()
        got_d.append(p - q0)
        want_d.append(want - q0)
        by_leaf[name] = _rel(got_d[-1:], want_d[-1:])
    moments = {}
    for k in ("m", "v"):
        got = [opt[k]] if rs else PZ.flat_leaves(opt[k])
        moments[k] = _rel(got, _ref_moment(ref[k], specs, cfg, pcfg, mesh,
                                           rs, dev))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    grel = [abs(a - b) / b for a, b in zip(gnorms, ref["gnorms"])]
    return {"losses": losses, "ref_losses": ref["losses"],
            "loss_rel_err": max(rel), "gnorm_rel_err": max(grel),
            "params_max_abs_err": worst, "params_within_tol": ok,
            "params_within_tol_share": within / n,
            "update_rel_err": _rel(got_d, want_d),
            "leaf_update_rel_err": by_leaf,
            "m_rel_err": moments["m"], "v_rel_err": moments["v"],
            "update_sign_agreement": agree / n}


def parity_ok(par: Dict[str, Any]) -> bool:
    """The 11p gates (see PARITY_REL_TOL) on a ``_parity_check`` record."""
    return (par["loss_rel_err"] <= 2e-4 and par["gnorm_rel_err"] <= 1e-3
            and max(par["update_rel_err"], par["m_rel_err"],
                    par["v_rel_err"]) <= PARITY_REL_TOL
            and max(par["leaf_update_rel_err"].values()) <= PARITY_LEAF_TOL
            and par["params_within_tol_share"] >= 1 - PARITY_OUTSIDE)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counter_snapshot(name: str) -> Dict[str, float]:
    from ..observability import metrics as M

    fam = M.default_registry().snapshot().get(name, {"series": []})
    return {"/".join(s["labels"]): s["value"] for s in fam["series"]}


def _per_step(before, after, steps) -> Dict[str, float]:
    return {k: (v - before.get(k, 0)) / steps for k, v in after.items()
            if v != before.get(k, 0)}


# a --layout SPEC's keys: the parallel lane's flags, as key=value
LAYOUT_KEYS = {"dp": int, "pp": int, "tp": int, "microbatches": int,
               "layers": int, "grad_reduce": str, "comm_dtype": str,
               "sharding": str, "ckpt_dir": str, "overlap_dir": str,
               "model": str, "no_amp": int}


def parse_layout(spec: str, args) -> argparse.Namespace:
    """``args`` with a layout's keys ("dp=2,grad_reduce=reduce_scatter")
    replaced."""
    out = argparse.Namespace(**vars(args))
    for item in filter(None, spec.split(",")):
        key, _, val = item.partition("=")
        if key not in LAYOUT_KEYS:
            raise ValueError(f"layout key {key!r} not in {sorted(LAYOUT_KEYS)}")
        setattr(out, key, LAYOUT_KEYS[key](val))
    return out


def layout_dict(spec: str) -> Dict[str, Any]:
    """A layout's LAYOUT_KEYS over the lane's flag defaults."""
    args = parse_layout(spec, _parser().parse_args([]))
    return {k: getattr(args, k) for k in LAYOUT_KEYS}


def run_parallel(args, dev) -> Dict[str, Any]:
    """This rank's part of one layout of the parallel lane (its process
    group joined, its device ``dev``): the 11p check when ``--parity`` is
    given, then ``--warmup`` + ``--steps`` train steps of
    GPT_SMALL (bf16, flash, dots remat; ``--fused-ln``, ``--ce-vchunk``;
    ``--layers`` cuts the depth) on the global batch ``--batch`` x 1024 in
    ``--microbatches`` microbatches, with the launch counts and the wire
    bytes counted over the timed steps only; ``--sharding`` runs the
    plan's step (``make_train_step(sharding=)``, per-leaf moments), and
    with ``--ckpt-dir`` its state is then saved by ``ShardedCheckpointer``
    (async, then ``wait``) with each local leaf's crc32. The record has
    the rank's resident param and moment bytes. ``stamps`` holds the
    host clock (``time.time()``) after each part."""
    if args.ckpt_dir and not args.sharding:
        raise ValueError("--ckpt-dir saves a sharding plan's state: it "
                         "needs --sharding")
    stamps = {"begin": time.time()}
    pcfg = PZ.ParallelConfig(dp=args.dp, pp=args.pp, tp=args.tp,
                             microbatches=args.microbatches)
    mesh = PZ.build_mesh(pcfg, device=dev)
    stamps["mesh"] = time.time()
    rec: Dict[str, Any] = {"rank": mesh.rank, "coords": mesh.coords,
                           "backend": mesh.backend, "device": str(dev),
                           "stamps": stamps}
    if args.parity:
        rec["parity"] = _parity_check(args, pcfg, mesh, dev)
        stamps["parity"] = time.time()
    cfg = bench_config(args.remat, args.fused_ln, args.ce_vchunk)
    T = SEQ
    if args.layers:
        cfg = cfg.scaled(num_layers=args.layers)
    if args.tiny:
        T = 64
        cfg = cfg.scaled(vocab_size=512, d_model=64, num_heads=4, d_ff=128,
                         max_seq_len=T, dtype=torch.float32,
                         ce_vocab_chunk=128 if args.ce_vchunk else 0)
    rs = args.grad_reduce == "reduce_scatter"
    fused = (rs or pcfg.n_devices == 1) and not args.sharding
    comm = dict(grad_reduce=args.grad_reduce,
                grad_allreduce_dtype=args.comm_dtype,
                sharding=args.sharding or None)
    params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=0,
                                  moment_dtype=torch.bfloat16,
                                  fused_opt=fused, device=dev, **comm)
    step = PZ.make_train_step(cfg, pcfg, mesh, lr=1e-4, weight_decay=0.1,
                              fused_opt=fused, grad_clip=1.0, device=dev,
                              **comm)
    M = pcfg.microbatches
    batch = args.batch or BATCH
    rng = np.random.default_rng(0)
    toks, labs = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (M, batch // M, T))) for _ in range(2))
    losses, timed = _rank_steps(lambda: step(params, opt, toks, labs)[2],
                                args, dev, stamps)
    tokens = batch * T * args.steps
    rec.update(timed)
    rec.update({
        "config": (f"gpt_small_L{cfg.num_layers}_b{batch}x{T}_dp"
                   f"{pcfg.dp}pp{pcfg.pp}tp{pcfg.tp}m{M}_{args.grad_reduce}"
                   + (f"_{args.comm_dtype}" if args.comm_dtype else "")
                   + (f"_sharding-{args.sharding}" if args.sharding else "")),
        "world": pcfg.n_devices,
        "tokens_per_s": tokens / timed["wall_s"],
        "tokens_per_s_per_rank": tokens / timed["wall_s"] / pcfg.n_devices,
        "losses": losses,
        "param_bytes": PZ.resident_bytes(params),
        "moment_bytes": PZ.resident_bytes(opt["m"])
        + PZ.resident_bytes(opt["v"]),
    })
    if args.sharding:
        rec["report_name"] = step.report_name
    if args.overlap_dir:
        rec["overlap"] = _overlap_step(
            lambda: step(params, opt, toks, labs)[2], args.overlap_dir,
            mesh.rank, dev)
    if args.ckpt_dir:
        rec["ckpt"] = _save_sharded(args, cfg, pcfg, mesh, params, opt)
    return rec


def _overlap_step(step_once, out_dir: str, rank: int, dev):
    """One more step under a ``torch.profiler`` capture (into
    ``<out_dir>/rank<r>``, outside the counts): the share of its
    collectives' time that compute overlaps
    (``comm_opt.measure_overlap_fraction``), or None without a
    collective."""
    from ..utils import device_trace as DT

    tdir = os.path.join(out_dir, f"rank{rank}")
    with DT.capture(tdir, device=dev):
        float(step_once())
    return comm_opt.measure_overlap_fraction(tdir)


def _rank_steps(step_once, args, dev, stamps):
    """``--warmup`` then ``--steps`` calls of ``step_once`` (a step; it
    returns the loss), the launch counts, wire bytes and staged seconds
    counted over the timed ones. Returns (losses, the timing record)."""
    losses = []
    t0 = time.perf_counter()
    for _ in range(args.warmup):
        losses.append(float(step_once()))
    _sync(dev)
    warm_s = time.perf_counter() - t0
    stamps["warmup"] = time.time()
    CK.reset_launches()
    counters = ("paddle_collective_bytes_total",
                "paddle_collective_staged_seconds_total")
    before = [_counter_snapshot(c) for c in counters]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    outs = [step_once() for _ in range(args.steps)]
    _sync(dev)
    wall = time.perf_counter() - t0
    stamps["timed"] = time.time()
    wire, staged = (_per_step(b, _counter_snapshot(c), args.steps)
                    for b, c in zip(before, counters))
    return losses + [float(o) for o in outs], {
        "steps": args.steps, "warmup": args.warmup, "warmup_s": warm_s,
        "wall_s": wall, "ms_per_step": wall / args.steps * 1e3,
        "wire_bytes_per_step": wire,
        # host seconds in gloo-staged collectives (copies + exchange, and
        # a receive's wait for its peer), by op
        "staged_ms_per_step": {k: v * 1e3 for k, v in staged.items()},
        "launches_per_step": {k: v / args.steps
                              for k, v in CK.LAUNCHES.items() if v},
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0)}


def _save_sharded(args, cfg, pcfg, mesh, params, opt) -> Dict[str, Any]:
    """Save this rank's plan-sharded state with ``ShardedCheckpointer``
    (async, then ``wait``): the host ms of each, the step saved, and the
    crc32 of each local leaf by its keystr (bf16 moments as their
    bytes)."""
    import zlib

    specs = resolve_plan(args.sharding, cfg, pcfg).param_specs
    state = {"params": params, "opt": opt}
    ck = ckpt_mod.ShardedCheckpointer(args.ckpt_dir, use_async=True,
                                      mesh=mesh)
    step_no = int(opt["step"])
    t0 = time.perf_counter()
    ck.save(step_no, state, specs={"params": specs,
                                   "opt": {"m": specs, "v": specs}})
    t1 = time.perf_counter()
    ck.wait()
    t2 = time.perf_counter()
    crc = {k: zlib.crc32(t.detach().reshape(-1).view(torch.uint8)
                         .cpu().numpy().tobytes())
           for k, t in ckpt_mod.flatten_with_keys(state)}
    return {"step": step_no, "save_ms": (t1 - t0) * 1e3,
            "wait_ms": (t2 - t1) * 1e3, "crc32": crc,
            "dtypes": {k: str(t.dtype).replace("torch.", "")
                       for k, t in ckpt_mod.flatten_with_keys(state)}}


ERNIE_PARITY_ROWS = 4     # 13p's ERNIE batch, [4, 512], padded lengths


def ernie_parity_ok(par: Dict[str, Any]) -> bool:
    """13p's ERNIE gates: the loss at every step within 2e-4, this rank's
    update and momentum within PARITY_REL_TOL in the 2-norm, each leaf's
    update within PARITY_LEAF_TOL, the params within 2e-4 + 2e-3·|p| on
    all but PARITY_OUTSIDE of the elements (11p's bars)."""
    return (par["loss_rel_err"] <= 2e-4
            and max(par["update_rel_err"], par["m_rel_err"])
            <= PARITY_REL_TOL
            and max(par["leaf_update_rel_err"].values()) <= PARITY_LEAF_TOL
            and par["params_within_tol_share"] >= 1 - PARITY_OUTSIDE)


def _ernie_parity(args, mesh, dev) -> Dict[str, Any]:
    """13p for ERNIE: PARITY_STEPS float32 momentum steps (TF32 off) of a
    2-layer ERNIE_BASE (``--fused-ln`` as the lane) on this rank's mesh
    against the one-device step run in this process, from the same
    params and batch: losses, this rank's update and momentum against
    the same blocks of the one-device run's."""
    cfg = E.ERNIE_BASE.scaled(num_layers=2, dtype=torch.float32,
                              use_flash=True, remat=False,
                              fused_ln=args.fused_ln)
    T = ERNIE_SEQ
    if args.tiny:
        T = 64
        cfg = E.ERNIE_TINY.scaled(use_flash=True, fused_ln=args.fused_ln)
    data = ernie_batch(cfg, ERNIE_PARITY_ROWS, T, pad=True)
    full = E.init_params(cfg, seed=PARITY_SEED, device=dev)
    specs = PZ.flat_leaves(E.param_specs(cfg))
    ref = PZ._unflatten(full, [p.clone() for p in PZ.flat_leaves(full)])
    ref_opt = E.init_opt(ref)
    params = PZ.shard_params(full, E.param_specs(cfg), mesh)
    p0 = [p.clone() for p in PZ.flat_leaves(params)]
    opt = E.init_opt(params)
    one = E.make_pretrain_step(cfg, lr=PARITY_LR, device=dev)
    step = E.make_pretrain_step(cfg, mesh=mesh, lr=PARITY_LR)
    losses, ref_losses = [], []
    with _no_tf32():
        for _ in range(PARITY_STEPS):
            ref_losses.append(float(one(ref, ref_opt, data)[2]))
            losses.append(float(step(params, opt, data)[2]))
    got_d, want_d, by_leaf = [], [], {}
    within, n = 0, 0
    for name, p, q0, r, spec in zip(_leaf_names(full),
                                    PZ.flat_leaves(params), p0,
                                    PZ.flat_leaves(ref), specs):
        want = mesh_mod.local_shard(r, spec, mesh)
        within += int(torch.isclose(p, want, rtol=2e-3, atol=2e-4).sum())
        n += p.numel()
        got_d.append(p - q0)
        want_d.append(want - q0)
        by_leaf[name] = _rel(got_d[-1:], want_d[-1:])
    m_want = [mesh_mod.local_shard(m, spec, mesh) for m, spec in zip(
        PZ.flat_leaves(ref_opt["m"]), specs)]
    return {"losses": losses, "ref_losses": ref_losses,
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, ref_losses)),
            "update_rel_err": _rel(got_d, want_d),
            "leaf_update_rel_err": by_leaf,
            "m_rel_err": _rel(PZ.flat_leaves(opt["m"]), m_want),
            "params_within_tol_share": within / n}


def run_ernie_parallel(args, dev) -> Dict[str, Any]:
    """This rank's part of the ERNIE lane on a (``--dp``, ``--tp``) mesh:
    13p first when ``--parity`` is given, then ``--warmup`` + ``--steps``
    momentum steps of ERNIE_BASE (bf16, flash with the padding bias,
    remat off; ``--fused-ln``, ``--pad``; ``--layers`` cuts the depth) at
    lr 1e-4 on the global batch ``--batch`` (48 by default) x 512,
    counted as :func:`run_parallel` counts its steps."""
    stamps = {"begin": time.time()}
    mesh = mesh_mod.build_mesh([("dp", args.dp), ("tp", args.tp)],
                               device=dev)
    stamps["mesh"] = time.time()
    rec: Dict[str, Any] = {"rank": mesh.rank, "coords": mesh.coords,
                           "backend": mesh.backend, "device": str(dev),
                           "stamps": stamps}
    if args.parity:
        rec["parity"] = _ernie_parity(args, mesh, dev)
        stamps["parity"] = time.time()
    cfg = ernie_config(fused_ln=args.fused_ln)
    batch, T = args.batch or ERNIE_BATCH, ERNIE_SEQ
    if args.layers:
        cfg = cfg.scaled(num_layers=args.layers)
    if args.tiny:
        T = 64
        cfg = E.ERNIE_TINY.scaled(use_flash=True, fused_ln=args.fused_ln)
    params = PZ.shard_params(E.init_params(cfg, seed=0, device=dev),
                             E.param_specs(cfg), mesh)
    opt = E.init_opt(params)
    step = E.make_pretrain_step(cfg, mesh=mesh, lr=1e-4)
    data = E.batch_to_device(ernie_batch(cfg, batch, T, args.pad), dev)
    losses, timed = _rank_steps(lambda: step(params, opt, data)[2], args,
                                dev, stamps)
    rec.update(timed)
    samples = batch * args.steps / timed["wall_s"]
    rec.update({
        "config": (f"ernie_L{cfg.num_layers}_b{batch}x{T}_dp{args.dp}"
                   f"tp{args.tp}" + ("_pad" if args.pad else "")
                   + ("_fln" if cfg.fused_ln else "")),
        "world": args.dp * args.tp,
        "samples_per_s": samples, "tokens_per_s": samples * T,
        "losses": losses,
        "param_bytes": PZ.resident_bytes(params),
        "moment_bytes": PZ.resident_bytes(opt["m"]),
    })
    return rec


# ---------------------------------------------------------------------------
# the fluid lanes over ranks (``--model encoder --no-amp --pp 2``,
# ``--model resnet50 --dp 2``): one rank of a gang under parallel.launch
# ---------------------------------------------------------------------------

# the parity gates (11f): PIPE_PARITY_LAYERS of the encoder cut after
# layer 0, dropout 0, and ResNet-18 at DP_PARITY_HW² over dp, each for
# FLUID_PARITY_STEPS float32 steps (TF32 off) from one start state
FLUID_PARITY_STEPS, PIPE_PARITY_LAYERS = 3, 2
DP_PARITY_DEPTH, DP_PARITY_HW, DP_PARITY_CLASSES = 18, 64, 10
DP_PARITY_ROWS = 8                      # a rank's rows; the one rank: dp x
COLLECTIVE_PARITY_N = 4096
# the bands: the reference's pipeline band (tests/test_pipeline_optimizer
# .py) and its sync-BN band (tests/test_sync_bn.py); the c_allreduce_sum
# program against the numpy sum
PIPE_RTOL, PIPE_ATOL = 2e-4, 1e-5
DP_RTOL, DP_ATOL = 5e-4, 5e-5
COLLECTIVE_RTOL = 1e-6


def _start_state(main, startup, dev) -> Dict[str, np.ndarray]:
    """The persistables ``startup`` makes, on the host (one start state
    for both arms of a gate)."""
    scope = FW.Scope()
    FW.Executor(_place(dev)).run(startup, scope=scope)
    return {n: scope.find_var(n).cpu().numpy()
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _arm(main, loss, start, feed, dev, steps, target=None):
    """``steps`` runs of ``target`` (default ``main``) from ``start``:
    (the losses, the persistables after on the host)."""
    scope = FW.scope_from_numpy(start, _place(dev))
    exe = FW.Executor(_place(dev))
    losses = [float(np.mean(exe.run(target or main, feed=feed,
                                    fetch_list=[loss], scope=scope)[0]))
              for _ in range(steps)]
    return losses, {n: scope.find_var(n).float().cpu().numpy()
                    for n in start}


def param_band_gap(got, want, prog, rtol: float, atol: float, lr: float
                   ) -> Dict[str, Any]:
    """How far the parameters ``got`` are from ``want`` (name -> numpy):
    the elements outside ``rtol`` / ``atol`` (``outside``, the worst
    ``|diff| / (atol + rtol·|want|)`` and its name), leaving out, for
    Adam's parameters, the elements whose first moment sits at most 1e-4
    of its tensor's largest (where the gradient is zero but for rounding,
    the k bias, Adam's normalised step follows the rounding): those are
    held to ``lr`` a step (``floor_worst``, the worst |diff| there)."""
    block = prog.global_block()
    m1_of = {}
    for op in block.ops:
        if op.type in ("adam", "adamw"):
            m1_of[op.input("Param")[0]] = (op.input("Moment1")[0], None)
        elif op.type in ("fused_adam", "fused_adamw"):
            off = 0
            for p in op.input("Param"):
                n = int(np.prod(block.var(p).shape))
                m1_of[p] = (op.input("Moment1")[0], (off, off + n))
                off += n
    out = {"outside": 0, "worst": 0.0, "worst_name": "", "floor_worst": 0.0,
           "n_floor": 0}
    for p in block.all_parameters():
        n = p.name
        a, b = got[n].astype(np.float64), want[n].astype(np.float64)
        ratio = np.abs(a - b) / (atol + rtol * np.abs(b))
        if n in m1_of:
            m1n, span = m1_of[n]
            m1 = np.abs(want[m1n].reshape(-1))
            if span is not None:
                m1 = m1[span[0]:span[1]]
            floor = (m1 <= 1e-4 * m1.max()).reshape(a.shape)
            out["n_floor"] += int(floor.sum())
            if floor.any():
                out["floor_worst"] = max(out["floor_worst"], float(
                    np.abs(a - b)[floor].max()))
            ratio = np.where(floor, 0.0, ratio)
        out["outside"] += int((ratio > 1).sum())
        if ratio.max(initial=0) > out["worst"]:
            out["worst"], out["worst_name"] = float(ratio.max()), n
    out["lr"] = lr
    return out


def fluid_parity_ok(par: Dict[str, Any]) -> bool:
    """An 11f gate passed: every loss and parameter in its band (and
    Adam's noise-floor elements within lr a step)."""
    steps = par.get("steps", FLUID_PARITY_STEPS)
    return (par["losses_ok"] and par["params"]["outside"] == 0
            and par["params"]["floor_worst"] <= par["params"]["lr"] * steps)


def _losses_ok(got, want, rtol, atol) -> bool:
    return bool(np.allclose(got, want, rtol=rtol, atol=atol))


def encoder_pipeline_parity(args, dev) -> Dict[str, Any]:
    """pp2: the encoder at PIPE_PARITY_LAYERS layers (cut after layer 0,
    4 microbatches, dropout 0) over the pp ranks, against the same
    program unpipelined on this rank, FLUID_PARITY_STEPS float32 steps
    from one start state (``scope_from_numpy``)."""
    from ..framework import unique_name

    cfg = dict(ENCODER_TINY if args.tiny else ENCODER,
               num_layers=PIPE_PARITY_LAYERS)
    batch, seq = (8, 32) if args.tiny else (ENCODER_BATCH, ENCODER_SEQ)
    feed = encoder_batch(cfg, batch, seq, dev)
    progs = {}
    for arm, pp in (("pipeline", args.pp), ("one_rank", 0)):
        with unique_name.guard():
            progs[arm] = encoder_program(cfg, seq, dropout=0.0, amp=False,
                                         optimizer="adamw_const",
                                         pipeline=pp,
                                         microbatches=PIPE_MICROBATCHES)
    main, startup, loss, _ = progs["pipeline"]
    start = _start_state(main, startup, dev)
    with _no_tf32():
        got_l, got_s = _arm(main, loss, start, feed, dev,
                            FLUID_PARITY_STEPS)
        ref_main, _, ref_loss, _ = progs["one_rank"]
        want_l, want_s = _arm(ref_main, ref_loss, start, feed, dev,
                              FLUID_PARITY_STEPS)
    return {"losses": got_l, "one_rank_losses": want_l,
            "losses_ok": _losses_ok(got_l, want_l, PIPE_RTOL, PIPE_ATOL),
            "params": param_band_gap(got_s, want_s, ref_main, PIPE_RTOL,
                                     PIPE_ATOL, ENCODER_LR),
            "band": [PIPE_RTOL, PIPE_ATOL], "steps": FLUID_PARITY_STEPS}


def resnet_dp_parity(args, dev, dp: int) -> Dict[str, Any]:
    """dp2: ResNet-18 (fused Momentum, float32, TF32 off) under
    ``with_data_parallel`` at DP_PARITY_ROWS a rank, against this rank
    running the program alone on the whole batch (dp x as many rows),
    FLUID_PARITY_STEPS steps from one start state."""
    from ..framework import unique_name

    rows = DP_PARITY_ROWS * dp
    hw_ = 32 if args.tiny else DP_PARITY_HW
    with unique_name.guard():
        main, startup, loss = resnet_program(
            rows, hw_, DP_PARITY_CLASSES, DP_PARITY_DEPTH, fuse=True,
            synthetic=False)
    start = _start_state(main, startup, dev)
    rng = np.random.default_rng(3)
    feed = {"img": rng.uniform(-1, 1, (rows, 3, hw_, hw_)).astype(
        np.float32),
        "label": rng.integers(0, DP_PARITY_CLASSES, (rows, 1))}
    compiled = FW.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    with _no_tf32():
        got_l, got_s = _arm(main, loss, start, feed, dev,
                            FLUID_PARITY_STEPS, compiled)
        want_l, want_s = _arm(main, loss, start, feed, dev,
                              FLUID_PARITY_STEPS)
    stats = [n for n in start if n.endswith(("_mean", "_variance"))]
    stat_ok = all(np.allclose(got_s[n], want_s[n], rtol=DP_RTOL,
                              atol=DP_ATOL) for n in stats)
    return {"losses": got_l, "one_rank_losses": want_l,
            "losses_ok": _losses_ok(got_l, want_l, DP_RTOL, DP_ATOL)
            and stat_ok, "n_bn_stats": len(stats),
            "params": param_band_gap(got_s, want_s, main, DP_RTOL, DP_ATOL,
                                     0.01),
            "band": [DP_RTOL, DP_ATOL], "steps": FLUID_PARITY_STEPS}


def collective_parity(dev, world: int, rank: int) -> Dict[str, Any]:
    """A per-rank program of one ``c_allreduce_sum`` (the per-rank plan:
    ``with_data_parallel`` of a program carrying a c_* op) on a global
    [world, COLLECTIVE_PARITY_N] float32 feed, each rank its row: every
    rank's fetch, [world, N], against the numpy sum of the rows."""
    from ..framework import unique_name
    from ..layers import collective as C

    with unique_name.guard():
        main, startup = FW.Program(), FW.Program()
        with FW.program_guard(main, startup):
            x = layers.data("x", [COLLECTIVE_PARITY_N], dtype="float32")
            out = C._c_allreduce(x, reduce_type="sum")
    xs = np.random.default_rng(4).standard_normal(
        (world, COLLECTIVE_PARITY_N)).astype(np.float32)
    got = FW.Executor(_place(dev)).run(
        FW.CompiledProgram(main).with_data_parallel(), feed={"x": xs},
        fetch_list=[out], scope=FW.Scope())[0]
    want = np.broadcast_to(xs.sum(0, dtype=np.float64), got.shape)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    return {"rel_err": err, "ok": bool(np.allclose(
        got, want, rtol=COLLECTIVE_RTOL, atol=COLLECTIVE_RTOL)),
        "rank": rank}


def run_fluid_parallel(args, dev) -> Dict[str, Any]:
    """This rank's part of a fluid lane over ranks: with ``--parity`` the
    lane's 11f gates first (the encoder: pp2; ResNet: dp2 and the
    per-rank ``c_allreduce_sum`` program), then ``--warmup`` +
    ``--steps`` steps, counted as :func:`run_parallel` counts them.

    ``--model encoder --no-amp --pp S --microbatches M``: the
    encoder lane's program (ERNIE-base's widths and depth, 48 x 512 with
    the padding bias, dropout 0.1) in float32 (TF32 off) under
    ``PipelineOptimizer(AdamW(5e-5, weight_decay=0.01, grad_clip=
    GradientClipByGlobalNorm(1.0), fuse=True))`` at a constant rate, cut
    after layer 5 at S 2, each rank a stage. ``--model resnet50 --dp N``:
    ``bench.py``'s ResNet lane (bf16 AMP, fused Momentum) through
    ``CompiledProgram(main).with_data_parallel(loss_name=)`` on a fed
    global batch of 128 x 224² (made on the card from seed 0), each rank
    its rows."""
    import torch.distributed as dist

    stamps = {"begin": time.time()}
    world, rank = dist.get_world_size(), dist.get_rank()
    axis = "pp" if args.model == "encoder" else "dp"
    rec: Dict[str, Any] = {"rank": rank, "coords": {axis: rank},
                           "backend": dist.get_backend(), "device": str(dev),
                           "stamps": stamps, "world": world}
    place = _place(dev)
    exe, scope = FW.Executor(place), FW.Scope()
    if args.model == "encoder":
        if not args.no_amp or args.pp != world:
            raise SystemExit(
                "train_bench: the pipelined encoder lane is --no-amp "
                f"--pp {world} (one stage a rank; the reference runs "
                "no AMP under the pipeline)")
        if args.parity:
            rec["parity"] = {"pp2": encoder_pipeline_parity(args, dev)}
            stamps["parity"] = time.time()
        cfg = ENCODER_TINY if args.tiny else ENCODER
        batch, seq = (8, 32) if args.tiny else (ENCODER_BATCH, ENCODER_SEQ)
        main, startup, loss, _ = encoder_program(
            cfg, seq, amp=False, optimizer="adamw_const",
            pipeline=args.pp, microbatches=args.microbatches)
        exe.run(startup, scope=scope)
        feed = encoder_batch(cfg, batch, seq, dev)
        flops = encoder_flops_per_token(cfg, seq) * seq

        def step_once():
            return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)[0]

        with _no_tf32():
            losses, timed = _rank_steps(step_once, args, dev, stamps)
        config = (f"encoder_L{cfg['num_layers']}_D{cfg['d_model']}_b{batch}"
                  f"x{seq}_pad_f32_adamw_fused_pp{args.pp}"
                  f"m{args.microbatches}")
        unit = "samples_per_s"
    else:
        if args.dp != world:
            raise SystemExit(f"train_bench: the data-parallel ResNet lane "
                             f"is --dp {world} (one rank a replica)")
        if args.parity:
            rec["parity"] = {"dp2": resnet_dp_parity(args, dev, world),
                             "c_allreduce_sum": collective_parity(
                                 dev, world, rank)}
            stamps["parity"] = time.time()
        batch, hw_, classes, depth = ((4 * world, 32, 4, 18) if args.tiny
                                      else (RESNET_BATCH, RESNET_HW,
                                            RESNET_CLASSES, 50))
        main, startup, loss = resnet_program(batch, hw_, classes, depth,
                                             fuse=True, synthetic=False,
                                             amp=True)
        exe.run(startup, scope=scope)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        feed = {"img": torch.rand((batch, 3, hw_, hw_), generator=gen,
                                  device=dev) * 2 - 1,
                "label": torch.randint(0, classes, (batch, 1),
                                       generator=gen, device=dev)}
        compiled = FW.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        flops = hw.program_train_flops(main, batch) / batch

        def step_once():
            return exe.run(compiled, feed=feed, fetch_list=[loss],
                           scope=scope, return_numpy=False)[0]

        losses, timed = _rank_steps(step_once, args, dev, stamps)
        config = (f"resnet{depth}_b{batch}_{hw_}px_bf16amp_fused_dp"
                  f"{world}")
        unit = "images_per_s"
    rec.update(timed)
    rate = batch * args.steps / timed["wall_s"]
    rec.update({"config": config, "model": args.model, "batch": batch,
                unit: rate, "losses": losses,
                "mfu": _mfu(rate * flops, dev),
                "flops_per_sample": flops})
    return rec


def main_parallel(args) -> int:
    """Join the gang, then run each ``--layout`` (or the one the flags
    give) in turn over the same ranks; each rank's record goes to stdout
    and to ``<out-dir>/layout<i>.rank<r>.json``."""
    from ..parallel import env

    t0 = time.time()
    dev = env.init_distributed_env(device=args.device)
    t_init = time.time()
    for i, spec in enumerate(args.layout or [""]):
        gc.collect()        # the last layout's tensors gone before the next
        lay = parse_layout(spec, args)
        rec = (run_ernie_parallel(lay, dev) if lay.model == "ernie"
               else run_fluid_parallel(lay, dev)
               if lay.model in ("encoder", "resnet50")
               else run_parallel(lay, dev))
        rec["stamps"].update(start=t0, init=t_init)
        line = json.dumps(rec)
        print(f"[train-parallel layout {i} rank {rec['rank']}] {line}",
              flush=True)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            with open(os.path.join(args.out_dir,
                                   f"layout{i}.rank{rec['rank']}.json"),
                      "w") as f:
                f.write(line)
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt",
                    choices=("gpt", "ernie", "resnet50", "encoder"))
    ap.add_argument("--no-fuse", action="store_true",
                    help="resnet50: one momentum op a parameter")
    ap.add_argument("--no-amp", action="store_true",
                    help="resnet50: the float32 lane, no AMP decorator; "
                         "encoder: with --recompute")
    ap.add_argument("--recompute", action="store_true",
                    help="encoder: the float32 recompute lane against "
                         "plain Lamb (needs --no-amp --optimizer lamb)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "lamb"),
                    help="encoder: lamb with --recompute")
    ap.add_argument("--grad-merge", type=int, default=0, metavar="K",
                    help="resnet50: bf16 AMP under GradientMergeOptimizer, "
                         "fed K microbatches of 128")
    ap.add_argument("--pad", action="store_true",
                    help="ernie: per-sample lengths 128-512, not all-ones")
    ap.add_argument("--remat", default="dots",
                    help="none | full | dots | save_only_flash")
    ap.add_argument("--fused-ln", action="store_true",
                    help="every layernorm through the fused-LN kernels")
    ap.add_argument("--ce-vchunk", type=int, default=0, metavar="N",
                    help="vocab-chunked CE in chunks of N columns")
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps under torch.profiler")
    ap.add_argument("--host-profile", type=int, default=0, metavar="N",
                    help="resnet50: N more steps under cProfile (host ms "
                         "a step by function)")
    ap.add_argument("--monitor", default=None, metavar="PATH",
                    help="GPT: one TrainMonitor JSONL row a timed step")
    ap.add_argument("--compare", action="store_true",
                    help="plain and kernel arms in turns: P, K, K, P")
    ap.add_argument("--tuned", default=None, metavar="PATH",
                    help="GPT: apply the TUNED.json train winner where the "
                         "flags were left at their defaults")
    par = ap.add_argument_group(
        "parallel lane (one rank; run under python -m "
        "paddle_tpu_torch.parallel.launch)")
    for flag in ("--dp", "--pp", "--tp", "--microbatches"):
        par.add_argument(flag, type=int, default=1)
    par.add_argument("--grad-reduce", default="psum",
                     choices=("psum", "reduce_scatter"))
    par.add_argument("--comm-dtype", default=None,
                     choices=("f32", "bf16", "int8"))
    par.add_argument("--sharding", default=None,
                     choices=("dp", "fsdp", "tp", "dp+tp"),
                     help="the sharding plan's step (pp 1)")
    par.add_argument("--ckpt-dir", default=None,
                     help="--sharding: save the state after the timed "
                          "steps with ShardedCheckpointer here")
    par.add_argument("--parity", action="store_true",
                     help="first the parity check (11p, 13p): 3 float32 "
                          "steps of a 2-layer model on the mesh against "
                          "the one-device step run in this process")
    par.add_argument("--layers", type=int, default=0,
                     help="cut GPT_SMALL's depth to this many layers")
    par.add_argument("--batch", type=int, default=0,
                     help="global batch (rows of 1024 tokens; ERNIE: of "
                          "512); default 16, ERNIE 48")
    par.add_argument("--steps", type=int, default=STEPS)
    par.add_argument("--warmup", type=int, default=WARMUP)
    par.add_argument("--device", default=None,
                     help="this rank's device (default cuda:LOCAL_RANK); "
                          "name one card to put every rank on it; the "
                          "fluid lanes (resnet50, encoder): cpu runs them "
                          "on the CPU")
    par.add_argument("--layout", action="append", metavar="SPEC",
                     help="run this layout (key=value,...: dp, pp, tp, "
                          "microbatches, layers, grad_reduce, comm_dtype, "
                          "sharding, ckpt_dir, model, no_amp "
                          "over the flags above); repeat to run several "
                          "over one gang, in turn")
    par.add_argument("--out-dir", default=None,
                     help="write each rank's record to "
                          "layout<i>.rank<r>.json here")
    par.add_argument("--overlap-dir", default=None,
                     help="after the timed steps, trace one more into "
                          "<dir>/rank<r> and record the share of its "
                          "collective time compute overlaps")
    par.add_argument("--tiny", action="store_true",
                     help="a CPU rehearsal's widths (with --device cpu; "
                          "the fluid lanes' rehearsal sizes)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if "PADDLE_TRAINERS_NUM" in os.environ:
        if args.tuned:
            raise SystemExit("train_bench: --tuned applies to the "
                             "one-card GPT lane")
        return main_parallel(args)
    if args.tuned and args.model != "gpt":
        raise SystemExit("train_bench: --tuned applies to the GPT lane")
    fluid_lane = args.model in ("resnet50", "encoder")
    device = args.device or "cuda"
    if not torch.cuda.is_available() and not (fluid_lane
                                              and device == "cpu"):
        print("train_bench: no CUDA device available", file=sys.stderr)
        return 2
    tuned_doc = (load_tuned(args.tuned, torch.device("cuda"))
                 if args.tuned else None)
    order = ("plain", "kernel", "kernel", "plain") if args.compare \
        else ("kernel",)
    if args.model == "resnet50" and args.grad_merge:
        rec = run_resnet_grad_merge(args.grad_merge, device=device,
                                    tiny=args.tiny,
                                    profile_steps=args.profile,
                                    host_profile_steps=args.host_profile)
        print(json.dumps(rec), flush=True)
        return 0
    if args.model == "encoder" and (args.recompute or args.no_amp
                                    or args.optimizer != "adamw"):
        if not (args.recompute and args.no_amp
                and args.optimizer == "lamb"):
            raise SystemExit("train_bench: the encoder's recompute lane is "
                             "--no-amp --recompute --optimizer lamb (AMP "
                             "and recompute refuse each other)")
        rec = run_encoder_recompute(device=device, tiny=args.tiny,
                                    profile_steps=args.profile)
        print(json.dumps(rec), flush=True)
        return 0
    if args.model == "resnet50":
        if not args.compare:
            order = ("plain",) if args.no_fuse else ("kernel",)
        for arm in order:
            rec = run_resnet(fuse=arm == "kernel", amp=not args.no_amp,
                             profile_steps=args.profile,
                             host_profile_steps=args.host_profile,
                             device=device, tiny=args.tiny)
            rec["arm"] = "fused" if arm == "kernel" else "no-fuse"
            print(json.dumps(rec), flush=True)
        return 0
    if args.model == "encoder":
        rec = run_encoder(device=device, tiny=args.tiny,
                          profile_steps=args.profile)
        print(json.dumps(rec), flush=True)
        return 0
    if args.model == "ernie":
        cfg = ernie_config(args.fused_ln)
        arms = {"kernel": cfg, "plain": cfg.scaled(use_flash=False)}
    else:
        cfg = bench_config(args.remat, args.fused_ln, args.ce_vchunk)
        if tuned_doc is not None:
            cfg = tuned_config(cfg, tuned_doc, args)
        arms = {"kernel": (cfg, None), "plain": (plain_config(cfg), False)}
    for arm in order:
        if args.model == "ernie":
            rec = run_ernie(arms[arm], args.pad, args.profile)
        else:
            acfg, kern = arms[arm]
            rec = run(acfg, fused_opt_kernel=kern,
                      profile_steps=args.profile, monitor=args.monitor,
                      tuned=tuned_doc)
            if tuned_doc is not None:
                from ..tuning import tuned as tuned_mod

                rec["tuned"] = tuned_mod.config_stamp(tuned_doc, args.tuned)
        rec["arm"] = arm
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
