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
        [--no-fuse] [--profile 3] [--host-profile 5] [--compare]
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

``--model resnet50`` is ``bench.py``'s ResNet lane through the fluid
surface of the port: ``Program`` + ``layers`` + ``models.resnet`` (depth
50, class_dim 1000) on a batch of 128 images 224² made on the card each
step by ``uniform_random`` / ``randint`` ops, ``reduce_mean`` of
``softmax_with_cross_entropy``, ``optimizer.Momentum(0.01, 0.9,
fuse=True)`` (one ``fused_momentum`` op, one ``opt_momentum`` launch a
step) and ``Executor(CUDAPlace(0)).run``; one warm step, then 10 timed. float32, where ``bench.py``
decorates the optimizer for bf16 AMP (not ported yet: ROADMAP A5); cuDNN
may take TF32 for the convolutions (PyTorch's default), which the record
states. ``--no-fuse`` is ``bench.py``'s exact optimizer: one ``momentum``
op a parameter. The record has img/s, ms a step, MFU
(``program_train_flops`` over the card's bf16 dense peak, the
reference's convention), peak memory and the step's losses; with
``--profile N`` the device time a step by group: cuDNN convolutions,
batch norm, the optimizer sweep, the flat group's ``torch.cat``, other
(eager glue); with ``--host-profile N`` the host ms a step by function
under ``cProfile``. ``--compare`` runs the no-fuse and fused arms in
turns.
"""
import argparse
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

from .. import framework as FW
from .. import layers
from .. import optimizer as fluid_optimizer
from ..models import ernie as E
from ..models import gpt as G
from ..models import resnet as R
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
# the cuDNN convolution kernels carry "xmma"/"gemm" and land in matmul
RESNET_KERNELS = {"momentum_kernel": "opt_sweep", "CatArrayBatchedCopy":
                  "flat_cat", "batch_norm": "batch_norm", "bn_fw": "batch_norm",
                  "bn_bw": "batch_norm", "conv": "conv", "xmma": "conv",
                  "implicit": "conv", "wgrad": "conv", "dgrad": "conv",
                  "fprop": "conv"}
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
           mon: TrainMonitor = None):
    """``warmup`` calls of ``step_once`` (one train step, updating its
    state in place), then STEPS more with the launch counts and the peak
    memory zeroed just before them, ending in one synchronize. With
    ``mon``, the timed steps are :func:`monitored_steps` (one sync each)
    inside a goodput run window. Returns (every step's outputs, warm-up
    seconds, timed seconds, launches per timed step, the window's goodput
    report or None)."""
    outs = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        outs.append(step_once())
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    CK.reset_launches()
    report = None
    t0 = time.perf_counter()
    if mon is None:
        for _ in range(STEPS):
            outs.append(step_once())
    else:
        led = obs_goodput.ledger()
        led.start_window()
        outs += monitored_steps(step_once, mon, STEPS)
        report = led.end_window()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k: v / STEPS for k, v in CK.LAUNCHES.items() if v}
    return outs, warm_s, wall, launches, report


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


def run(cfg: G.GPTConfig, fused_opt_kernel=None,
        profile_steps: int = 0, monitor: str = None,
        overhead_dir: str = None) -> Dict[str, Any]:
    """WARMUP + STEPS train steps on one batch on the card; the timed
    steps end in one synchronize, and launch counts are zeroed just before
    them (then ``profile_steps`` traced steps, outside the counts and
    losses). ``monitor`` (a path) makes the timed steps monitored: one
    :class:`TrainMonitor` row a step there, one sync a step, the goodput
    window's report in the record (``monitor``). ``overhead_dir`` then
    adds :func:`observability_overhead`'s pairs (``obs_overhead``)."""
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
                   fuse: bool = True, synthetic: bool = True):
    """(main, startup, loss) of ``bench.py``'s ResNet lane: the images and
    labels made by ``uniform_random`` / ``randint`` ops each step, or, with
    ``synthetic=False``, fed through ``layers.data`` ("img", "label")."""
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
        fluid_optimizer.Momentum(0.01, 0.9, fuse=fuse).minimize(loss)
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


def run_resnet(fuse: bool = True, profile_steps: int = 0,
               host_profile_steps: int = 0) -> Dict[str, Any]:
    """One warm step and STEPS timed ones of the ResNet lane on the card,
    as ``bench.py``'s lane runs them, counted as :func:`run` does (each
    step's loss fetched as a device tensor, read after the timed window);
    then ``profile_steps`` steps under ``torch.profiler`` and
    ``host_profile_steps`` under ``cProfile``."""
    dev = torch.device("cuda")
    batch, hw_ = RESNET_BATCH, RESNET_HW
    main, startup, loss = resnet_program(fuse=fuse)
    exe = FW.Executor(FW.CUDAPlace(0))
    scope = FW.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters()
                   if p.trainable)
    outs, warm_s, wall, launches, _ = _timed(
        lambda: exe.run(main, fetch_list=[loss], scope=scope,
                        return_numpy=False)[0], dev, warmup=1)
    losses = [float(o) for o in outs]
    img_s = STEPS * batch / wall
    flops = hw.program_train_flops(main, batch)
    name = torch.cuda.get_device_name(dev)
    rec = {
        "config": f"resnet50_b{batch}_{hw_}px_f32"
                  + ("_fused" if fuse else "_nofuse"),
        "device": name,
        "model_params": n_params,
        "batch": batch, "image": hw_, "steps": STEPS, "warmup": 1,
        "fuse": fuse,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "flops_per_step": flops,
        "images_per_s": img_s,
        "mfu": img_s * flops / batch
        / hw.peaks_for(name)["bf16_flops_per_s"],
        "ms_per_step": wall / STEPS * 1e3,
        "warmup_s": warm_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses,
        "launches_per_step": launches,
    }
    if profile_steps:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_steps):
                exe.run(main, scope=scope)
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        rec["profile"] = {"steps": profile_steps, **trace_summary(
            prof, wall_us, profile_steps, "step", RESNET_KERNELS)}
    if host_profile_steps:
        rec["host_profile"] = _host_profile(
            lambda: exe.run(main, scope=scope), host_profile_steps)
    return rec


def resnet_fixed_batch(steps: int = 6, fuse: bool = True, seed: int = 0):
    """``steps`` steps of the ResNet lane's model on one fixed fed batch
    (numpy seed ``seed``): the losses, which must fall as the batch is
    learnt."""
    main, startup, loss = resnet_program(fuse=fuse, synthetic=False)
    exe = FW.Executor(FW.CUDAPlace(0))
    scope = FW.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(seed)
    feed = {"img": rng.uniform(-1, 1, (RESNET_BATCH, 3, RESNET_HW,
                                       RESNET_HW)).astype(np.float32),
            "label": rng.integers(0, RESNET_CLASSES, (RESNET_BATCH, 1))}
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(steps)]


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
               "sharding": str, "ckpt_dir": str, "overlap_dir": str}


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
        rec = (run_ernie_parallel(lay, dev) if args.model == "ernie"
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
                    choices=("gpt", "ernie", "resnet50"))
    ap.add_argument("--no-fuse", action="store_true",
                    help="resnet50: one momentum op a parameter")
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
                          "name one card to put every rank on it")
    par.add_argument("--layout", action="append", metavar="SPEC",
                     help="run this layout (key=value,...: dp, pp, tp, "
                          "microbatches, layers, grad_reduce, comm_dtype, "
                          "sharding, ckpt_dir over the flags above); repeat "
                          "to run several over one gang, in turn")
    par.add_argument("--out-dir", default=None,
                     help="write each rank's record to "
                          "layout<i>.rank<r>.json here")
    par.add_argument("--overlap-dir", default=None,
                     help="after the timed steps, trace one more into "
                          "<dir>/rank<r> and record the share of its "
                          "collective time compute overlaps")
    par.add_argument("--tiny", action="store_true",
                     help="a CPU rehearsal's widths (with --device cpu)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if "PADDLE_TRAINERS_NUM" in os.environ:
        return main_parallel(args)
    if not torch.cuda.is_available():
        print("train_bench: no CUDA device available", file=sys.stderr)
        return 2
    order = ("plain", "kernel", "kernel", "plain") if args.compare \
        else ("kernel",)
    if args.model == "resnet50":
        if not args.compare:
            order = ("plain",) if args.no_fuse else ("kernel",)
        for arm in order:
            rec = run_resnet(fuse=arm == "kernel",
                             profile_steps=args.profile,
                             host_profile_steps=args.host_profile)
            rec["arm"] = "fused" if arm == "kernel" else "no-fuse"
            print(json.dumps(rec), flush=True)
        return 0
    if args.model == "ernie":
        cfg = ernie_config(args.fused_ln)
        arms = {"kernel": cfg, "plain": cfg.scaled(use_flash=False)}
    else:
        cfg = bench_config(args.remat, args.fused_ln, args.ce_vchunk)
        arms = {"kernel": (cfg, None), "plain": (plain_config(cfg), False)}
    for arm in order:
        if args.model == "ernie":
            rec = run_ernie(arms[arm], args.pad, args.profile)
        else:
            acfg, kern = arms[arm]
            rec = run(acfg, fused_opt_kernel=kern,
                      profile_steps=args.profile, monitor=args.monitor)
        rec["arm"] = arm
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
