"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds ops/csrc/*.cu for sm_90a (one process per
             source, in parallel); ptxas's registers / shared memory /
             spills per kernel and the build seconds are printed;
3. kernels — each kernel against its plain PyTorch version at the serving
             path's shapes (GPT_SMALL, batch 8, max_seq 1024), in bf16 and
             in float32: outputs within 1e-2 (bf16, about one bf16 ulp) or
             1e-5 (float32), updated KV caches bitwise; then the bf16
             kernel, its plain version and one PyTorch library call are
             timed with CUDA events;
4. serving — a GPT_SMALL bf16 engine (seed weights, max_batch 8, max_seq
             1024, buckets 64..512) serves 16 seeded greedy requests
             through Scheduler + EngineLoop; every request must finish
             "done" and every kernel's launch count must be what the
             decode ticks imply (counts are zeroed just before);
5. parity  — a 2-layer GPT_SMALL in float32 (TF32 off): prefill logits
             within 1e-4 of the full forward, and the kernel engine and
             the plain-PyTorch engine must emit identical greedy tokens,
             with per-step logits within 1e-4;
6. train kernels — flash forward, dQ, dK/dV against their plain versions
             at the training path's shapes (q/k/v [16, 1024, 12, 64]
             sliced from one packed qkv, causal) in bf16 (each element
             within 2^-7 x (|plain| + its row's max |plain|) + 1e-5, lse
             within 2e-5) and at batch 2 in float32 (2e-5 forward, 3e-4
             backward), and the flat AdamW sweep over n = 163,109,376
             with bf16 and float32 moments, bitwise; then the bf16 kernels,
             their plain versions and the library yardsticks are timed;
7. training — GPT_SMALL at full width and depth, batch 16 x 1024, bf16,
             flash, dots remat, flat AdamW kernel: 2 warm-up + 10 timed
             steps through tools/train_bench.py (counts zeroed just
             before the timed steps); every loss finite, the last below
             the first, launches per step flash_fwd 2L, flash_bwd_dq L,
             flash_bwd_dkv L, opt_adamw_flat 1; then a 2-layer float32
             card parity check (TF32 off): 3 steps of the kernel step vs
             the plain step (use_flash off, plain sweep), losses within
             1e-5 relative, step-1 gradients within 3e-4.

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
B, S = 8, 1024           # the serving path's batch and max_seq


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from paddle_tpu_torch.ops import _build

    info = _build.build()
    print(f"[build] {info.path} in {info.seconds:.2f} s "
          f"(cached={info.cached})")
    for src, log in info.logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "error", "warning")):
                print(f"[build] {src}: {line.strip()}")
    _build.load()
    return info


def _time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _over_layers(fn, n: int):
    """A thunk calling fn(0), fn(1), ..., fn(n-1), fn(0), ... — timed
    launches walk the layers' slabs as a decode tick does, so the caches
    come from HBM, not from L2."""
    layers = itertools.cycle(range(n))
    return lambda: fn(next(layers))


def _check_close(name: str, got, want, dtype, tol=None) -> float:
    err = (got.float() - want.float()).abs().max().item()
    tol = ATOL[dtype] if tol is None else tol
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{name} {dtype}: {m}")
    return err


def phase_kernels(dtype, time_it: bool):
    """Each kernel vs its plain version at the path's shapes; returns one
    record per kernel (errors, and times when ``time_it``)."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.observability.hw import bound_ms
    from paddle_tpu_torch.ops import cuda_kernels as CK

    cfg = GPT_SMALL
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    nh, hd = cfg.num_heads, cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(*shape, dt=dtype, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

    esz = torch.empty((), dtype=dtype).element_size()
    fdt = "bf16" if dtype == torch.bfloat16 else "f32"
    scale = 1.0 + randn(D, dt=torch.float32, s=0.1)
    bias = randn(D, dt=torch.float32, s=0.1)
    recs = {}

    # -- fused_ln: x [B, D] -------------------------------------------------
    x = randn(B, D)
    got, want = CK.fused_ln(x, scale, bias), CK.fused_ln_plain(x, scale, bias)
    torch.cuda.synchronize()
    rec = {"max_abs_err": _check_close("fused_ln", got, want, dtype)}
    if time_it:
        rec["ms"] = _time_ms(lambda: CK.fused_ln(x, scale, bias))
        rec["plain_ms"] = _time_ms(lambda: CK.fused_ln_plain(x, scale, bias))
        s16, b16 = scale.to(dtype), bias.to(dtype)
        rec["library_ms"] = _time_ms(
            lambda: F.layer_norm(x, (D,), s16, b16, 1e-5))
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            2 * B * D * esz + 2 * D * 4, 8 * B * D, "f32", name)
    recs["fused_ln"] = rec

    # -- decode_slab: q/k/v as the engine slices them out of one qkv ------
    qkv = randn(B, 3, nh, hd)
    q, nk, nv = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    kc = randn(L, B, S, nh, hd)
    vc = randn(L, B, S, nh, hd)
    pos_np = np.random.default_rng(7).integers(0, S, size=B).astype(np.int32)
    act_np = np.ones(B, np.int32)
    act_np[3] = 0                      # one masked lane: its row must stay
    positions = torch.from_numpy(pos_np).to(dev)
    active = torch.from_numpy(act_np).to(dev)
    k1, v1, k2, v2 = kc[0].clone(), vc[0].clone(), kc[0].clone(), vc[0].clone()
    got, _, _ = CK.fused_decode_attention(q, k1, v1, nk, nv, positions, active)
    want, _, _ = CK.fused_decode_attention_plain(q, k2, v2, nk, nv,
                                                 positions, active)
    torch.cuda.synchronize()
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        raise AssertionError(f"decode_slab {dtype}: updated caches differ "
                             "from the plain version's")
    if not (torch.equal(k1[3], kc[0][3]) and torch.equal(v1[3], vc[0][3])):
        raise AssertionError(f"decode_slab {dtype}: masked lane was written")
    rec = {"max_abs_err": _check_close("decode_slab", got, want, dtype)}
    if time_it:
        rec["ms"] = _time_ms(_over_layers(
            lambda i: CK.fused_decode_attention(q, kc[i], vc[i], nk, nv,
                                                positions, active), L))
        rec["plain_ms"] = _time_ms(_over_layers(
            lambda i: CK.fused_decode_attention_plain(
                q, kc[i], vc[i], nk, nv, positions, active), L))
        q4 = q.unsqueeze(2)
        mask = (torch.arange(S, device=dev)[None, None, None, :]
                <= positions.long()[:, None, None, None])
        rec["library_ms"] = _time_ms(_over_layers(
            lambda i: F.scaled_dot_product_attention(
                q4, kc[i].transpose(1, 2), vc[i].transpose(1, 2),
                attn_mask=mask), L))
        rows = int((pos_np.astype(np.int64) + 1).sum())      # rows read
        nbytes = (3 * B * nh * hd * esz                      # q, new k/v
                  + 2 * rows * nh * hd * esz                 # K, V rows
                  + 2 * int(act_np.sum()) * nh * hd * esz    # rows written
                  + B * nh * hd * esz + 2 * B * 4)           # out, ints
        flops = rows * nh * (4 * hd + 3)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, "f32",
                                                    name)
    recs["decode_slab"] = rec

    # -- logits_head: x [B, D] x lm_head [D, V] ------------------------------
    w = randn(D, V, s=0.02)
    got = CK.fused_logits_head(x, scale, bias, w)
    want = CK.fused_logits_head_plain(x, scale, bias, w)
    torch.cuda.synchronize()
    rec = {"max_abs_err": _check_close("logits_head", got, want, dtype)}
    if not torch.equal(got.float().argmax(-1), want.float().argmax(-1)):
        print(f"[kernels] logits_head {dtype}: argmax differs on a tie-level "
              "logit (within tolerance)")
    if time_it:
        rec["ms"] = _time_ms(lambda: CK.fused_logits_head(x, scale, bias, w))
        rec["plain_ms"] = _time_ms(
            lambda: CK.fused_logits_head_plain(x, scale, bias, w))
        y = CK.fused_ln_plain(x, scale, bias)
        rec["library_ms"] = _time_ms(lambda: torch.matmul(y, w))
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            B * D * esz + 2 * D * 4 + D * V * esz + B * V * esz,
            2 * B * D * V + 8 * B * D, fdt, name)
    recs["logits_head"] = rec
    for k, r in recs.items():
        print(f"[kernels] {k} {dtype}: " + ", ".join(
            f"{a}={b:.6g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()))
    return recs


def _pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q))


def phase_serving():
    """GPT_SMALL bf16 through Scheduler + EngineLoop; returns the launch
    counts of the run."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.serving import (DecodeEngine, EngineConfig,
                                          EngineLoop, Scheduler)

    cfg = GPT_SMALL
    params = init_params(cfg, seed=0, device="cuda")
    ecfg = EngineConfig(max_batch=B, max_seq=S,
                        prefill_buckets=(64, 128, 256, 512),
                        weight_dtype="bf16", fused_decode=True)
    eng = DecodeEngine(params, cfg, ecfg, device="cuda")
    del params
    warm = eng.warmup()
    print("[serving] warmup ms: " + ", ".join(
        f"{k}={v:.1f}" for k, v in warm.items()))
    sched = Scheduler(eng, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 401, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks0 = eng.decode_ticks
    CK.reset_launches()
    loop = EngineLoop(sched).start()
    t0 = time.perf_counter()
    try:
        reqs = [sched.submit(p, max_new_tokens=64, timeout_s=300.0)
                for p in prompts]
        loop.wake()
        for r in reqs:
            if not r.wait(timeout=600.0):
                raise AssertionError(f"request {r.id} did not finish")
    finally:
        loop.stop()
    wall = time.perf_counter() - t0
    launches = dict(CK.LAUNCHES)
    ticks = eng.decode_ticks - ticks0
    bad = [(r.id, r.state, r.error) for r in reqs if r.state != "done"]
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    if loop.faults:
        raise AssertionError(f"engine loop faults: {loop.last_fault}")
    L = cfg.num_layers
    want = dict.fromkeys(CK.LAUNCHES, 0)
    want.update(fused_ln=2 * L * ticks, decode_slab=L * ticks,
                logits_head=ticks)
    if ticks <= 0 or launches != want:
        raise AssertionError(f"launch counts {launches} != {want} for "
                             f"{ticks} decode ticks")
    ntok = sum(len(r.tokens) for r in reqs)
    if ntok != 16 * 64:
        raise AssertionError(f"{ntok} tokens generated, expected {16 * 64}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        raise AssertionError("a generated token lies outside the vocabulary")
    ttft = [r.ttft_ms for r in reqs]
    tpot = [r.tpot_ms for r in reqs]
    print(f"[serving] 16 requests done, {ntok} tokens in {wall:.3f} s "
          f"({ntok / wall:.1f} tok/s), {ticks} decode ticks")
    print(f"[serving] ttft_ms p50={_pct(ttft, 50):.3f} "
          f"p99={_pct(ttft, 99):.3f}; tpot_ms p50={_pct(tpot, 50):.3f}; "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated()}")
    print(f"[serving] launches {launches}")
    return launches


def phase_parity():
    """Kernel engine vs plain-PyTorch engine, float32, on the card."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.serving import DecodeEngine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT_SMALL.scaled(num_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cuda")
    ekw = dict(max_batch=4, max_seq=256, prefill_buckets=(64, 128))
    engines = [DecodeEngine(params, cfg, EngineConfig(fused_decode=f, **ekw),
                            device="cuda") for f in (True, False)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in (5, 17, 40, 100)]
    worst = 0.0
    toks = [{}, {}]
    for e_i, eng in enumerate(engines):
        slots, cur = {}, {}
        for p_i, p in enumerate(prompts):
            slot, logits = eng.start_sequence(p)
            ref = eng.reference_logits(p)[-1]
            if not np.allclose(logits, ref, atol=1e-4, rtol=1e-4):
                raise AssertionError(
                    f"prompt {p_i}: prefill logits differ from the full "
                    f"forward by {np.abs(logits - ref).max()}")
            slots[p_i] = slot
            cur[p_i] = int(np.argmax(logits))
            toks[e_i][p_i] = [cur[p_i]]
        steps = []
        for _ in range(31):
            out = eng.decode_step({slots[i]: cur[i] for i in slots})
            steps.append({i: out[slots[i]] for i in slots})
            for i in slots:
                cur[i] = int(np.argmax(out[slots[i]]))
                toks[e_i][i].append(cur[i])
        toks[e_i]["logits"] = steps
    for a, b in zip(toks[0]["logits"], toks[1]["logits"]):
        for i in a:
            worst = max(worst, float(np.abs(a[i] - b[i]).max()))
    for i in range(len(prompts)):
        if toks[0][i] != toks[1][i]:
            raise AssertionError(f"prompt {i}: kernel tokens {toks[0][i]} "
                                 f"!= plain tokens {toks[1][i]}")
    if not worst <= 1e-4:
        raise AssertionError(f"per-step logits differ by {worst} > 1e-4")
    print(f"[parity] 4 prompts x 32 greedy tokens identical (f32, 2 "
          f"layers); prefill logits match the full forward; max per-step "
          f"logit diff {worst:.3g}")


def bf16_check(name, got, want) -> float:
    """Each element of a bf16 [..., hd] output against its plain version:
    |got - want| <= 2^-7 (|want| + max |want| over the element's row)
    + 1e-5, that is 1-2 bf16 ulps of the element plus 1-2 of its row's
    largest (2^-7 is one bf16 ulp at 1.0). Every query or key row is held
    at its own scale, late rows as tightly as early ones; the 1e-5 covers
    rows whose exact value is zero (dq's first causal row, where dP - D
    cancels), which hold float32 rounding noise only. Prints the worst
    ratio of diff to bound, raises when it exceeds 1, and returns the max
    abs diff."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = (2.0 ** -7 * (want.abs() + want.abs().amax(-1, keepdim=True))
             + 1e-5)
    worst = (err / bound).max().item()
    print(f"[train-kernels] {name}: worst diff/bound {worst:.4g}")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: {int((err > bound).sum())} elements "
                             f"over the bound, worst diff/bound {worst:.4g}")
    return err.max().item()


def phase_train_kernels(dtype, time_it: bool):
    """The training kernels vs their plain versions at the training path's
    shapes; one record per kernel (errors, and times when ``time_it``)."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.observability.hw import bound_ms
    from paddle_tpu_torch.ops import flash_attention as FA

    bf16 = dtype == torch.bfloat16
    # the float32 plain versions must run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    nh, hd = GPT_SMALL.num_heads, GPT_SMALL.head_dim
    Bt, Tt = (16 if bf16 else 2), 1024
    g = torch.Generator(device=dev)
    g.manual_seed(4321)

    def randn(*shape, dt=dtype, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

    def check(kname, got, want, f32_tol):
        if bf16:
            return bf16_check(f"{kname} bf16", got, want)
        return _check_close(kname, got, want, dtype, f32_tol)

    qkv = randn(Bt, Tt, 3, nh, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = randn(Bt, Tt, nh, hd)
    recs = {}
    o, lse = FA.flash_fwd(q, k, v)
    o_p, lse_p = FA.flash_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    # lse is float32 in both dtypes: the f32 tolerance
    recs["flash_fwd"] = {"max_abs_err": max(
        check("flash_fwd o", o, o_p, 2e-5),
        _check_close("flash_fwd lse", lse, lse_p, torch.float32, 2e-5))}
    dq = FA.flash_bwd_dq(q, k, v, o_p, lse_p, do)
    dq_p = FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do)
    torch.cuda.synchronize()
    recs["flash_bwd_dq"] = {"max_abs_err": check("flash_bwd_dq", dq, dq_p,
                                                 3e-4)}
    dk, dv = FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do)
    dk_p, dv_p = FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do)
    torch.cuda.synchronize()
    recs["flash_bwd_dkv"] = {"max_abs_err": max(
        check("flash_bwd_dkv dk", dk, dk_p, 3e-4),
        check("flash_bwd_dkv dv", dv, dv_p, 3e-4))}
    del dq_p, dk_p, dv_p
    if time_it:
        esz = q.element_size()
        act = Bt * Tt * nh * hd * esz             # one [B, T, nh, hd]
        lse_b = Bt * nh * Tt * 4
        pairs = Bt * nh * Tt * (Tt + 1) // 2      # causal (q, k) pairs
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        for kname, n_in, n_out, n_mm, fn, plain in (
                ("flash_fwd", 3, 1, 2, lambda: FA.flash_fwd(q, k, v),
                 lambda: FA.flash_fwd_plain(q, k, v)),
                ("flash_bwd_dq", 5, 1, 3,
                 lambda: FA.flash_bwd_dq(q, k, v, o_p, lse_p, do),
                 lambda: FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do)),
                ("flash_bwd_dkv", 5, 2, 4,
                 lambda: FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do),
                 lambda: FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do))):
            r = recs[kname]
            r["ms"] = _time_ms(fn, iters=20, warmup=3)
            r["plain_ms"] = _time_ms(plain, iters=3, warmup=1)
            nbytes = (n_in + n_out) * act + lse_b
            r["bound_ms"], r["bound_by"] = bound_ms(
                nbytes, 2 * hd * n_mm * pairs, "bf16", name)
        recs["flash_fwd"]["library_ms"] = _time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            iters=20, warmup=3)
        ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        dot = do.transpose(1, 2)
        bwd_ms = _time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), dot, retain_graph=True), iters=20, warmup=3)
        # one SDPA backward computes dq, dk and dv together
        recs["flash_bwd_dq"]["library_ms"] = bwd_ms
        recs["flash_bwd_dkv"]["library_ms"] = bwd_ms
        del ol
    del qkv, q, k, v, do, o, lse, o_p, lse_p, dq, dk, dv
    recs["opt_adamw_flat"] = _sweep_check(torch.float32 if not bf16
                                          else torch.bfloat16, time_it)
    for kname, r in recs.items():
        print(f"[train-kernels] {kname} {dtype}: " + ", ".join(
            f"{a}={b:.6g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()))
    torch.cuda.empty_cache()
    return recs


N_PARAMS = 163_109_376      # GPT_SMALL's parameter count: the sweep's n


def _sweep_check(mdt, time_it: bool):
    """The AdamW sweep over GPT_SMALL's flat buffers vs its plain version,
    bitwise for p, m and v; timed with bf16 moments."""
    from paddle_tpu_torch.observability.hw import bound_ms
    from paddle_tpu_torch.ops import cuda_kernels as CK

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    n = N_PARAMS
    p = torch.randn(n, generator=g, device=dev)
    grad = torch.randn(n, generator=g, device=dev) * 1e-2
    m = (torch.randn(n, generator=g, device=dev) * 1e-3).to(mdt)
    v = (torch.rand(n, generator=g, device=dev) * 1e-5).to(mdt)
    mask = (torch.rand(n, generator=g, device=dev) < 0.9).float()
    sc = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (1e-4, 0.7, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    outs = []
    for fn in (CK.megakernel_adamw_flat, CK.megakernel_adamw_flat_plain):
        pc, mc, vc = p.clone(), m.clone(), v.clone()
        fn(pc, grad, mc, vc, mask, *sc, **hp)
        outs.append((pc, mc, vc))
    torch.cuda.synchronize()
    for got, want, what in zip(outs[0], outs[1], ("p", "m", "v")):
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"opt_adamw_flat {mdt}: {what} differs "
                                 f"from the plain version in {bad} elements")
    rec = {"max_abs_err": 0.0}
    del outs
    if time_it:
        rec["ms"] = _time_ms(lambda: CK.megakernel_adamw_flat(
            p, grad, m, v, mask, *sc, **hp), iters=20, warmup=3)
        rec["plain_ms"] = _time_ms(lambda: CK.megakernel_adamw_flat_plain(
            p, grad, m, v, mask, *sc, **hp), iters=5, warmup=1)
        # no single PyTorch call computes the masked flat AdamW sweep
        rec["library_ms"] = None
        esz = m.element_size()
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            n * (4 * 4 + 4 * esz), 18 * n, "f32", torch.cuda.get_device_name(0))
    return rec


def phase_training():
    """GPT_SMALL training through tools/train_bench.py; returns its record
    (launches_per_step from the timed steps only)."""
    from paddle_tpu_torch.tools import train_bench

    cfg = train_bench.bench_config()
    rec = train_bench.run(cfg)
    losses = rec["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "opt_adamw_flat": 1}
    if rec["launches_per_step"] != want:
        raise AssertionError(f"launches per step {rec['launches_per_step']}"
                             f" != {want}")
    print(f"[training] {rec['config']} {rec['model_params']} params: "
          f"{rec['tokens_per_s']:.1f} tok/s, mfu={rec['mfu']:.4f}, "
          f"ms/step={rec['ms_per_step']:.3f}, peak_mem_bytes="
          f"{rec['peak_mem_bytes']}, warmup_s={rec['warmup_s']:.2f}")
    print(f"[training] loss first={losses[0]:.6f} last={losses[-1]:.6f} "
          f"({len(losses)} steps); launches/step {rec['launches_per_step']}")
    return rec


def phase_train_parity():
    """Kernel train step vs plain train step, float32, on the card."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = G.GPT_SMALL.scaled(num_layers=2, dtype=torch.float32, remat=True,
                              remat_policy="dots")
    arms = {"kernel": (base.scaled(use_flash=True), None),
            "plain": (base.scaled(use_flash=False), False)}
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (1, 2, 256))
                            ).cuda()
    labs = torch.from_numpy(rng.integers(0, base.vocab_size, (1, 2, 256))
                            ).cuda()
    grads, losses = {}, {}
    for arm, (cfg, kern) in arms.items():
        params, opt = PZ.init_sharded(cfg, seed=2, fused_opt=True,
                                      device="cuda")
        live = [p.detach().requires_grad_() for p in PZ.flat_leaves(params)]
        loss = G.loss_fn(PZ._unflatten(params, live), toks[0], labs[0], cfg)
        grads[arm] = torch.autograd.grad(loss, live)
        step = PZ.make_train_step(cfg, lr=1e-4, fused_opt=True,
                                  fused_opt_kernel=kern, device="cuda")
        losses[arm] = []
        for _ in range(3):
            params, opt, loss, _g = step(params, opt, toks, labs)
            losses[arm].append(loss.item())
    worst = 0.0
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)
        worst = max(worst, (a - b).abs().max().item())
    np.testing.assert_allclose(losses["kernel"], losses["plain"], rtol=1e-5)
    print(f"[train-parity] f32 2 layers, 3 steps of 2x256: losses kernel "
          f"{losses['kernel']} plain {losses['plain']}; step-1 grad max "
          f"diff {worst:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import cuda_kernels as CK

    smi = phase_device()
    phase_build()
    recs = phase_kernels(torch.bfloat16, time_it=True)
    phase_kernels(torch.float32, time_it=False)
    launches = phase_serving()
    phase_parity()
    recs.update(phase_train_kernels(torch.bfloat16, time_it=True))
    phase_train_kernels(torch.float32, time_it=False)
    train = phase_training()
    launches.update({k: round(v * train["steps"])
                     for k, v in train["launches_per_step"].items()})
    phase_train_parity()
    kernels = []
    for name, meta in CK.KERNELS.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
