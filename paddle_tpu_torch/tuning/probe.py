"""Shared measurement harness of the autotuner's probes — the port of
``paddle_tpu/tuning/probe.py`` (names and result schemas the
reference's).

* :func:`device_info` / :func:`hw_fingerprint` — the one derivation of
  ``platform / device_kind / n_devices / degraded`` and the fingerprint
  TUNED.json is validated against: ``platform`` "gpu" on the card and
  "cpu" off it, ``device_kind`` ``torch.cuda.get_device_name``,
  ``n_devices`` ``torch.cuda.device_count()`` (1 on the CPU), and
  ``degraded`` when the device has no row in ``observability/hw.PEAKS``;
* :func:`timed_loop` — first call timed as the "compile", then ``steps``
  timed calls, per-step-synced or block-timed with one trailing sync;
* :func:`run_train_probe` — build + measure one train-space candidate
  through ``parallelize.make_train_step`` (N warmup + M timed steps,
  optional TrainMonitor rows, the step's program report for the static
  model);
* :func:`run_serve_probe` — short closed-loop serving drive of one
  serve-space candidate (``DecodeEngine`` behind a ``Scheduler`` and
  ``EngineLoop``, the disagg router for ratio candidates), scored by the
  SLO engine's verdict.

"Compile" has no XLA meaning here: ``compile_s`` is the first call's
wall — autograd's first pass, cuBLAS's heuristics, lazy module loads —
as ``program_report``'s ``compile_ms`` is. Each probe builds a fresh
model: the previous probe's tensors are released and the allocator's
cache emptied and its peak reset first, so a probe's
``peak_hbm_bytes`` holds its own state only. Weights come from a seeded
``torch.Generator`` (``models/gpt.init_params``) where the reference
draws from ``jax.random.PRNGKey(seed)``; prompts and batches come from
numpy's seeded generators, as the reference's do, so both packages feed
the same tokens.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional

from .space import Candidate, parse_disagg_ratio

__all__ = ["DeviceInfo", "device_info", "hw_fingerprint", "ProbeTiming",
           "timed_loop", "TrainProbeGeometry", "run_train_probe",
           "ServeProbeGeometry", "run_serve_probe", "release_memory"]


# ---------------------------------------------------------------------------
# device identity
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str                # "gpu" | "cpu"
    device_kind: str
    n_devices: int
    on_acc: bool                 # a card
    degraded: bool               # no peak-rate row: timings are mechanism
                                 # checks, not hardware facts
    device: Any = None           # the torch.device


def device_info(device=None) -> DeviceInfo:
    """The identity of ``device`` (default: the card; the CPU only when
    asked for). Raises when the card is asked for and none is visible."""
    import torch

    from ..observability import hw

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' for the "
                           "CPU)")
    if dev.type != "cuda":
        return DeviceInfo(platform="cpu", device_kind="cpu", n_devices=1,
                          on_acc=False, degraded=True, device=dev)
    kind = torch.cuda.get_device_name(dev)
    try:
        hw.peaks_for(kind)
        degraded = False
    except KeyError:
        degraded = True
    return DeviceInfo(platform="gpu", device_kind=kind,
                      n_devices=torch.cuda.device_count(), on_acc=True,
                      degraded=degraded, device=dev)


def hw_fingerprint(di: Optional[DeviceInfo] = None) -> Dict[str, Any]:
    """Stable identity of the hardware a tune ran on. TUNED.json carries
    this; appliers refuse (warn + fall back to defaults) on mismatch so a
    CPU-tuned config never silently lands on the card."""
    di = di or device_info()
    doc = {"platform": di.platform, "device_kind": di.device_kind,
           "n_devices": di.n_devices, "degraded": di.degraded}
    doc["fingerprint"] = hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:12]
    return doc


def release_memory(device) -> None:
    """Drop what the last probe left: collect its cycles, return the
    allocator's cached blocks and reset its peak (on a card)."""
    import torch

    gc.collect()
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


# ---------------------------------------------------------------------------
# the one warmup/compile/timing loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProbeTiming:
    compile_s: float             # first call's wall, synced
    step_times_s: List[float]    # per-step wall, per_step_sync mode only
    block_s: float               # the whole timed region
    steps: int
    values: List[Any]            # step_fn returns, first call included

    @property
    def ms_per_step(self) -> float:
        import numpy as np

        if self.step_times_s:
            return float(np.median(self.step_times_s)) * 1e3
        return self.block_s / max(self.steps, 1) * 1e3


def timed_loop(step_fn: Callable[[int], Any], steps: int, *,
               sync: Callable[[Any], Any] = lambda v: v,
               per_step_sync: bool = True,
               warmup: int = 0,
               after_compile: Optional[Callable[[], Any]] = None
               ) -> ProbeTiming:
    """Run ``step_fn(i)`` once (timed, synced: the first call), ``warmup``
    extra untimed calls, then ``steps`` timed calls.

    ``per_step_sync=True`` syncs and times every step (wall time IS step
    time); ``False`` dispatches the whole block and syncs once at the end
    (the throughput discipline). ``after_compile`` runs between the first
    call and the timed region (counter snapshots that must span exactly
    the first call)."""
    t0 = time.perf_counter()
    v = step_fn(0)
    sync(v)
    compile_s = time.perf_counter() - t0
    values = [v]
    if after_compile is not None:
        after_compile()
    for w in range(warmup):
        v = step_fn(w + 1)
        sync(v)
        values.append(v)
    times: List[float] = []
    t_block = time.perf_counter()
    for i in range(steps):
        t1 = time.perf_counter()
        v = step_fn(warmup + 1 + i)
        if per_step_sync:
            sync(v)
            times.append(time.perf_counter() - t1)
        values.append(v)
    if not per_step_sync and values:
        sync(values[-1])
    block_s = time.perf_counter() - t_block
    return ProbeTiming(compile_s=compile_s, step_times_s=times,
                       block_s=block_s, steps=steps, values=values)


# ---------------------------------------------------------------------------
# train-space probe
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainProbeGeometry:
    d_model: int = 64
    num_layers: int = 2
    num_heads: int = 4
    d_ff: int = 128
    T: int = 32
    vocab_size: int = 256
    batch: int = 4               # GLOBAL batch
    dp: int = 1
    use_flash: bool = False
    lr: float = 1e-4


def _probe_report(step) -> Dict[str, Any]:
    from ..observability import program_report as prep

    name = getattr(step, "report_name", None)
    return next((r for r in reversed(prep.recent_reports())
                 if r.get("program") == name), {})


def train_probe_config(cand: Candidate, geom: TrainProbeGeometry,
                       on_acc: bool):
    """The ``GPTConfig`` a train candidate is probed at."""
    import torch

    from ..models import gpt as G
    from ..parallel import remat as remat_mod

    rpolicy = remat_mod.resolve(cand.get("remat", "none"))
    vchunk = int(cand.get("ce_vocab_chunk", 0))
    return G.GPT_TINY.scaled(
        d_model=geom.d_model, num_layers=geom.num_layers,
        num_heads=geom.num_heads, d_ff=geom.d_ff, max_seq_len=geom.T,
        vocab_size=geom.vocab_size,
        dtype=torch.bfloat16 if on_acc else torch.float32,
        use_flash=geom.use_flash and on_acc,
        remat=not rpolicy.is_none, remat_policy=rpolicy.name,
        fused_ln=bool(cand.get("fused_ln", False)),
        ce_vocab_chunk=vchunk,
        ce_direct_bytes_limit=0 if vchunk
        else G.GPT_TINY.ce_direct_bytes_limit)


def train_step_kwargs(cand: Candidate) -> Dict[str, Any]:
    """A train candidate's ``make_train_step`` / ``init_sharded`` comm
    kwargs and ``fused_opt``."""
    comm_dtype = cand.get("comm_dtype", "f32")
    return dict(grad_reduce=cand.get("grad_reduce", "psum"),
                grad_allreduce_dtype=None if comm_dtype == "f32"
                else comm_dtype,
                bucket_mb=float(cand.get("bucket_mb", 32.0)),
                error_feedback=bool(cand.get("error_feedback", False)),
                fused_opt=bool(cand.get("fused_opt", False)))


def probe_batch(geom: TrainProbeGeometry, vocab: int, seed: int):
    """The probe's tokens and labels, [1, batch, T] int32 from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, vocab, (1, geom.batch, geom.T),
                              dtype=np.int32) for _ in range(2))


def run_train_probe(cand: Candidate, geom: TrainProbeGeometry, steps: int,
                    *, warmup: int = 0, monitor: Optional[str] = None,
                    seed: int = 0, device=None,
                    count_flops: bool = False) -> Dict[str, Any]:
    """Measure one train-space candidate; returns a result dict whose
    ``score`` (ms/step, lower better) drives the search. ``geom.dp`` > 1
    runs over the mesh of an initialised world of that many ranks
    (``parallel.launch``); dp 1 is the one-device step. ``count_flops``
    makes the step's program report count its ``aten`` FLOPs (the
    static model's anchor; the tuner asks it of the incumbent's rung-0
    probe alone, as counting costs the first step seconds on the card)."""
    import torch

    from ..models import gpt as G
    from ..observability import goodput as gp
    from ..observability import program_report as prep
    from ..parallel import parallelize as PZ

    di = device_info(device)
    dev = di.device
    release_memory(dev)
    cfg = train_probe_config(cand, geom, di.on_acc)
    pcfg = PZ.ParallelConfig(dp=geom.dp, pp=1, tp=1, microbatches=1)
    mesh = PZ.build_mesh(pcfg, device=dev) if geom.dp > 1 else None
    kw = train_step_kwargs(cand)
    params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=seed, device=dev,
                                  **kw)
    step = PZ.make_train_step(cfg, pcfg, mesh, lr=geom.lr, device=dev,
                              **kw)
    tokens, labels = probe_batch(geom, cfg.vocab_size, seed)
    tokens, labels = torch.from_numpy(tokens), torch.from_numpy(labels)
    n_params = G.num_params(params)

    def step_fn(i):
        with prep.counting_flops(count_flops and i == 0):
            _, _, loss, gnorm = step(params, opt, tokens, labels)
        return loss, gnorm

    compute0 = gp.ledger().category_seconds("compute")
    try:
        if monitor:
            # monitored discipline: per-step sync, one JSONL row a step
            from ..observability import hw as hw_mod
            from ..observability.monitor import TrainMonitor
            from .static_cost import CPU_PEAK_FLOPS

            timing = timed_loop(step_fn, 0, sync=lambda v: float(v[0]))
            flops_tok = G.train_flops_per_token(cfg, n_params, geom.T)
            peak = (hw_mod.peaks_for(di.device_kind)["bf16_flops_per_s"]
                    if di.on_acc and not di.degraded else CPU_PEAK_FLOPS)
            mon = TrainMonitor(
                path=monitor, examples_per_step=geom.batch,
                tokens_per_step=geom.batch * geom.T,
                flops_per_step=flops_tok * geom.batch * geom.T,
                peak_flops=peak, extra_static={"config": cand.key},
                sample_hbm=di.on_acc)
            for w in range(warmup):
                float(step_fn(w + 1)[0])
            times = []
            for i in range(steps):
                with mon.step() as s:
                    t1 = time.perf_counter()
                    loss, gnorm = step_fn(warmup + 1 + i)
                    s.dispatched()
                    s.observe(loss=loss, grad_norm=gnorm)
                    times.append(time.perf_counter() - t1)
            loss_last = mon.last_record.get("loss")
            mon.close()
            timing = ProbeTiming(compile_s=timing.compile_s,
                                 step_times_s=times, block_s=sum(times),
                                 steps=steps, values=[])
        else:
            timing = timed_loop(step_fn, steps, warmup=warmup,
                                sync=lambda v: float(v[0]),
                                per_step_sync=False)
            loss_last = float(timing.values[-1][0])
        report = _probe_report(step)
        compute_s = gp.ledger().category_seconds("compute") - compute0
    finally:
        del params, opt, step
        release_memory(dev)
    tokens_per_s = steps * geom.batch * geom.T / max(timing.block_s, 1e-9)
    return {
        "score": timing.ms_per_step,
        "ms_per_step": round(timing.ms_per_step, 3),
        "tokens_per_s": round(tokens_per_s, 2),
        "compile_s": round(timing.compile_s, 3),
        "loss": round(float(loss_last), 6) if loss_last is not None
        else None,
        "steps": steps,
        "params": int(n_params) if n_params else None,
        "goodput_compute_s": round(compute_s, 4),
        "report": {k: report.get(k) for k in ("flops", "bytes_accessed",
                                              "compile_ms")} | {
            "peak_hbm_bytes": (report.get("memory") or {}).get(
                "peak_hbm_bytes")},
    }


# ---------------------------------------------------------------------------
# serve-space probe
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeProbeGeometry:
    d_model: int = 64
    num_layers: int = 2
    num_heads: int = 4
    d_ff: int = 128
    vocab_size: int = 256
    max_seq: int = 64
    page_size: int = 8
    max_new_tokens: int = 8
    prompt_len_max: int = 12
    prompt_len_min: int = 2      # the reference's fixed lower bound


def _build_probe_engine(params, cfg, cand: Candidate,
                        geom: ServeProbeGeometry, dev, *,
                        role="colocated", max_batch=None):
    from .. import serving
    from ..models import gpt as G

    kw = dict(
        max_batch=int(max_batch or cand.get("max_batch", 8)),
        max_seq=geom.max_seq,
        prefill_buckets=tuple(cand.get("buckets", (geom.max_seq // 2,))),
        weight_dtype=cand.get("weight_dtype", "f32"),
        fused_decode=bool(cand.get("fused_decode", True)),
        role=role)
    if cand.get("kv_layout") == "paged":
        kw.update(kv_layout="paged", page_size=geom.page_size)
        if cand.get("num_pages", 0):
            kw["num_pages"] = int(cand.get("num_pages"))
    if cand.get("sharding", "none") == "tp":
        kw.update(sharding="tp", tp=int(cand.get("tp", 2)))
    k = int(cand.get("spec", 0))
    if k > 0:
        target = serving.DecodeEngine(params, cfg, serving.EngineConfig(
            verify_window=k + 1, **kw), device=dev)
        dcfg = cfg.scaled(num_layers=max(1, cfg.num_layers // 2))
        dparams = G.init_params(dcfg, seed=99, device=dev)
        draft = serving.DecodeEngine(dparams, dcfg,
                                     serving.EngineConfig(**kw), device=dev)
        return serving.SpecDecodeEngine(target, draft)
    return serving.DecodeEngine(params, cfg, serving.EngineConfig(**kw),
                                device=dev)


def _slo_verdict(ttfts_ms, tpots_ms, failed: int):
    from ..observability import slo as slo_mod

    eng = slo_mod.SLOEngine(min_events=1)
    t = 1000.0
    for i, ttft in enumerate(ttfts_ms):
        tpot = tpots_ms[i] if i < len(tpots_ms) else None
        eng.note_request(ttft_ms=ttft, tpot_ms=tpot, code=200, t=t)
        t += 0.001
    for _ in range(failed):
        eng.note_request(code=500, t=t)
        t += 0.001
    st = eng.evaluate(t)
    return {"ok": bool(st["ok"]),
            "alerting": list(st.get("alerting", []))}


def probe_prompts(geom: ServeProbeGeometry, vocab: int, n: int,
                  seed: int) -> List[List[int]]:
    """The serve probe's prompts: the reference's draw from
    ``np.random.RandomState(seed)``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=int(rng.randint(
        geom.prompt_len_min, geom.prompt_len_max + 1))).tolist()
        for _ in range(n)]


def _recompiles() -> float:
    from ..observability import metrics as om

    snap = om.default_registry().snapshot()
    return sum(s["value"] for s in
               snap.get("paddle_recompiles_total", {}).get("series", []))


def run_serve_probe(cand: Candidate, geom: ServeProbeGeometry,
                    n_requests: int, *, seed: int = 0,
                    device=None) -> Dict[str, Any]:
    """Short CLOSED-LOOP drive of one serve-space candidate; ``score``
    is ms per generated token (lower better), gated by the SLO engine's
    verdict (a failing lane scores inf — the measured phase's
    rejection). ``steady_state_recompiles`` reads
    ``paddle_recompiles_total``, which in the port counts the fluid
    ``Executor``'s plan rebuilds only: an eager engine never adds to it,
    so the read is 0 here, kept for the reference's schema."""
    import numpy as np
    import torch

    from .. import serving
    from ..models import gpt as G

    di = device_info(device)
    dev = di.device
    release_memory(dev)
    cfg = G.GPTConfig(
        vocab_size=geom.vocab_size, max_seq_len=max(geom.max_seq, 64),
        num_layers=geom.num_layers, num_heads=geom.num_heads,
        d_model=geom.d_model, d_ff=geom.d_ff,
        dtype=torch.bfloat16 if di.on_acc else torch.float32, remat=False)
    params = G.init_params(cfg, seed=seed, device=dev)
    prompts = probe_prompts(geom, cfg.vocab_size, n_requests, seed)

    ratio = parse_disagg_ratio(cand.get("disagg", "off"))
    ttfts, tpots, failed, total_tokens = [], [], 0, 0

    def note(req) -> None:
        nonlocal failed, total_tokens
        if req is None or req.state != "done":
            failed += 1
            return
        if req.ttft_ms is not None:
            ttfts.append(req.ttft_ms)
        if len(req.token_times) > 1:
            tpots.append(float(np.median(np.diff(req.token_times)) * 1e3))
        total_tokens += len(req.tokens)

    t_build = time.perf_counter()
    try:
        if ratio:
            from ..serving.disagg import DisaggRouter, LocalReplica

            n_p, n_d = ratio
            mult = int(cand.get("disagg_decode_batch", 1))
            base_mb = int(cand.get("max_batch", 8))
            reps = []
            try:
                for i in range(n_p):
                    e = _build_probe_engine(params, cfg, cand, geom, dev,
                                            role="prefill",
                                            max_batch=base_mb)
                    e.warmup()
                    reps.append(LocalReplica(e, name=f"p{i}"))
                for i in range(n_d):
                    e = _build_probe_engine(params, cfg, cand, geom, dev,
                                            role="decode",
                                            max_batch=base_mb * mult)
                    e.warmup()
                    reps.append(LocalReplica(e, name=f"d{i}"))
                router = DisaggRouter(reps)
                warm_s = time.perf_counter() - t_build
                rc0 = _recompiles()
                t0 = time.perf_counter()
                for p in prompts:
                    note(router.generate(
                        p, max_new_tokens=geom.max_new_tokens,
                        timeout_s=60.0))
                span = time.perf_counter() - t0
                rc = _recompiles() - rc0
            finally:
                for r in reps:
                    r.stop()
        else:
            engine = _build_probe_engine(params, cfg, cand, geom, dev)
            engine.warmup()
            warm_s = time.perf_counter() - t_build
            sched = serving.Scheduler(engine, serving.SchedulerConfig(
                max_queue=max(16, n_requests), default_timeout_s=60.0),
                device=dev)
            loop = serving.EngineLoop(sched).start()
            rc0 = _recompiles()
            t0 = time.perf_counter()
            try:
                for p in prompts:
                    req = sched.submit(p,
                                       max_new_tokens=geom.max_new_tokens)
                    loop.wake()
                    req.wait(timeout=60.0)
                    note(req)
            finally:
                loop.stop()
            span = time.perf_counter() - t0
            rc = _recompiles() - rc0
    finally:
        params = engine = sched = loop = reps = router = None
        release_memory(dev)

    slo = _slo_verdict(ttfts, tpots, failed)
    tok_s = total_tokens / max(span, 1e-9)
    ms_per_tok = span * 1e3 / max(total_tokens, 1)
    score = float("inf") if (failed or not slo["ok"] or rc) \
        else ms_per_tok
    return {
        "score": score,
        "ms_per_token": round(ms_per_tok, 3),
        "tokens_per_s": round(tok_s, 2),
        "ttft_p50_ms": round(float(np.median(ttfts)), 3) if ttfts
        else None,
        "requests": n_requests,
        "failed": failed,
        "generated_tokens": total_tokens,
        "steady_state_recompiles": int(rc),
        "warmup_s": round(warm_s, 3),
        "slo": slo,
    }
