"""Disaggregated-vs-colocated serving A/B — the twin of the reference's
disaggregated lane (``tools/serve_bench.py:352-530``), on one card.

    python -m paddle_tpu_torch.tools.serve_bench --disagg
        [--disagg-rate 160] [--disagg-requests 48] [--disagg-max-new 32]
        [--max-batch N] [--buckets 64,128,256,512] [--tuned TUNED.json]
        [--seed 0] [--out FILE] [--tiny --device cpu]

Only the ``--disagg`` lane is ported; the flag is required. One mixed
trace — 30% long prompts (the largest bucket - 2 tokens), the rest 2 to
(the smallest bucket - 4) tokens, Poisson arrivals at ``--disagg-rate``,
one thread an arrival — is served by two topologies of two paged engines
(page 8, the reference's; the paged decode kernel takes it):

- A: [colocated, colocated], least-loaded placement (``load_eta_s``);
- B: [prefill, decode] behind ``DisaggRouter`` (first-token KV
  migration), then a short exercise of the shared prefix index (a 16-token
  shared prefix, three requests).

The first four prompts also run one at a time through each topology, and
their greedy tokens must agree (``greedy_tokens_match``). The JSON is the
reference's: per topology TTFT and TPOT p50/p99, tokens/s, completed and
failed; for B also migrated, fallbacks, handoff_ms p50/p99,
kv_transfer_bytes and pool_prefix; then ``ttft_p99_win``,
``tpot_no_regress`` and ``disagg_pass`` as the reference computes them.
Added: topology B's transfers by kind (each handoff's export and adopt,
each prefix record's export and adoption) with their ms and CRC and
device-copy shares (``kv_transfer.summarize_stats``), the card's name and
power limit, and the topologies' placement. The reference compared the topologies at equal
chips, one engine a chip; here both engines of a topology share ONE card
and one process (``"placement": "both topologies share one card"``), so
the TTFT and TPOT bars are printed but not gated: the exit code is
non-zero only when a request fails or the greedy tokens disagree. The
port's engines run eagerly, so the reference's ``steady_state_recompiles``
has no counterpart and is left out.

``--tuned TUNED.json`` applies the autotuner's serve winner
(``tools/autotune.py``) as the reference's ``--tuned`` does: the document
is fingerprint-gated ("applied", or "REFUSED" with a warning and the
defaults), and its ``max_batch`` and prefill buckets apply where
``--max-batch`` / ``--buckets`` were not given; the lane's layout (paged,
page 8) and its two topologies are its own, so the winner's spec window
and disagg ratio are printed, not applied.

Defaults: GPT_SMALL (V 50,304, L 12, nh 12, D 768) bf16 from seed-0
weights, 8 slots, max_seq 1024, buckets 64-512 — ``chip_smoke.py``'s
serving geometry — on ``cuda``. ``--tiny --device cpu`` runs GPT_TINY (2
layers, max_seq 64, buckets 16 and 32: the reference's CPU geometry) on the
CPU, which checks the mechanism only: no time from it is a device number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

PAGE_SIZE = 8           # the reference lane's page


def _pct(vals, q) -> Optional[float]:
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def card_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where there is none."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def disagg_lane(params, cfg, ecfg_kw, rate_rps: float, n_requests: int,
                max_new_tokens: int, seed: int, device) -> dict:
    """The A/B of the reference's ``disagg_lane`` on ``device``; returns
    its JSON (see the module docstring)."""
    from paddle_tpu_torch.serving import DecodeEngine, EngineConfig
    from paddle_tpu_torch.serving import kv_transfer
    from paddle_tpu_torch.serving import metrics as smetrics
    from paddle_tpu_torch.serving.disagg import (DisaggRouter, LocalReplica,
                                                 SharedPrefixIndex)

    def make(role):
        e = DecodeEngine(params, cfg, EngineConfig(
            kv_layout="paged", page_size=PAGE_SIZE, role=role, **ecfg_kw),
            device=device)
        e.warmup()
        return e

    buckets = sorted(ecfg_kw["prefill_buckets"])
    long_len = buckets[-1] - 2
    short_max = max(4, buckets[0] - 4)
    rng = np.random.RandomState(seed)
    prompts = []
    for _ in range(n_requests):
        ln = long_len if rng.rand() < 0.3 else int(
            rng.randint(2, short_max + 1))
        prompts.append(rng.randint(0, cfg.vocab_size, size=ln).tolist())
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)

    def drive(generate_fn):
        """Open-loop replay: one thread an arrival (generate blocks)."""
        results = [None] * n_requests
        threads = []
        t0 = time.monotonic()
        for i, (gap, prompt) in enumerate(zip(gaps, prompts)):
            time.sleep(gap)
            th = threading.Thread(
                target=lambda i=i, p=prompt: results.__setitem__(
                    i, generate_fn(p)), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=180.0)
        return results, time.monotonic() - t0

    def summarize(res, span):
        done = [r for r in res if r is not None and r.state == "done"]
        ttfts = [r.ttft_ms for r in done if r.ttft_ms is not None]
        tpots = []
        for r in done:
            tpots.extend((np.diff(r.token_times) * 1e3).tolist())
        total = sum(len(r.tokens) for r in done)
        return {"requests": n_requests, "completed": len(done),
                "failed": n_requests - len(done),
                "ttft_ms": {"p50": _pct(ttfts, 50), "p99": _pct(ttfts, 99)},
                "tpot_ms": {"p50": _pct(tpots, 50), "p99": _pct(tpots, 99)},
                "tokens_per_s": total / span}

    timeout_s = 120.0
    parity_idx = list(range(min(4, n_requests)))

    # -- topology A: two colocated engines, least-loaded placement -------
    colo = [LocalReplica(make("colocated"), name=f"colo{i}")
            for i in range(2)]

    def colo_generate(prompt):
        rep = min(colo, key=lambda r: r.load_eta_s())
        req = rep.scheduler.submit(prompt, max_new_tokens=max_new_tokens,
                                   timeout_s=timeout_s)
        rep.wake()
        req.wait(timeout=timeout_s + 1.0)
        return req

    try:
        parity_colo = [list(colo_generate(prompts[i]).tokens)
                       for i in parity_idx]
        colo_sum = summarize(*drive(colo_generate))
    finally:
        for rep in colo:
            rep.stop()
    del colo

    # -- topology B: prefill -> decode with KV migration -----------------
    # (the prefix index sits out of the timed load: the random trace has
    # no shared prefixes; it is exercised below)
    reps = [LocalReplica(make("prefill"), name="prefill0"),
            LocalReplica(make("decode"), name="decode0")]
    kv_transfer.transfer_history(clear=True)
    router = DisaggRouter(reps)
    bytes0 = smetrics.m_kv_transfer_bytes.labels("out").value

    def disagg_generate(prompt):
        return router.generate(prompt, max_new_tokens=max_new_tokens,
                               timeout_s=timeout_s)

    index = SharedPrefixIndex()
    try:
        parity_disagg = [list(disagg_generate(prompts[i]).tokens)
                         for i in parity_idx]
        dis_res, dis_span = drive(disagg_generate)
        dis_sum = summarize(dis_res, dis_span)
        handoffs = [r.handoff_ms for r in dis_res
                    if r is not None and r.migrated
                    and r.handoff_ms is not None]
        kv_bytes = smetrics.m_kv_transfer_bytes.labels("out").value - bytes0
        # -- pool-level prefix cache exercise (gang-shared index) --------
        router.prefix_index = index
        for rep in reps:
            rep.engine.prefix_store = index.binding(rep.role)
        shared = rng.randint(0, cfg.vocab_size, size=16).tolist()
        for i in range(3):
            tail = rng.randint(0, cfg.vocab_size, size=4 + i).tolist()
            router.generate(shared + tail, max_new_tokens=4,
                            timeout_s=timeout_s)
    finally:
        for rep in reps:
            rep.stop()

    dis_sum["migrated"] = router.migrated
    dis_sum["fallbacks"] = router.fallbacks
    dis_sum["handoff_ms"] = {"p50": _pct(handoffs, 50),
                             "p99": _pct(handoffs, 99)}
    dis_sum["kv_transfer_bytes"] = int(kv_bytes)
    dis_sum["pool_prefix"] = {"hits": index.hits, "misses": index.misses,
                              "published": index.published}
    dis_sum["handoff_stats"] = kv_transfer.summarize_stats(
        kv_transfer.transfer_history())
    tokens_match = parity_disagg == parity_colo
    ttft_win = (dis_sum["ttft_ms"]["p99"] is not None
                and colo_sum["ttft_ms"]["p99"] is not None
                and dis_sum["ttft_ms"]["p99"] < colo_sum["ttft_ms"]["p99"])
    tpot_ok = (dis_sum["tpot_ms"]["p50"] is not None
               and dis_sum["tpot_ms"]["p50"]
               <= colo_sum["tpot_ms"]["p50"] * 1.15)
    return {
        "rate_rps": rate_rps, "max_new_tokens": max_new_tokens,
        "n_engines_per_topology": 2, "page_size": PAGE_SIZE,
        "placement": "both topologies share one card",
        "long_prompt_len": long_len, "long_frac": 0.3,
        "colocated": colo_sum, "disagg": dis_sum,
        "greedy_tokens_match": bool(tokens_match),
        "ttft_p99_win": bool(ttft_win),
        "tpot_no_regress": bool(tpot_ok),
        "disagg_pass": bool(tokens_match and ttft_win and tpot_ok
                            and dis_sum["failed"] == 0
                            and colo_sum["failed"] == 0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--disagg", action="store_true",
                    help="run the disaggregated-vs-colocated A/B lane "
                         "(the only lane ported; required)")
    ap.add_argument("--disagg-rate", type=float, default=160.0)
    ap.add_argument("--disagg-requests", type=int, default=48)
    ap.add_argument("--disagg-max-new", type=int, default=32)
    ap.add_argument("--tiny", action="store_true",
                    help="GPT_TINY at 2 layers, max_seq 64, buckets 16, 32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="engine slots (default 8; --tiny 4)")
    ap.add_argument("--buckets", default=None,
                    help="prefill buckets, comma-separated (default "
                         "64,128,256,512; --tiny 16,32)")
    ap.add_argument("--tuned", default=None,
                    help="TUNED.json from tools/autotune.py: apply the "
                         "serve winner where --max-batch / --buckets were "
                         "not given (fingerprint-gated)")
    args = ap.parse_args(argv)
    if not args.disagg:
        ap.error("only the --disagg lane is ported")

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models.gpt import GPT_SMALL, GPT_TINY, init_params

    device = resolve_device(args.device)
    tuned_doc = None
    if args.tuned:
        from paddle_tpu_torch.tuning import probe as tuning_probe
        from paddle_tpu_torch.tuning import tuned as tuned_mod

        tuned_doc = tuned_mod.load_for_device(
            args.tuned, tuning_probe.device_info(device))
        print(f"[serve_bench] tuned config "
              f"{'applied' if tuned_doc else 'REFUSED'} from "
              f"{args.tuned}", flush=True)
    if tuned_doc is not None:
        # geometry knobs apply only where the flag was not given — an
        # explicit flag always beats the tuner
        ek = tuned_mod.engine_kwargs(tuned_doc)
        if args.max_batch is None and ek.get("max_batch"):
            args.max_batch = ek["max_batch"]
        if args.buckets is None and ek.get("prefill_buckets"):
            args.buckets = ",".join(str(b) for b in ek["prefill_buckets"])
        print(f"[serve_bench] tuned lane shape (not applied here): "
              f"{tuned_mod.serve_lane_kwargs(tuned_doc)}", flush=True)
    if args.tiny:
        cfg = GPT_TINY.scaled(num_layers=2, max_seq_len=64)
        ecfg_kw = dict(max_batch=4, max_seq=64, prefill_buckets=(16, 32),
                       weight_dtype="f32")
    else:
        cfg = GPT_SMALL
        ecfg_kw = dict(max_batch=8, max_seq=1024,
                       prefill_buckets=(64, 128, 256, 512),
                       weight_dtype="bf16")
    if args.max_batch is not None:
        ecfg_kw["max_batch"] = args.max_batch
    if args.buckets is not None:
        ecfg_kw["prefill_buckets"] = tuple(
            int(b) for b in args.buckets.split(","))
    params = init_params(cfg, seed=args.seed, device=device)
    smi = card_line() if device.type == "cuda" else None
    print(f"[serve_bench] disagg A/B lane (rate={args.disagg_rate}/s, "
          f"{args.disagg_requests} requests) on {device}"
          + (f" ({smi})" if smi else ""), flush=True)
    res = disagg_lane(params, cfg, ecfg_kw, args.disagg_rate,
                      args.disagg_requests, args.disagg_max_new,
                      args.seed + 4, device)
    result = {
        "device": {"type": device.type,
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "nvidia_smi": smi},
        "model": {"vocab": cfg.vocab_size, "num_layers": cfg.num_layers,
                  "num_heads": cfg.num_heads, "d_model": cfg.d_model,
                  "weight_dtype": ecfg_kw["weight_dtype"]},
        "engine": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in ecfg_kw.items() if k != "weight_dtype"},
        "disagg": res, "disagg_pass": res["disagg_pass"],
    }
    if tuned_doc is not None:
        result["tuned"] = tuned_mod.config_stamp(tuned_doc, args.tuned)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    ok = (res["greedy_tokens_match"] and res["colocated"]["failed"] == 0
          and res["disagg"]["failed"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
