"""MFU sweep over the GPT training lane's configs — the port of the JAX
package's ``tools/mfu_sweep.py``.

Runs one training-throughput measurement per config in a subprocess of
its own (an out-of-memory or a crash cannot poison the next config) and
prints a ranked table. The MFU is the train lanes' own: tokens/s x
``models/gpt.train_flops_per_token`` (6N + the attention term) over the
card's bf16 dense peak (``observability/hw.py``) times the ranks.

    python -m paddle_tpu_torch.tools.mfu_sweep           # the standard sweep
    python -m paddle_tpu_torch.tools.mfu_sweep --one b=16,remat=dots,L=4
    python -m paddle_tpu_torch.tools.mfu_sweep --ce-chunk 0,1024 \\
        --fused-opt 0,1
    python -m paddle_tpu_torch.tools.mfu_sweep \\
        --base d=64,L=2,nh=4,ff=128,T=32,b=4,steps=2,flash=0 \\
        --ce-chunk 0,64 --device cpu       # a CPU-sized run (mechanism)
    python -m paddle_tpu_torch.tools.mfu_sweep \\
        --base d=64,L=2,nh=4,ff=128,T=32,b=8,steps=2,flash=0,dp=2 \\
        --grad-reduce psum,reduce_scatter --comm-dtype f32,bf16

Spec keys (the reference's, where the port has the lever): b (global
batch), steps, remat (none|full|dots|save_only_flash), nh, d, L, ff, T,
flash, mom (f32|bf16 Adam moments), celim (direct-CE byte limit), chunk
(CE row chunk), vchunk (CE vocab chunk, 0 = off), fused (1 = the flat
AdamW sweep), dp (data-parallel ranks: the config then runs as ``dp``
gloo ranks under ``parallel.launch``, every rank on ``--device``, as
``train_bench``'s parallel lane does), gr (psum|reduce_scatter), cdt
(f32|bf16|int8 wire dtype), bmb (bucket cap MiB), ef (1 = the
error-feedback residual), shard (none|dp|fsdp|tp|dp+tp: the sharding
plan's step). The reference's ``bq`` / ``bk`` (the flash kernels' block
sizes: the port's kernels fix their tiles) and ``scan`` (the port's
layer loop is always a Python loop) have no lever here and raise
``NotImplementedError`` naming the key. Every config's result is one
JSON row on stdout (errors included), then the ranked table. The
default device is the card; ``--device cpu`` checks the mechanism only.
"""
import json
import os
import signal
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "paddle_tpu_torch.tools.mfu_sweep"
# keys whose lever the port lacks (module docstring)
UNPORTED = {"bq": "the flash kernels' block size (the port's kernels fix "
                  "their tiles)",
            "bk": "the flash kernels' block size (the port's kernels fix "
                  "their tiles)",
            "scan": "the scanned layer loop (the port's layer loop is "
                    "always a Python loop)"}
KNOWN = {"b", "steps", "remat", "nh", "d", "L", "ff", "T", "flash", "mom",
         "celim", "chunk", "vchunk", "fused", "dp", "gr", "cdt", "bmb",
         "ef", "shard"}


def parse_spec(spec_str: str) -> dict:
    """A spec's key=value pairs; a key the port has no lever for raises
    ``NotImplementedError`` naming it, an unknown key ``ValueError``."""
    spec = dict(kv.split("=") for kv in spec_str.split(",") if kv)
    for key in spec:
        if key in UNPORTED:
            raise NotImplementedError(
                f"mfu_sweep spec key {key!r}: {UNPORTED[key]}")
        if key not in KNOWN:
            raise ValueError(f"mfu_sweep: unknown spec key {key!r}")
    return spec


def _measure_spec(spec_str: str, device: str) -> dict:
    """One config's row on this process's rank (a world of ``dp`` ranks
    when the spec has dp > 1: ``PADDLE_*`` from ``parallel.launch``)."""
    import numpy as np
    import torch

    from ..models import gpt as G
    from ..observability import hw
    from ..parallel import parallelize as PZ
    from ..parallel import remat as remat_mod
    from ..tuning import probe as tuning_probe
    from ..tuning.static_cost import CPU_PEAK_FLOPS

    spec = parse_spec(spec_str)
    batch = int(spec.get("b", 16))
    steps = int(spec.get("steps", 10))
    d_model = int(spec.get("d", 768))
    T = int(spec.get("T", 1024))
    dp = int(spec.get("dp", 1))
    rpolicy = remat_mod.resolve(spec.get("remat", "full"))
    kw = dict(max_seq_len=T, use_flash=spec.get("flash", "1") == "1",
              d_model=d_model, num_layers=int(spec.get("L", 12)),
              d_ff=int(spec.get("ff", 4 * d_model)),
              remat=not rpolicy.is_none, remat_policy=rpolicy.name)
    if "celim" in spec:
        kw["ce_direct_bytes_limit"] = int(spec["celim"])
    if "chunk" in spec:
        kw["ce_chunk"] = int(spec["chunk"])
    if "vchunk" in spec:
        kw["ce_vocab_chunk"] = int(spec["vchunk"])
    if int(spec.get("nh", 0)):
        kw["num_heads"] = int(spec["nh"])
    if batch % dp:
        raise ValueError(f"global batch {batch} not divisible by dp={dp}")
    dev = torch.device(device)
    mesh = None
    pcfg = PZ.ParallelConfig(dp=dp, pp=1, tp=1, microbatches=1)
    if dp > 1:
        from ..parallel import env

        dev = env.init_distributed_env(device=device)
        mesh = PZ.build_mesh(pcfg, device=dev)
    if dev.type != "cuda":
        kw["dtype"] = torch.float32
    cfg = G.GPT_SMALL.scaled(**kw)
    fused = spec.get("fused", "0") == "1"
    cdt = spec.get("cdt", "f32")
    comm_kw = dict(grad_reduce=spec.get("gr", "psum"),
                   grad_allreduce_dtype=None if cdt == "f32" else cdt,
                   bucket_mb=float(spec.get("bmb", 32)),
                   error_feedback=spec.get("ef", "0") == "1")
    if spec.get("shard", "none") != "none":
        comm_kw["sharding"] = spec["shard"]
    params, opt = PZ.init_sharded(
        cfg, pcfg, mesh, seed=0, device=dev,
        moment_dtype=torch.bfloat16 if spec.get("mom") == "bf16" else None,
        fused_opt=fused, **comm_kw)
    step = PZ.make_train_step(cfg, pcfg, mesh, lr=1e-4, fused_opt=fused,
                              device=dev, **comm_kw)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, batch, T)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, batch, T)))

    def _step(i):
        return step(params, opt, tokens, labels)[2]

    # the shared first-call/timing loop, block-timed with one trailing
    # sync (the throughput discipline)
    timing = tuning_probe.timed_loop(_step, steps, sync=float,
                                     per_step_sync=False)
    tokens_per_s = steps * batch * T / timing.block_s
    # the model's count, not a rank's shards (a plan may shard them)
    n_params = sum(int(np.prod(shape)) for shape in PZ.flat_leaves(
        G.param_shapes(cfg)))
    di = tuning_probe.device_info(dev)
    peak = (hw.peaks_for(di.device_kind)["bf16_flops_per_s"]
            if di.on_acc and not di.degraded else CPU_PEAK_FLOPS)
    # dp ranks: tokens/s is global, so the denominator is dp x one card
    mfu = tokens_per_s * G.train_flops_per_token(cfg, n_params, T) \
        / (peak * dp)
    return {"spec": spec_str, "tokens_per_s": round(tokens_per_s, 1),
            "mfu": round(mfu, 4),
            "ms_per_step": round(timing.ms_per_step, 1),
            "compile_s": round(timing.compile_s, 1),
            "params": int(n_params), "device": di.device_kind,
            "degraded": di.degraded}


def worker(spec: str, device: str) -> None:
    row = _measure_spec(spec, device)
    if int(os.environ.get("PADDLE_TRAINER_ID", "0")) == 0:
        print(json.dumps(row), flush=True)


def worker_cmd(spec: str, device: str):
    """The command that measures ``spec``: one process, or ``dp`` gloo
    ranks under ``parallel.launch`` (a port below the ephemeral range)."""
    dp = int(parse_spec(spec).get("dp", 1))
    cmd = [sys.executable, "-m", MODULE, "--worker", spec,
           "--device", device]
    if dp <= 1:
        return cmd
    from .fault_bench import _reserve_port

    return [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
            "--nproc_per_node", str(dp), "--backend", "gloo",
            "--started_port", str(_reserve_port()), "--grace_period", "5",
            "-m", MODULE, "--worker", spec, "--device", device]


def run_one(spec: str, device: str = "cuda", timeout: float = 420):
    """One config in its own subprocess: its JSON row, or an error row
    (the tail of its stderr). SIGINT first on a timeout, then a kill."""
    try:
        cmd = worker_cmd(spec, device)
    except (NotImplementedError, ValueError) as e:
        return {"spec": spec, "error": f"{type(e).__name__}: {e}"}
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGINT)
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        return {"spec": spec, "error": "timeout"}
    if proc.returncode != 0:
        return {"spec": spec, "error": f"rc={proc.returncode}",
                "tail": (err or "").strip().splitlines()[-6:]}
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return {"spec": spec, "error": "no json"}


# the default sweep: GPT_SMALL at bench.py's GPT lane and its neighbours
_WINNER_BASE = "b=16,remat=dots,mom=bf16,fused=1,steps=8"


def _flag_values(argv, flag, default):
    """``--flag a,b`` -> [a, b]; bare ``--flag`` -> default; absent ->
    None."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
        return argv[i + 1].split(",")
    return default


def build_specs(argv):
    """The spec list for this invocation: ``--one SPEC``; the comm or
    sharding axes (``--grad-reduce`` / ``--comm-dtype`` / ``--bucket-mb``
    / ``--sharding``) or the memory-lever axes (``--ce-chunk`` /
    ``--fused-opt``) crossed with ``--base SPEC`` (default the lane's);
    else the default sweep."""
    if "--one" in argv:
        return [argv[argv.index("--one") + 1]]
    base = argv[argv.index("--base") + 1] if "--base" in argv \
        else _WINNER_BASE
    ce_axis = _flag_values(argv, "--ce-chunk", ["0", "1024"])
    fused_axis = _flag_values(argv, "--fused-opt", ["0", "1"])
    gr_axis = _flag_values(argv, "--grad-reduce",
                           ["psum", "reduce_scatter"])
    cdt_axis = _flag_values(argv, "--comm-dtype", ["f32", "bf16"])
    bmb_axis = _flag_values(argv, "--bucket-mb", ["32"])
    shard_axis = _flag_values(argv, "--sharding", ["none", "dp", "fsdp"])
    if gr_axis or cdt_axis or bmb_axis or shard_axis:
        specs = []
        for sh in (shard_axis or [None]):
            for gr in (gr_axis or [None]):
                for cdt in (cdt_axis or [None]):
                    for bmb in (bmb_axis or [None]):
                        s = base
                        if sh is not None and sh != "none":
                            s += f",shard={sh}"
                        if gr is not None:
                            s += f",gr={gr}"
                        if cdt is not None and cdt != "f32":
                            s += f",cdt={cdt}"
                        if bmb is not None and gr == "reduce_scatter":
                            s += f",bmb={bmb}"
                        specs.append(s)
        return specs
    if ce_axis is None and fused_axis is None:
        # the lane's config and its controlled A/Bs: flash off, f32
        # moments, full remat at twice the batch
        return [_WINNER_BASE,
                _WINNER_BASE + ",flash=0",
                "b=16,remat=dots,fused=1,steps=8",
                "b=32,remat=full,mom=bf16,fused=1,steps=8"]
    specs = []
    for vc in (ce_axis or [None]):
        for fo in (fused_axis or [None]):
            s = base
            if vc is not None and int(vc):
                s += f",vchunk={vc}"
            if fo is not None:
                s = ",".join(kv for kv in s.split(",")
                             if not kv.startswith("fused=")) + f",fused={fo}"
            specs.append(s)
    return specs


def _device(argv) -> str:
    return argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _device(argv)
    if "--worker" in argv:
        worker(argv[argv.index("--worker") + 1], device)
        return 0
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        print("mfu_sweep: no CUDA device (pass --device cpu for the "
              "mechanism)", file=sys.stderr)
        return 2
    results = []
    for s in build_specs(argv):
        print(f"[sweep] {s} ...", file=sys.stderr, flush=True)
        r = run_one(s, device)
        print(f"[sweep]   -> {r}", file=sys.stderr, flush=True)
        results.append(r)
        # one machine-readable row per config, as it lands (errors
        # included — a crashed config must not vanish from the record)
        print(json.dumps(r), flush=True)
    ok = sorted((r for r in results if "mfu" in r), key=lambda r: -r["mfu"])
    for r in ok:
        print(f"{r['mfu']:.4f}  {r['tokens_per_s']:>10.0f} tok/s  "
              f"{r['ms_per_step']:>6.1f} ms  {r['spec']}")
    for r in results:
        if "mfu" not in r:
            print(f"FAILED  {r}")
    return 0 if len(ok) == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
