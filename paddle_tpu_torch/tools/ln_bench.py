"""The fused-layernorm kernels (forward forms, backward) on the card, trees
compared in turns.

    python -m paddle_tpu_torch.tools.ln_bench [--tree DIR ...] [--rounds 1]

For each tree (a checkout that holds ``paddle_tpu_torch``; default: this
one) in the order A B ... B A (``--rounds`` times), a fresh process imports
that tree's package, builds its kernels, prints ptxas's registers and
spills of each fused-LN kernel, and times by CUDA-graph replay (12 calls a
graph, 20 replays), in bf16 and in float32:

- at the training rows [16384, 768], the inputs walked over three copies
  so the launches read HBM and not the 50 MB L2: the ln2 form (residual +
  bias_add, s written), the plain form, the mask form (residual + dropout
  mask), the backward with dsx and without; beside them ``F.layer_norm``
  on x with float32 scale and bias (the plain form's function),
  ``F.layer_norm`` on s (half the ln2 form's bytes: not its function),
  ``aten.native_layer_norm_backward`` (the backward without dsx) and the
  plain versions (``fused_ln_fwd_plain`` ln2, ``fused_ln_bwd_plain`` dsx);
- at the decode tick's rows [8, 768]: the plain form as
  ``cuda_kernels.fused_ln`` (no statistics) and ``F.layer_norm``.

On the card PyTorch's layernorm takes its weight and bias in x's dtype
only, so the library calls get scale and bias rounded to it: the same
work, with the affine parameters rounded.

Every time sits beside its bytes bound (``observability/hw.py``; inputs
read once, outputs written once). Each record also holds, for the ln2 and
plain forms and both backward forms, the device ms a call of each kernel
they launch (``torch.profiler``, 24 calls) and, where the tree has the
planner, the backward's launch plan. The last line holds every tree's list
of times. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

ROWS, DECODE_ROWS, D = 16 * 1024, 8, 768

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_NAME = re.compile(r"((?:fused_ln_fwd|ln_bwd)_kernel\w*?)I(.+?)EEv")


def _ptxas(logs: Dict[str, str]) -> List[str]:
    """'name[template arguments]: N registers, ... spill ...' for each
    fused-LN kernel in the build's ptxas output."""
    out, name = [], None
    for src in ("fused_ln", "ln_bwd"):
        spill = ""
        for line in logs.get(src, "").splitlines():
            m = _ENTRY.search(line)
            if m:
                n = _NAME.search(m.group(1))
                name = f"{n.group(1)}[{n.group(2)}]" if n else None
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line)
                out.append(f"{name}: {regs.group(1) if regs else '?'} "
                           f"registers, {spill}")
                name = None
    return out


def _worker() -> dict:
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.observability.hw import bound_ms
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import fused_ln as FL

    info = _build.build()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    side = torch.cuda.Stream()

    def graph_ms(fn, calls: int = 12, replays: int = 20) -> float:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (replays * calls)

    def walk(fn):
        """fn(0), fn(1), fn(2), fn(0), ...: three copies of the inputs."""
        turn = itertools.cycle(range(3))
        return lambda: fn(next(turn))

    rec = {"device": card,
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip().splitlines()[0],
           "ptxas": _ptxas(info.logs)}
    g = torch.Generator(device=dev)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        g.manual_seed(77)

        def randn(*shape, s=1.0, dt=dtype):
            return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

        esz = torch.empty((), dtype=dtype).element_size()
        rd = ROWS * D
        xs, rs, dys, dsxs = ([randn(ROWS, D) for _ in range(3)]
                             for _ in range(4))
        badd = randn(D, s=0.1)
        scale = 1.0 + randn(D, s=0.1, dt=torch.float32)
        bias = randn(D, s=0.1, dt=torch.float32)
        mask = torch.rand((ROWS, D), generator=g, device=dev) < 0.9
        inv = FL._round_to(1 / 0.9, dtype)
        outs = [FL.fused_ln_fwd(xs[i], scale, bias, rs[i], badd)
                for i in range(3)]
        ss = [o[1] for o in outs]
        mu, rstd = outs[0][2], outs[0][3]
        # the library calls' weight and bias, in x's dtype
        w, b = scale.to(dtype), bias.to(dtype)
        _o, mean, rstd_l = torch.ops.aten.native_layer_norm(
            ss[0], [D], w, b, 1e-5)
        # bytes: [R, D] operands, the [D] float32 scale/bias (and bf16
        # bias_add), the [R] float32 statistics
        stats, vec = 2 * ROWS * 4, 2 * D * 4
        times = {
            "ln2": (walk(lambda i: FL.fused_ln_fwd(xs[i], scale, bias, rs[i],
                                                   badd)),
                    4 * rd * esz + D * esz + vec + stats),
            "plain": (walk(lambda i: FL.fused_ln_fwd(xs[i], scale, bias)),
                      2 * rd * esz + vec + stats),
            "mask": (walk(lambda i: FL.fused_ln_fwd(
                xs[i], scale, bias, rs[i], mask=mask, inv_keep=inv)),
                4 * rd * esz + rd + vec + stats),
            "bwd_dsx": (walk(lambda i: FL.fused_ln_bwd(
                ss[i], mu, rstd, scale, dys[i], dsxs[i])),
                4 * rd * esz + stats + 3 * D * 4),
            "bwd": (walk(lambda i: FL.fused_ln_bwd(ss[i], mu, rstd, scale,
                                                   dys[i])),
                    3 * rd * esz + stats + 3 * D * 4),
            "layer_norm": (walk(lambda i: F.layer_norm(xs[i], (D,), w, b,
                                                       1e-5)),
                           2 * rd * esz + vec + stats),
            "layer_norm_on_s": (walk(lambda i: F.layer_norm(
                ss[i], (D,), w, b, 1e-5)), 2 * rd * esz + vec + stats),
            "native_layer_norm_backward": (walk(
                lambda i: torch.ops.aten.native_layer_norm_backward(
                    dys[i], ss[i], [D], mean, rstd_l, w, b,
                    [True, True, True])), 3 * rd * esz + stats + 3 * D * 4),
            "ln2_plain_version": (walk(lambda i: FL.fused_ln_fwd_plain(
                xs[i], scale, bias, rs[i], badd)), None),
            "bwd_dsx_plain_version": (walk(lambda i: FL.fused_ln_bwd_plain(
                ss[i], mu, rstd, scale, dys[i], dsxs[i])), None),
        }
        x8 = randn(DECODE_ROWS, D)
        times["decode_plain"] = (lambda: CK.fused_ln(x8, scale, bias),
                                 2 * DECODE_ROWS * D * esz + vec)
        times["decode_layer_norm"] = (
            lambda: F.layer_norm(x8, (D,), w, b, 1e-5),
            2 * DECODE_ROWS * D * esz + vec)
        for key, (fn, nbytes) in times.items():
            plain = key.endswith("_plain_version")
            rec[f"{tag}_{key}_ms"] = graph_ms(fn, 3 if plain else 12)
            if nbytes is not None:
                rec[f"{tag}_{key}_bound"] = bound_ms(nbytes, 0, "f32",
                                                     card)[0]
        # where a wrapper call's device time goes, kernel by kernel
        for key in ("ln2", "plain", "bwd_dsx", "bwd"):
            fn = times[key][0]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(24):
                    fn()
                torch.cuda.synchronize()
            by_name: Dict[str, float] = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    by_name[ev.name[:60]] = by_name.get(ev.name[:60], 0.0) \
                        + (ev.time_range.end - ev.time_range.start) / 24e3
            rec[f"{tag}_{key}_kernels"] = sorted(by_name.items(),
                                                 key=lambda kv: -kv[1])[:3]
        if hasattr(FL, "ln_bwd_plan"):          # the backward's launch plan
            lane_elems = FL.ln_bwd_plan(D)
            bps = FL._bwd_blocks_per_sm(D, lane_elems, True, False,
                                        0 if esz == 4 else 1)
            rec[f"{tag}_bwd_dsx_plan"] = {
                "lane_elems": lane_elems, "blocks_per_sm": bps,
                "blocks": FL.ln_bwd_grid(ROWS, lane_elems,
                                         CK._num_sms(dev), bps)}
        del times, xs, rs, dys, dsxs, outs, ss
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout holding paddle_tpu_torch (repeatable; "
                         "default: this one)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker()))
        return 0
    here = Path(__file__).resolve().parents[2]
    trees = [str(Path(t).resolve()) for t in (args.tree or [str(here)])]
    order = (trees + trees[::-1]) * args.rounds
    runs: Dict[str, List[dict]] = {t: [] for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            cwd=tree, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(rec)
        print(json.dumps({"tree": tree, **rec}))
    print(json.dumps({t: {k: [r[k] for r in rs] for k in rs[0]
                          if k.endswith("_ms")} for t, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
