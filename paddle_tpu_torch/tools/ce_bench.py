"""The vocab-chunked CE forward kernel and the flat AdamW sweep on the card,
trees compared in turns.

    python -m paddle_tpu_torch.tools.ce_bench [--tree DIR ...]
        [--define NAME=VALUE ...] [--rounds 1]

For each tree (a checkout that holds ``paddle_tpu_torch``; default: this
one) in the order A B ... B A (``--rounds`` times), a fresh process imports
that tree's package, builds its kernels, prints ptxas's registers, stack
and spills of each CE-forward and AdamW-sweep kernel, and times by
CUDA-graph replay (device time only):

- ``ce_fwd`` at phase 7b's call — x [2048, 768] against GPT_SMALL's head
  [768, 50304] padded to 51,200 columns ("dv", no bias) — and at
  ERNIE-base's — its MLM rows [960, 768] (48 x 20 masked positions)
  against the tied table [30522, 768] padded to 30,720 rows ("vd") with
  the float32 decoder bias; each beside its bound (the ``2 n D vocab``
  operations at the bf16 peak, or its bytes: ``observability/hw.py``) and
  ``torch.matmul`` of its logits, the floor of its work (no single
  PyTorch call computes linear + CE); and the GPT call at D 384
  and 1,536 (the same rows and vocab: the time that grows with D is the
  products' loop, the rest the per-tile logsumexp and the edges);
- the ``adamw_mask`` sweep (``megakernel_adamw_flat``) over GPT_SMALL's
  163,109,376 parameters with bf16 moments, beside its bytes bound (24 B
  an element).

Inputs come from fixed seeds, so every tree times the same work.
``--define NAME=VALUE`` adds a tree: a copy of this one under
``_archive/`` with ``#define NAME`` in ``ops/csrc`` rewritten (the CE
kernel's ring: ``PTT_CE_WG_STAGES``). The last line holds
every tree's list of times. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

N_PARAMS = 163_109_376
# (rows, D, vocab, layout, bias, vocab chunk)
CALLS = {"gpt": (2048, 768, 50304, "dv", False, 1024),
         "ernie": (960, 768, 30522, "vd", True, 1024)}

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_NAME = re.compile(r"((?:ce_fwd|adamw_flat)_kernel\w*?)I(.+?)EEv")


def _ptxas(logs: Dict[str, str]) -> List[str]:
    """'name[template arguments]: N registers, ... stack ... spill ...'
    for each CE-forward and AdamW-sweep kernel in the build's output."""
    out, name = [], None
    for src in ("ce_fwd", "opt_megakernel"):
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
    import numpy as np
    import torch

    from paddle_tpu_torch.observability.hw import bound_ms
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import chunked_ce as CE
    from paddle_tpu_torch.ops import cuda_kernels as CK

    info = _build.build()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    side = torch.cuda.Stream()

    def ce_inputs(n, D, V, layout, with_bias, vc):
        g = torch.Generator(device=dev)
        g.manual_seed(91)
        vp = -(-V // vc) * vc
        x = torch.randn((n, D), generator=g, device=dev).bfloat16()
        shape = (D, vp) if layout == "dv" else (vp, D)
        head = (torch.randn(shape, generator=g, device=dev) * 0.3).bfloat16()
        bias = (torch.randn(vp, generator=g, device=dev) * 0.5
                if with_bias else None)
        labels = torch.from_numpy(np.random.default_rng(91).integers(
            0, V, n).astype(np.int32)).to(dev)
        return (x, head, bias, labels, vc, V, layout)

    def graph_ms(fn, calls: int = 10, replays: int = 20) -> float:
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

    rec = {"device": card,
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip().splitlines()[0],
           "ptxas": _ptxas(info.logs)}
    for call, (n, D, V, layout, with_bias, vc) in CALLS.items():
        args = ce_inputs(n, D, V, layout, with_bias, vc)
        x, head = args[:2]
        rec[f"ce_{call}_ms"] = graph_ms(lambda: CE.ce_fwd(*args))
        hm = head if layout == "dv" else head.t()
        rec[f"ce_{call}_matmul_ms"] = graph_ms(lambda: torch.matmul(x, hm))
        rec[f"ce_{call}_bound"] = bound_ms(
            n * D * 2 + D * V * 2 + (4 * V if with_bias else 0) + 3 * n * 4,
            2 * n * D * V, "bf16", card)
        del x, head, args
    n, _D, V, layout, with_bias, vc = CALLS["gpt"]
    for D in (384, 1536):
        args = ce_inputs(n, D, V, layout, with_bias, vc)
        rec[f"ce_gpt_D{D}_ms"] = graph_ms(lambda: CE.ce_fwd(*args))
        del args
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    n = N_PARAMS
    p = torch.randn(n, generator=g, device=dev)
    grad = torch.randn(n, generator=g, device=dev) * 1e-2
    m = (torch.randn(n, generator=g, device=dev) * 1e-3).bfloat16()
    v = (torch.rand(n, generator=g, device=dev) * 1e-5).bfloat16()
    mask = (torch.rand(n, generator=g, device=dev) < 0.9).float()
    sc = [torch.tensor(s, dtype=torch.float32, device=dev)
          for s in (1e-4, 0.7, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]
    rec["adamw_mask_ms"] = graph_ms(lambda: CK.megakernel_adamw_flat(
        p, grad, m, v, mask, *sc, b1=0.9, b2=0.95, eps=1e-8,
        weight_decay=0.1), calls=4, replays=5)
    rec["adamw_mask_bound"] = bound_ms(n * (4 * 4 + 4 * 2), 18 * n, "f32",
                                       card)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout holding paddle_tpu_torch (repeatable; "
                         "default: this one)")
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: also time this tree "
                         "with those defines rewritten (repeatable)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker()))
        return 0
    here = Path(__file__).resolve().parents[2]
    trees = [str(Path(t).resolve()) for t in (args.tree or [str(here)])]
    if args.define:
        from paddle_tpu_torch.tools.flash_bwd_bench import _variant

        trees += [_variant(here, d) for d in args.define]
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
