"""The flash backward kernels (dQ, dK/dV and the pair) on the card, trees
compared in turns.

    python -m paddle_tpu_torch.tools.flash_bwd_bench [--tree DIR ...]
        [--define NAME=VALUE ...] [--rounds 1]

For each tree (a checkout that holds ``paddle_tpu_torch``; default: this
one) in the order A B ... B A (``--rounds`` times), a fresh process imports
that tree's package, builds its kernels, prints ptxas's registers and
spills of each flash backward kernel, and times by CUDA-graph replay (10
calls a graph, 20 replays):

- at GPT's training call, q/k/v [16, 1024, 12, 64] bf16 sliced from one
  packed qkv, causal: ``flash_bwd_dq``, ``flash_bwd_dkv`` and the pair as
  ``_Flash.backward`` launches it (dQ, then dK/dV with dQ's D where the
  tree's wrappers take it);
- at ERNIE-base's call, [48, 512, 12, 64] bf16, full, a [48, 1, 512]
  padding bias (lengths 128-512 from a seeded draw): the same with the
  bias, and without it;

beside one SDPA backward (dq, dk, dv together; with the same float mask
at ERNIE's shape), eager, 20 calls after 3. ``--define NAME=VALUE`` adds
a tree: a copy of this one under ``_archive/`` with ``#define NAME``
rewritten to VALUE in ``ops/csrc`` (several, comma separated): the
tuning constants ``PTT_DQ_*`` and ``PTT_DKV_*`` of the two kernels.
The last line holds every tree's list of records. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

GPT = (16, 1024, 12, 64)
ERNIE = (48, 512, 12, 64)

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_NAME = re.compile(r"(flash_bwd_\w*?kernel\w*?)I(.+?)EEv")


def _ptxas(logs: Dict[str, str]) -> List[str]:
    """'name[template arguments]: N registers, ... spill stores, ...
    spill loads' for each flash backward kernel in the build's ptxas
    output."""
    out, name = [], None
    for src, log in logs.items():
        if not src.startswith("flash_") or src == "flash_fwd":
            continue
        spill = ""
        for line in log.splitlines():
            m = _ENTRY.search(line)
            if m:
                n = _NAME.search(m.group(1))   # name, template arguments
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
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as FA

    info = _build.build()
    dev = torch.device("cuda")
    side = torch.cuda.Stream()

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

    def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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

    takes_di = "return_di" in inspect.signature(FA.flash_bwd_dq).parameters

    def pair(q, k, v, o, lse, do, causal, bias):
        if takes_di:
            _dq, di = FA.flash_bwd_dq(q, k, v, o, lse, do, causal,
                                      bias=bias, return_di=True)
            return FA.flash_bwd_dkv(q, k, v, o, lse, do, causal, bias=bias,
                                    di=di)
        FA.flash_bwd_dq(q, k, v, o, lse, do, causal, bias=bias)
        return FA.flash_bwd_dkv(q, k, v, o, lse, do, causal, bias=bias)

    def sdpa_bwd_ms(q, k, v, do, causal, mask):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        ol = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                            is_causal=causal)
        dot = do.transpose(1, 2)
        return eager_ms(lambda: torch.autograd.grad(
            ol, (qt, kt, vt), dot, retain_graph=True))

    rec = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip().splitlines()[0],
           "takes_di": takes_di, "ptxas": _ptxas(info.logs)}
    g = torch.Generator(device=dev)
    for tag, (B, T, nh, hd), causal in (("gpt", GPT, True),
                                        ("ernie", ERNIE, False)):
        g.manual_seed(4321 if tag == "gpt" else 809)
        qkv = torch.randn((B, T, 3, nh, hd), generator=g, device=dev).to(
            torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn((B, T, nh, hd), generator=g, device=dev).to(
            torch.bfloat16)
        biases = {"": None}
        mask = None
        if tag == "ernie":
            lens = np.random.default_rng(0).integers(128, T + 1, size=B)
            keep = torch.from_numpy(np.arange(T)[None, :] < lens[:, None])
            mask = torch.where(keep.to(dev), 0.0, -0.5 * torch.finfo(
                torch.float32).max).float()[:, None, None, :]
            biases = {"_bias": mask.reshape(B, 1, T), "": None}
        for sfx, bias in biases.items():
            o, lse = FA.flash_fwd(q, k, v, causal, bias=bias)
            rec[f"{tag}_dq{sfx}_ms"] = graph_ms(lambda: FA.flash_bwd_dq(
                q, k, v, o, lse, do, causal, bias=bias))
            # dK/dV alone: with dQ's D where the tree takes it (without
            # it, such a wrapper launches dQ first)
            kw = {}
            if takes_di:
                kw["di"] = FA.flash_bwd_dq(q, k, v, o, lse, do, causal,
                                           bias=bias, return_di=True)[1]
            rec[f"{tag}_dkv{sfx}_ms"] = graph_ms(lambda: FA.flash_bwd_dkv(
                q, k, v, o, lse, do, causal, bias=bias, **kw))
            rec[f"{tag}_pair{sfx}_ms"] = graph_ms(
                lambda: pair(q, k, v, o, lse, do, causal, bias))
        rec[f"{tag}_sdpa_bwd_ms"] = sdpa_bwd_ms(
            q, k, v, do, causal,
            None if mask is None else mask.to(torch.bfloat16))
        del qkv, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rec


def _variant(here: Path, defines: str) -> str:
    """A copy of this tree's package under ``_archive/`` with the
    ``#define``s of ``ops/csrc`` named in ``defines`` ("NAME=VALUE", comma
    separated) rewritten; returns the copy's root."""
    pairs = [d.split("=", 1) for d in defines.split(",")]
    root = here / "_archive" / ("define-" + "-".join(
        f"{n}-{v}" for n, v in pairs))
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(here / "paddle_tpu_torch", root / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, value in pairs:
        hits = 0
        for src in (root / "paddle_tpu_torch" / "ops" / "csrc").glob(
                "*.cu*"):
            text = src.read_text()
            new, n = re.subn(rf"#define {name} \S+",
                             f"#define {name} {value}", text)
            if n:
                src.write_text(new)
                hits += n
        if not hits:
            raise SystemExit(f"no '#define {name}' in ops/csrc")
    return str(root)


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
