"""How far the bf16 flash kernels' outputs lie from float32 arithmetic.

    python -m paddle_tpu_torch.tools.flash_precision

At the training path's shape (q/k/v [16, 1024, 12, 64] sliced from one
packed qkv, causal, seeded N(0, 1) inputs and output cotangent) the bf16
kernels and their plain bf16 versions run on the same inputs. Each output
is held against the plain version run on those inputs upcast to float32:
the same arithmetic with no bf16 rounding of P or dS and a float32 result.
The backward takes the plain bf16 forward's (o, lse), upcast for the
reference. For o, lse, dq, dk and dv it prints, for the kernel and for
the plain bf16 version, the max abs error, the relative rms error
(rms |x - ref| / rms |ref|), and the largest error over its row's max
|ref| (at least 1e-5: dq's first causal row is zero). The plain version
keeps dS in float32 for dk as the reference does, so its dk error is dk's
output rounding alone. Also times
``flash_bwd_dkv`` with CUDA events. One JSON line; needs a CUDA device.
"""
import json
import sys

import torch

from ..ops import flash_attention as FA

B, T, NH, HD = 16, 1024, 12, 64


def _errors(x: torch.Tensor, ref: torch.Tensor) -> dict:
    err = (x.float() - ref).abs()
    row = ref.abs().amax(-1, keepdim=True).clamp_min(1e-5)
    return {"max_abs": err.max().item(),
            "rel_rms": (err.pow(2).mean().sqrt()
                        / ref.pow(2).mean().sqrt()).item(),
            "max_over_row_max": (err / row).max().item()}


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_precision: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False     # a full-f32 reference
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    qkv = torch.randn((B, T, 3, NH, HD), generator=g,
                      device="cuda").bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, T, NH, HD), generator=g, device="cuda").bfloat16()
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o_p, lse_p = FA.flash_fwd_plain(q, k, v)
    arms = {"kernel": (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv),
            "plain": (FA.flash_fwd_plain, FA.flash_bwd_dq_plain,
                      FA.flash_bwd_dkv_plain)}
    refs = dict(zip(("o", "lse"), FA.flash_fwd_plain(q32, k32, v32)))
    refs["dq"] = FA.flash_bwd_dq_plain(q32, k32, v32, o_p.float(), lse_p,
                                       do32)
    refs["dk"], refs["dv"] = FA.flash_bwd_dkv_plain(
        q32, k32, v32, o_p.float(), lse_p, do32)
    rec = {"device": torch.cuda.get_device_name(0),
           "shape": [B, T, NH, HD], "causal": True}
    for arm, (fwd, bwd_dq, bwd_dkv) in arms.items():
        outs = dict(zip(("o", "lse"), fwd(q, k, v)))
        outs["dq"] = bwd_dq(q, k, v, o_p, lse_p, do)
        outs["dk"], outs["dv"] = bwd_dkv(q, k, v, o_p, lse_p, do)
        torch.cuda.synchronize()
        rec[arm] = {name: _errors(outs[name], refs[name]) for name in refs}
    rec["flash_bwd_dkv_ms"] = _time_ms(
        lambda: FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
