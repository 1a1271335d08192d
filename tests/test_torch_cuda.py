"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without an NVIDIA GPU
(the CPU tests hold the plain versions against JAX). On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the plain versions are covered "
                    "by the CPU tests")
    return torch.device("cuda")


@pytest.fixture
def chip_smoke(card):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernels_match_plain_at_path_shapes(chip_smoke, dtype):
    """GPT_SMALL, batch 8, max_seq 1024: outputs within 1e-2 (bf16) or
    1e-5 (f32), updated caches bitwise, masked lane untouched."""
    recs = chip_smoke.phase_kernels(dtype, time_it=False)
    assert set(recs) == {"fused_ln", "decode_slab", "logits_head"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernels_match_plain_small_shapes(card, dtype):
    from paddle_tpu_torch.ops import cuda_kernels as CK

    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    g = torch.Generator(device=card)
    g.manual_seed(0)

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=card).to(dt)

    x = randn(3, 64)
    scale, bias = randn(64, dt=torch.float32), randn(64, dt=torch.float32)
    torch.testing.assert_close(CK.fused_ln(x, scale, bias).float(),
                               CK.fused_ln_plain(x, scale, bias).float(),
                               atol=tol, rtol=tol)
    w = randn(64, 300)                      # ragged last vocab tile
    torch.testing.assert_close(
        CK.fused_logits_head(x, scale, bias, w).float(),
        CK.fused_logits_head_plain(x, scale, bias, w).float(),
        atol=tol, rtol=tol)
    B, S, nh, hd = 3, 32, 4, 16
    q, nk, nv = randn(B, nh, hd), randn(B, nh, hd), randn(B, nh, hd)
    kc, vc = randn(B, S, nh, hd), randn(B, S, nh, hd)
    pos = torch.tensor([0, 31, 9], dtype=torch.int32, device=card)
    act = torch.tensor([1, 1, 0], dtype=torch.int32, device=card)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got, _, _ = CK.fused_decode_attention(q, k1, v1, nk, nv, pos, act)
    want, _, _ = CK.fused_decode_attention_plain(q, k2, v2, nk, nv, pos,
                                                 act)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert torch.equal(k1[2], kc[2]) and torch.equal(v1[2], vc[2])
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
def test_wrappers_raise_on_inputs_the_kernels_do_not_take(card):
    from paddle_tpu_torch.ops import cuda_kernels as CK

    x = torch.zeros((4, 64), device=card)
    one = torch.ones(64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        CK.fused_ln(x.t(), torch.ones(4, device=card),
                    torch.ones(4, device=card))
    with pytest.raises(TypeError):
        CK.fused_ln(x.half(), one, one)
    kc = torch.zeros((2, 8, 2, 16), device=card)
    q = torch.zeros((2, 2, 16), device=card)
    with pytest.raises(TypeError, match="int32"):
        CK.fused_decode_attention(q, kc, kc.clone(), q, q,
                                  torch.zeros(2, dtype=torch.long,
                                              device=card))
    with pytest.raises(ValueError, match="batch"):
        CK.fused_logits_head(torch.zeros((65, 64), device=card), one, one,
                             torch.zeros((64, 10), device=card))


@pytest.mark.cuda
def test_engine_kernel_path_matches_plain_path(card):
    """Tiny GPT in float32 on the card: the kernel engine's greedy tokens
    equal the plain engine's, and each tick launches 2L + L + 1 kernels."""
    from paddle_tpu_torch import serving as TS
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.ops import cuda_kernels as CK

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    params = TG.init_params(cfg, seed=7, device=card)
    ekw = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16))
    prompts = [[5, 9, 2], [7, 7, 7, 1, 3, 3], list(range(1, 12))]
    tokens = []
    for fused in (True, False):
        eng = TS.DecodeEngine(params, cfg,
                              TS.EngineConfig(fused_decode=fused, **ekw),
                              device=card)
        CK.reset_launches()
        ticks0 = eng.decode_ticks
        run = []
        for p in prompts:
            slot, logits = eng.start_sequence(p)
            tok = int(np.argmax(logits))
            seq = [tok]
            for _ in range(11):
                tok = int(np.argmax(eng.decode_step({slot: tok})[slot]))
                seq.append(tok)
            eng.free_sequence(slot)
            run.append(seq)
        tokens.append(run)
        ticks = eng.decode_ticks - ticks0
        L = cfg.num_layers
        want = ({"fused_ln": 2 * L * ticks, "decode_slab": L * ticks,
                 "logits_head": ticks} if fused else
                {"fused_ln": 0, "decode_slab": 0, "logits_head": 0})
        assert CK.LAUNCHES == want
    assert tokens[0] == tokens[1]
