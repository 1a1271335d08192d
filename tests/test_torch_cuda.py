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
        want = dict.fromkeys(CK.LAUNCHES, 0)
        if fused:
            want.update(fused_ln=2 * L * ticks, decode_slab=L * ticks,
                        logits_head=ticks)
        assert CK.LAUNCHES == want
    assert tokens[0] == tokens[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_training_kernels_match_plain_at_path_shapes(chip_smoke, dtype):
    """Flash forward / dQ / dK,dV at [16 (bf16) or 2 (f32), 1024, 12, 64]
    from a packed qkv, causal: bf16 per element within 2^-7 x (|plain| +
    its row's max |plain|) + 1e-5 and lse within 2e-5, f32 within 2e-5 / 3e-4; the AdamW sweep over GPT_SMALL's 163M parameters bitwise,
    with bf16 and float32 moments."""
    recs = chip_smoke.phase_train_kernels(dtype, time_it=False)
    assert set(recs) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "opt_adamw_flat"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,hd", [(100, 32), (256, 64), (192, 128)])
def test_flash_kernels_match_plain_small_shapes(chip_smoke, dtype, causal,
                                               T, hd):
    """Ragged sequence lengths (T not a multiple of the 64-row tile), full
    attention and every head_dim the kernels take; the bounds of
    ``chip_smoke.phase_train_kernels``."""
    from paddle_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 plain path
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(T + hd)
    q, k, v, do = (torch.randn((2, T, 3, hd), generator=g, device="cuda")
                   .to(dtype) for _ in range(4))

    def close(got, want, f32_tol):
        if dtype == torch.bfloat16:
            chip_smoke.bf16_check("flash", got, want)
        else:
            torch.testing.assert_close(got, want, atol=f32_tol, rtol=f32_tol)

    o, lse = FA.flash_fwd(q, k, v, causal)
    o_p, lse_p = FA.flash_fwd_plain(q, k, v, causal)
    close(o, o_p, 2e-5)
    torch.testing.assert_close(lse, lse_p, atol=2e-5, rtol=2e-5)
    close(FA.flash_bwd_dq(q, k, v, o_p, lse_p, do, causal),
          FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, causal), 3e-4)
    for got, want in zip(FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do, causal),
                         FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do,
                                                causal)):
        close(got, want, 3e-4)


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(card):
    """_Flash on CUDA tensors launches forward, dQ and dK/dV once each and
    gives the plain path's gradients (float32, 3e-4)."""
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 plain path
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=card)
    g.manual_seed(1)
    q, k, v, w = (torch.randn((2, 128, 2, 64), generator=g, device=card)
                  for _ in range(4))
    grads = []
    for on_card in (True, False):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        if on_card:
            CK.reset_launches()
            out = FA.flash_attention(*xs)
        else:
            out = FA.flash_fwd_plain(*xs)[0]
        (out * w).sum().backward()
        grads.append([x.grad for x in xs])
    assert (CK.LAUNCHES["flash_fwd"], CK.LAUNCHES["flash_bwd_dq"],
            CK.LAUNCHES["flash_bwd_dkv"]) == (1, 1, 1)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
def test_train_step_kernel_matches_plain(chip_smoke):
    """2-layer GPT_SMALL float32: 3 kernel steps vs 3 plain steps."""
    chip_smoke.phase_train_parity()


@pytest.mark.cuda
def test_training_wrappers_raise_on_inputs_the_kernels_do_not_take(card):
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import flash_attention as FA

    x = torch.zeros((1, 64, 2, 48), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_fwd(x, x, x)
    x = torch.zeros((1, 64, 2, 64), device=card)
    with pytest.raises(TypeError):
        FA.flash_fwd(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="strides"):
        FA.flash_fwd(x, x.transpose(1, 2).contiguous().transpose(1, 2), x)
    p = torch.zeros(16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        CK.megakernel_adamw_flat(p, p, p, torch.zeros(32, device=card)[::2],
                                 p, 1e-3, 1.0, 0.1, 0.1)
