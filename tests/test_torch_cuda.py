"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without an NVIDIA GPU
(the CPU tests hold the plain versions against JAX). On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q
"""
import json
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
    """GPT_SMALL, batch 8, max_seq 1024 (paged: pools [513, 16, 12, 64]):
    bf16 outputs per element within 2^-7 x (|plain| + its row's max
    |plain|) + 1e-5, f32 within 1e-5, updated caches bitwise (paged: pages
    1..512), masked lane, dead lane and shared pages untouched."""
    recs = chip_smoke.phase_kernels(dtype, time_it=False)
    assert set(recs) == {"fused_ln", "decode_slab", "decode_paged",
                         "logits_head"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernels_match_plain_small_shapes(chip_smoke, dtype):
    """bf16 per element as ``chip_smoke.bf16_check``, f32 within 1e-5."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    card = torch.device("cuda")
    g = torch.Generator(device=card)
    g.manual_seed(0)

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=card).to(dt)

    def close(name, got, want):
        chip_smoke._check_out(name, got, want, dtype)

    x = randn(3, 64)
    scale, bias = randn(64, dt=torch.float32), randn(64, dt=torch.float32)
    close("fused_ln", CK.fused_ln(x, scale, bias),
          CK.fused_ln_plain(x, scale, bias))
    w = randn(64, 300)                      # ragged last vocab tile
    close("logits_head", CK.fused_logits_head(x, scale, bias, w),
          CK.fused_logits_head_plain(x, scale, bias, w))
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
    close("decode_slab", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_decode_paged_matches_plain_small_shapes(chip_smoke, dtype):
    """Pools [P, 8, 4, 16] with scattered tables: lanes 0 and 1 share
    their first two pages, lanes 2 and 4 are dead (zeroed table rows,
    position 0 — both write scratch page 0, so only live lanes' outputs
    and pages 1..P-1 are compared), and positions reach the last row."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    card = torch.device("cuda")
    g = torch.Generator(device=card)
    g.manual_seed(3)
    B, M, page, nh, hd = 5, 4, 8, 4, 16
    P = B * M + 1

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    q, nk, nv = randn(B, nh, hd), randn(B, nh, hd), randn(B, nh, hd)
    kp, vp = randn(P, page, nh, hd), randn(P, page, nh, hd)
    perm = np.random.default_rng(3).permutation(np.arange(1, P)).reshape(
        B, M).astype(np.int32)
    tab = perm.copy()
    tab[1, :2] = tab[0, :2]
    tab[2] = 0
    tab[4] = 0
    pos = torch.tensor([31, 17, 0, 8, 0], dtype=torch.int32, device=card)
    tables = torch.from_numpy(tab).to(card)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    CK.reset_launches()
    got, _, _ = CK.fused_paged_decode_attention(q, k1, v1, nk, nv, tables,
                                                pos)
    want, _, _ = CK.fused_paged_decode_attention_plain(q, k2, v2, nk, nv,
                                                       tables, pos)
    torch.cuda.synchronize()
    assert CK.LAUNCHES["decode_paged"] == 1
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    keep = torch.from_numpy(np.concatenate([tab[0, :2], perm[2], perm[4]])
                            ).to(card).long()
    assert torch.equal(k1[keep], kp[keep]) and torch.equal(v1[keep],
                                                           vp[keep])
    live = [0, 1, 3]
    chip_smoke._check_out("decode_paged", got[live], want[live], dtype)
    # a lane whose position or table entry is out of range answers zeros
    # and writes nothing
    bad_pos = torch.tensor([M * page, -1, 0, 8, 0], dtype=torch.int32,
                           device=card)
    bad_tab = tables.clone()
    bad_tab[3, 1] = P
    k3 = kp.clone()
    out, _, _ = CK.fused_paged_decode_attention(q, k3, vp.clone(), nk, nv,
                                                bad_tab, bad_pos)
    torch.cuda.synchronize()
    assert torch.equal(out[[0, 1, 3]], torch.zeros_like(out[[0, 1, 3]]))
    assert torch.equal(k3[1:], kp[1:])


def _decode_inputs(card, dtype, B, nh, hd, cache_shape, seed):
    """q/new_k/new_v sliced from one qkv (as the engine slices them) and
    a K and a V cache of ``cache_shape``, seeded normals in ``dtype``."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    qkv = randn(B, 3, nh, hd)
    return qkv[:, 0], qkv[:, 1], qkv[:, 2], randn(*cache_shape), randn(
        *cache_shape)


def _split_positions(chunk, rows):
    """Positions on the split pass's edges: the first row, the last row of
    the first chunk, the first and second of the next, the last row."""
    return [0, chunk - 1, chunk, chunk + 1, rows - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", [1024, 1000], ids=["S1024", "S1000"])
def test_decode_slab_split_edges(chip_smoke, dtype, hd, S):
    """Lanes at positions 0, C-1, C, C+1 and S-1 for the split pass's
    chunk C (S 1000: the last chunk is short), one inactive: the output
    against the plain version, the caches bitwise, one counted launch;
    then every lane inactive: the caches untouched bit for bit."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    card = torch.device("cuda")
    nh = 3
    chunk, _ = CK._decode_split(S, hd, torch.empty((), dtype=dtype)
                                .element_size())
    pos_l = _split_positions(chunk, S) + [S // 2]
    B = len(pos_l)
    q, nk, nv, kc, vc = _decode_inputs(card, dtype, B, nh, hd,
                                       (B, S, nh, hd), hd + S)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=card)
    for act_l in ([1, 1, 1, 0, 1, 1], [0] * B):
        act = torch.tensor(act_l, dtype=torch.int32, device=card)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        CK.reset_launches()
        got, _, _ = CK.fused_decode_attention(q, k1, v1, nk, nv, pos, act)
        want, _, _ = CK.fused_decode_attention_plain(q, k2, v2, nk, nv, pos,
                                                     act)
        torch.cuda.synchronize()
        assert CK.LAUNCHES["decode_slab"] == 1
        assert torch.equal(k1, k2) and torch.equal(v1, v2)
        if not any(act_l):
            assert torch.equal(k1, kc) and torch.equal(v1, vc)
        chip_smoke._check_out("decode_slab", got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("page", [8, 16, 32])
def test_decode_paged_split_edges(chip_smoke, dtype, hd, page):
    """Pools [P, page, 3, hd] with M = 512 / page pages a lane: lanes at
    positions 0, C-1, C, C+1 and M * page - 1 for the chunk C, a dead
    lane, two lanes sharing their first page: the output against the
    plain version, pages 1..P-1 bitwise, one counted launch. Then a lane
    whose bad table entry lies in a chunk other than the one holding pos
    answers zeros and writes nothing, and the other lanes are unchanged."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    card = torch.device("cuda")
    nh, M = 3, 512 // page
    rows = M * page
    esz = torch.empty((), dtype=dtype).element_size()
    chunk, nsplit = CK._decode_split(rows, hd, esz, page)
    assert chunk % page == 0 and nsplit > 2
    pos_l = _split_positions(chunk, rows) + [0, rows // 2]
    B = len(pos_l)
    P = B * M + 1
    q, nk, nv, kp, vp = _decode_inputs(card, dtype, B, nh, hd,
                                       (P, page, nh, hd), hd + page)
    perm = np.random.default_rng(page).permutation(np.arange(1, P)).astype(
        np.int32).reshape(B, M)
    tab = perm.copy()
    tab[3, 0] = tab[2, 0]          # lanes 2 and 3 share their first page
    tab[5] = 0                     # dead lane: scratch page 0
    tables = torch.from_numpy(tab).to(card)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=card)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    CK.reset_launches()
    got, _, _ = CK.fused_paged_decode_attention(q, k1, v1, nk, nv, tables,
                                                pos)
    want, _, _ = CK.fused_paged_decode_attention_plain(q, k2, v2, nk, nv,
                                                       tables, pos)
    torch.cuda.synchronize()
    assert CK.LAUNCHES["decode_paged"] == 1
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    live = [b for b in range(B) if b != 5]
    chip_smoke._check_out("decode_paged", got[live], want[live], dtype)
    # lane 4 (pos C + 1, its row in chunk 1) with a bad entry in chunk 0;
    # lane 1 (pos C - 1, chunk 0) with a bad entry past its pos: accepted
    bad = tab.copy()
    bad[4, 0] = P
    bad[1, M - 1] = -1
    k3, v3 = kp.clone(), vp.clone()
    out, _, _ = CK.fused_paged_decode_attention(
        q, k3, v3, nk, nv, torch.from_numpy(bad).to(card), pos)
    torch.cuda.synchronize()
    assert torch.equal(out[4], torch.zeros_like(out[4]))
    w4 = int(tab[4, pos_l[4] // page])
    assert torch.equal(k3[w4], kp[w4]) and torch.equal(v3[w4], vp[w4])
    keep = [b for b in live if b != 4]
    assert torch.equal(out[keep], got[keep])
    others = torch.ones(P, dtype=torch.bool, device=card)
    others[0] = others[w4] = False
    assert torch.equal(k3[others], k1[others])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_decode_slab_beyond_the_old_row_cap(chip_smoke, dtype):
    """A slab of 16,384 rows a slot, which the score-buffer design
    refused (about 12k rows): the output against the plain version, the
    caches bitwise, one counted launch."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    card = torch.device("cuda")
    B, S, nh, hd = 2, 16384, 2, 64
    q, nk, nv, kc, vc = _decode_inputs(card, dtype, B, nh, hd,
                                       (B, S, nh, hd), 11)
    pos = torch.tensor([S - 1, 12345], dtype=torch.int32, device=card)
    k2, v2 = kc.clone(), vc.clone()
    CK.reset_launches()
    got, _, _ = CK.fused_decode_attention(q, kc, vc, nk, nv, pos)
    want, _, _ = CK.fused_decode_attention_plain(q, k2, v2, nk, nv, pos)
    torch.cuda.synchronize()
    assert CK.LAUNCHES["decode_slab"] == 1
    assert torch.equal(kc, k2) and torch.equal(vc, v2)
    chip_smoke._check_out("decode_slab", got, want, dtype)


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
    with pytest.raises(TypeError, match="dtype"):
        # batch 65 is served now; a head in another dtype is not
        CK.fused_logits_head(torch.zeros((65, 64), device=card), one, one,
                             torch.zeros((64, 10), device=card).bfloat16())
    pool = torch.zeros((5, 8, 2, 16), device=card)
    tables = torch.zeros((2, 4), dtype=torch.int32, device=card)
    pos = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="int32"):
        CK.fused_paged_decode_attention(q, pool, pool.clone(), q, q,
                                        tables.long(), pos)
    with pytest.raises(TypeError):
        CK.fused_paged_decode_attention(q.half(), pool.half(), pool.half(),
                                        q.half(), q.half(), tables, pos)
    with pytest.raises(ValueError, match="contiguous"):
        CK.fused_paged_decode_attention(
            q, pool.transpose(0, 1).contiguous().transpose(0, 1),
            pool.clone(), q, q, tables, pos)
    with pytest.raises(ValueError, match="head_dim"):
        # every hd >= 1 runs a kernel (an instance up to 128, the split
        # route past it: ROADMAP C4); an empty head runs none
        p0 = torch.zeros((5, 8, 2, 0), device=card)
        q0 = torch.zeros((2, 2, 0), device=card)
        CK.fused_paged_decode_attention(q0, p0, p0.clone(), q0, q0, tables,
                                        pos, sm_scale=1.0)
    with pytest.raises(ValueError, match="rows"):
        # a page past the split pass's staging: 16,384 rows a chunk
        big = torch.zeros((2, 16384, 2, 16), device=card)
        CK.fused_paged_decode_attention(
            q, big, big.clone(), q, q,
            torch.zeros((2, 1), dtype=torch.int32, device=card), pos)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(2 * 8 * 2 * 16 + 1, device=card)
        CK.fused_decode_attention(q, flat[1:].view(2, 8, 2, 16), kc, q, q,
                                  pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("nb", [1, 8, 64, 65, 96, 256])
def test_logits_head_any_batch(chip_smoke, dtype, nb):
    """GPT_SMALL's head (D 768, V 50304) at every batch the plan groups
    differently — one m-tile, a full group, one row past it, two groups,
    four or six — and a ragged vocab whose rows are not 16-byte aligned
    (V 50301): one counted launch a call, bf16 per element as
    ``chip_smoke.bf16_check``, f32 within 1e-5."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 plain path
    g = torch.Generator(device="cuda")
    g.manual_seed(nb)
    D = 768
    x = torch.randn((nb, D), generator=g, device="cuda").to(dtype)
    scale = 1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")
    bias = 0.1 * torch.randn(D, generator=g, device="cuda")
    for V in (50304, 50301):
        w = (0.02 * torch.randn((D, V), generator=g, device="cuda")).to(dtype)
        CK.reset_launches()
        got = CK.fused_logits_head(x, scale, bias, w)
        want = CK.fused_logits_head_plain(x, scale, bias, w)
        torch.cuda.synchronize()
        assert CK.LAUNCHES["logits_head"] == 1
        assert got.shape == (nb, V) and got.dtype == dtype
        chip_smoke._check_out(f"logits_head B {nb} V {V}", got, want, dtype)


@pytest.mark.cuda
def test_engine_max_batch_96_kernel_tokens_equal_plain(card):
    """C1: ``EngineConfig(max_batch=96)`` serves on the card. Tiny GPT in
    float32, 96 prompts decoding together: the kernel engine's greedy
    tokens equal the plain engine's, one logits_head launch a tick."""
    from paddle_tpu_torch import serving as TS
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.ops import cuda_kernels as CK

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    params = TG.init_params(cfg, seed=11, device=card)
    ekw = dict(max_batch=96, max_seq=32, prefill_buckets=(8, 16))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(1, 17, size=96)]
    tokens = []
    for fused in (True, False):
        eng = TS.DecodeEngine(params, cfg,
                              TS.EngineConfig(fused_decode=fused, **ekw),
                              device=card)
        eng.warmup()
        slots, cur = {}, {}
        for i, p in enumerate(prompts):
            slots[i], logits = eng.start_sequence(p)
            cur[i] = [int(np.argmax(logits))]
        CK.reset_launches()
        for _ in range(8):
            out = eng.decode_step({slots[i]: cur[i][-1] for i in slots})
            for i in slots:
                cur[i].append(int(np.argmax(out[slots[i]])))
        assert CK.LAUNCHES["logits_head"] == (8 if fused else 0)
        tokens.append(cur)
    assert tokens[0] == tokens[1]


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
def test_paged_engine_kernel_path_matches_plain_and_slab(card):
    """Tiny GPT in float32 on the card, paged layout: the kernel engine's
    greedy tokens equal the plain paged engine's and the slab engine's,
    and each tick launches fused_ln 2L, decode_paged L, logits_head 1."""
    from paddle_tpu_torch import serving as TS
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.ops import cuda_kernels as CK

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    params = TG.init_params(cfg, seed=7, device=card)
    ekw = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16),
               page_size=8)
    prompts = [[5, 9, 2], [7, 7, 7, 1, 3, 3], list(range(1, 12))]
    tokens = []
    for layout, fused in (("paged", True), ("paged", False),
                          ("slab", True)):
        eng = TS.DecodeEngine(params, cfg, TS.EngineConfig(
            fused_decode=fused, kv_layout=layout, **ekw), device=card)
        CK.reset_launches()
        ticks0 = eng.decode_ticks
        slots, cur = {}, {}
        for i, p in enumerate(prompts):      # all three decode together
            slots[i], logits = eng.start_sequence(p)
            cur[i] = [int(np.argmax(logits))]
        for _ in range(11):
            out = eng.decode_step({slots[i]: cur[i][-1] for i in slots})
            for i in slots:
                cur[i].append(int(np.argmax(out[slots[i]])))
        tokens.append(cur)
        ticks = eng.decode_ticks - ticks0
        L = cfg.num_layers
        want = dict.fromkeys(CK.LAUNCHES, 0)
        if fused:
            want.update({"fused_ln": 2 * L * ticks, "logits_head": ticks,
                         f"decode_{layout}": L * ticks})
        assert CK.LAUNCHES == want
    assert tokens[0] == tokens[1] == tokens[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_training_kernels_match_plain_at_path_shapes(chip_smoke, dtype):
    """Flash forward / dQ / dK,dV at [16 (bf16) or 2 (f32), 1024, 12, 64]
    from a packed qkv, causal: bf16 per element within 2^-7 x (|plain| +
    its row's max |plain|) + 1e-5 and lse within 2e-5, f32 within 2e-5 /
    3e-4; the AdamW sweep over GPT_SMALL's 163M parameters bitwise, with
    bf16 and float32 moments; the fused-LN forward forms and backward at
    [16384 (bf16) or 256 (f32), 768]; the CE forward at [2048 (bf16) or
    256 (f32), 768] x [768, 51200]."""
    recs = chip_smoke.phase_train_kernels(dtype, time_it=False)
    assert set(recs) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "opt_adamw_flat", "fused_ln", "fused_ln_bwd",
                         "ce_fwd"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("R,D", [(1, 64), (150, 80), (37, 2048), (5, 770),
                                 (33, 1024), (33, 1032), (9, 2056),
                                 (3, 12288), (5, 2560), (4, 4096),
                                 (3, 16384), (2, 20000), (2, 65536)])
def test_fused_ln_kernels_match_plain_small_shapes(chip_smoke, dtype, R, D,
                                                   offset):
    """Every forward form (bits: residual, bias_add, mask) and every
    backward form (dsx, mask) at ragged shapes — R = 1 and R not a
    multiple of a block's rows, D not a multiple of the 16-byte vector,
    each register path at its cap and past it — with every [R, D] operand
    aligned or one element into its buffer (the scalar instances): s
    bitwise, y, ds, dx per element (bf16_check; f32 1e-5), statistics
    within 1e-5 and dscale/dbias within 1e-5 relative to the column's sum
    of |term|, a second backward launch bitwise equal. Past 2048 columns
    (where the backward raised before) the backward's looped block a row
    runs; past a block's shared memory (65,536) the forward's two-pass
    block a row."""
    chip_smoke.ln_small_case(dtype, R, D, offset, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["dv", "vd"])
@pytest.mark.parametrize("n,D,vp,vocab,extra", [
    (1, 8, 128, 1, 0), (70, 64, 384, 301, 0), (300, 96, 1024, 1000, 0),
    (200, 772, 700, 650, 0), (130, 768, 1000, 999, 24),
    (129, 100, 600, 555, 3)])
def test_ce_fwd_matches_plain_small_shapes(chip_smoke, dtype, layout, n, D,
                                          vp, vocab, extra):
    """Ragged rows (n not a multiple of the 128-row tile), a vocab that
    ends inside a tile and tiles wholly past it, both head layouts, with
    and without bias, D 772 (bf16 rows not 16-byte aligned), a head with
    padded rows and one with an odd row stride: lse and gold within 1e-4
    of the plain sweep
    (``chip_smoke.ce_small_case``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.ce_small_case(dtype, layout, n, D, vp, vocab, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("n,offset", [(100_003, 0), (1001, 1), (7, 0),
                                      (8, 3)])
def test_adamw_sweep_edges_bitwise(chip_smoke, mdt, n, offset):
    """The adamw_mask sweep at n not a multiple of its 8-element vector
    (the scalar tail) and with every buffer one or three elements into
    its allocation (no operand 16-byte aligned: the scalar instance): p, m
    and v bitwise equal to the plain version's."""
    dev = torch.device("cuda")
    sc = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (1e-4, 0.7, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]
    chip_smoke._sweep_bitwise(
        f"{mdt} n {n} offset {offset}",
        chip_smoke._sweep_inputs(n, mdt, offset, n + offset), sc,
        dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [24, 48, 80, 96, 160, 256, 320])
def test_flash_padded_head_dims_match_plain(chip_smoke, dtype, causal, hd):
    """Head dims without an instance run the next one on zero-padded
    inputs, and head dims past 128 the split route (ROADMAP C4): o, lse,
    dq, dk, dv against the plain versions at T 200 (f32 within 1e-5, bf16
    per element), every output finite."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(hd)
    chip_smoke._flash_case(dtype, hd, 200, False, False, causal, None, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [8, 20, 24, 96, 160, 256, 320])
def test_decode_kernels_any_head_dim(chip_smoke, dtype, hd):
    """The slab and paged decode kernels at head dims that are not 16, 32,
    64 or 128 (the next power-of-two instance; hd 20 at bf16 and float32
    and hd 24 at bf16 are not whole 16-byte vectors: the scalar loads;
    past 128 the split route) against their plain versions, caches
    bitwise."""
    chip_smoke.decode_width_case(dtype, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [160, 256, 320])
def test_flash_wide_head_dims_bias_forms(chip_smoke, dtype, hd):
    """The split route's bias forms: a random bias a head with SQ = T
    (causal) and a padding bias a batch row with SQ = 1 (full), against
    the plain versions at T 200."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(hd)
    chip_smoke.wide_flash_bias_cases(dtype, hd, g)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("hd", [8, 96, 160])
def test_engine_any_head_dim_kernel_tokens_equal_plain(card, layout, hd):
    """A DecodeEngine over a model of head_dim 8, 96 or 160 (the split
    route), which raised at its first tick before (ROADMAP C4): float32,
    the kernel engine's greedy tokens equal the plain engine's, with L
    decode launches a tick."""
    from paddle_tpu_torch import serving as TS
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.ops import cuda_kernels as CK

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64,
                             num_heads={8: 8, 96: 2, 160: 2}[hd],
                             d_model={8: 64, 96: 192, 160: 320}[hd],
                             d_ff=256)
    assert cfg.head_dim == hd
    params = TG.init_params(cfg, seed=hd, device=card)
    ekw = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16),
               kv_layout=layout, page_size=8)
    prompts = [[5, 9, 2], [7, 7, 7, 1, 3, 3], list(range(1, 12))]
    tokens = []
    for fused in (True, False):
        eng = TS.DecodeEngine(params, cfg,
                              TS.EngineConfig(fused_decode=fused, **ekw),
                              device=card)
        slots, cur = {}, {}
        for i, p in enumerate(prompts):
            slots[i], logits = eng.start_sequence(p)
            cur[i] = [int(np.argmax(logits))]
        CK.reset_launches()
        for _ in range(10):
            out = eng.decode_step({slots[i]: cur[i][-1] for i in slots})
            for i in slots:
                cur[i].append(int(np.argmax(out[slots[i]])))
        assert CK.LAUNCHES[f"decode_{layout}"] == (
            10 * cfg.num_layers if fused else 0)
        tokens.append(cur)
    assert tokens[0] == tokens[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("nb", [1, 8, 50])
def test_logits_head_wide_rows(chip_smoke, dtype, nb):
    """logits_head at D 8,192 (past its shared-memory plan: the streamed
    instance, ROADMAP C5) against its plain version."""
    chip_smoke.logits_head_width_case(dtype, 8192, nb=nb)


@pytest.mark.cuda
def test_fused_ln_and_chunked_ce_autograd_on_card(card):
    """On CUDA tensors (float32, TF32 off): fused_ln with residual,
    bias_add and return_residual launches the forward and the backward
    kernel once each and gives the plain versions' gradients;
    chunked_lm_loss launches the CE forward once a row chunk and gives the
    plain sweep's loss and gradients (1e-5 / 3e-4)."""
    from paddle_tpu_torch.ops import chunked_ce as CE
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import fused_ln as FL

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card)
    g.manual_seed(5)
    x, res, w, w2 = (torch.randn((96, 64), generator=g, device=card)
                     for _ in range(4))
    scale, bias, badd = (torch.randn(64, generator=g, device=card)
                         for _ in range(3))
    grads = []
    for on_card in (True, False):
        xs = [t.clone().requires_grad_() for t in (x, scale, bias, res, badd)]
        CK.reset_launches()
        if on_card:
            y, s = FL.fused_ln(*xs, return_residual=True)
        else:
            s = (xs[3] + xs[0]) + xs[4]
            y = FL.fused_ln_fwd_plain(s, xs[1], xs[2])[0]
        ((y * w).sum() + (s * w2).sum()).backward()
        grads.append([t.grad for t in xs])
        if on_card:
            assert (CK.LAUNCHES["fused_ln"], CK.LAUNCHES["fused_ln_bwd"]) \
                == (1, 1)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)
    h = (torch.randn((64, 1000), generator=g, device=card) * 0.1)
    labels = torch.randint(0, 1000, (96,), generator=g, device=card)
    outs = []
    for use_pallas in (None, False):
        xs = [x.clone().requires_grad_(), h.clone().requires_grad_()]
        CK.reset_launches()
        loss = CE.chunked_lm_loss(xs[0], xs[1], labels, vocab_chunk=256,
                                  row_chunk=40, use_pallas=use_pallas)
        loss.backward()
        assert CK.LAUNCHES["ce_fwd"] == (3 if use_pallas is None else 0)
        outs.append((loss, xs[0].grad, xs[1].grad))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=0, rtol=1e-5)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,hd", [(100, 32), (256, 64), (192, 128),
                                  (80, 16), (130, 8)])
def test_flash_kernels_match_plain_small_shapes(chip_smoke, dtype, causal,
                                               T, hd):
    """Ragged sequence lengths (T not a multiple of the 64- or 128-row
    tiles), full attention and every head_dim the kernels take (8 through
    zero padding to 16); the bounds of ``chip_smoke.phase_train_kernels``."""
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


def _flash_bwd_inputs(dtype, T, hd, causal, form, seed):
    """q, k, v sliced from one packed qkv, dO, the forward's (o, lse) and
    a bias of ``form`` ("none", "row": [B, 1, T], "full": [B·nh, T, T])
    on the card, B 2, nh 3."""
    from paddle_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    qkv = torch.randn((2, T, 3, 3, hd), generator=g, device="cuda").to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((2, T, 3, hd), generator=g, device="cuda").to(dtype)
    bias = {"none": None,
            "row": torch.randn((2, 1, T), generator=g, device="cuda"),
            "full": torch.randn((6, T, T), generator=g, device="cuda")}[form]
    o, lse = FA.flash_fwd(q, k, v, causal, bias=bias)
    return (q, k, v, o, lse, do), bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("form", ["none", "row", "full"])
def test_flash_di_route_matches_plain(chip_smoke, dtype, form):
    """``flash_bwd_dq(return_di=True)`` gives the plain version's dq (bf16
    per element as ``chip_smoke.bf16_check``, f32 3e-4) and D = rowsum(dO
    * o) (float32, within 2e-5); ``flash_bwd_dkv(di=D)`` gives the plain
    version's dk, dv fed the same D; and dK/dV with dQ's D equals dK/dV
    without ``di`` (its wrapper then takes D from its own dQ launch),
    bitwise. T 200, head_dim 64, causal."""
    from paddle_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    ins, bias = _flash_bwd_inputs(dtype, 200, 64, True, form, 11)

    def close(got, want):
        if dtype == torch.bfloat16:
            chip_smoke.bf16_check("flash di route", got, want)
        else:
            torch.testing.assert_close(got, want, atol=3e-4, rtol=3e-4)

    dq, di = FA.flash_bwd_dq(*ins, True, bias=bias, return_di=True)
    dq_p, di_p = FA.flash_bwd_dq_plain(*ins, True, bias=bias,
                                       return_di=True)
    assert di.shape == (2, 3, 200) and di.dtype == torch.float32
    close(dq, dq_p)
    torch.testing.assert_close(di, di_p, atol=2e-5, rtol=2e-5)
    dkv = FA.flash_bwd_dkv(*ins, True, bias=bias, di=di)
    for got, want in zip(dkv, FA.flash_bwd_dkv_plain(*ins, True, bias=bias,
                                                     di=di)):
        close(got, want)
    for a, b in zip(dkv, FA.flash_bwd_dkv(*ins, True, bias=bias)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("form", ["none", "row", "full"])
@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
def test_flash_bwd_bitwise_run_to_run(card, dtype, form, hd):
    """Each block owns its rows and no kernel uses atomics: two launches
    of dQ and of dK/dV on the same inputs give bitwise-equal dq, dk and
    dv, at a ragged T (200), every head_dim, bias-free and with each bias
    shape."""
    from paddle_tpu_torch.ops import flash_attention as FA

    ins, bias = _flash_bwd_inputs(dtype, 200, hd, True, form, hd)
    first = [FA.flash_bwd_dq(*ins, True, bias=bias, return_di=True)]
    first.append(FA.flash_bwd_dkv(*ins, True, bias=bias, di=first[0][1]))
    second = [FA.flash_bwd_dq(*ins, True, bias=bias, return_di=True)]
    second.append(FA.flash_bwd_dkv(*ins, True, bias=bias, di=second[0][1]))
    torch.cuda.synchronize()
    for a, b in zip([*first[0], *first[1]], [*second[0], *second[1]]):
        assert torch.equal(a, b)
    assert all(torch.isfinite(x.float()).all() for x in first[1])


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
def test_gpt_tiny_trains_with_flash_on_card(card):
    """C2: GPT_TINY (head_dim 16) with ``use_flash=True`` on the card, f32:
    loss and gradients of the kernel path within 1e-5 / 3e-4 of the plain
    attention path, each flash kernel launched once a layer, and three
    train steps with finite, falling losses."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.parallel import parallelize as PZ

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = G.GPT_TINY.scaled(use_flash=True)
    assert cfg.head_dim == 16
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4, 64))
                            ).cuda()
    labs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4, 64))
                            ).cuda()
    out = {}
    for flash in (True, False):
        params = G.init_params(cfg, seed=6, device=card)
        leaves = [p.detach().requires_grad_() for p in PZ.flat_leaves(params)]
        CK.reset_launches()
        loss = G.loss_fn(PZ._unflatten(params, leaves), toks[0], labs[0],
                         cfg.scaled(use_flash=flash))
        out[flash] = (loss.item(), torch.autograd.grad(loss, leaves))
        L = cfg.num_layers if flash else 0
        assert (CK.LAUNCHES["flash_fwd"], CK.LAUNCHES["flash_bwd_dq"],
                CK.LAUNCHES["flash_bwd_dkv"]) == (L, L, L)
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)
    params, opt = PZ.init_sharded(cfg, seed=6, device="cuda")
    step = PZ.make_train_step(cfg, lr=1e-3, device="cuda")
    losses = []
    for _ in range(3):
        params, opt, loss, _g = step(params, opt, toks, labs)
        losses.append(loss.item())
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.cuda
def test_train_step_kernel_matches_plain(chip_smoke):
    """2-layer GPT_SMALL float32: 3 kernel steps vs 3 plain steps."""
    chip_smoke.phase_train_parity()


@pytest.mark.cuda
def test_training_wrappers_raise_on_inputs_the_kernels_do_not_take(card):
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import flash_attention as FA

    x = torch.zeros((1, 64, 2, 0), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        # every hd >= 1 runs a kernel (past 128 the split route: ROADMAP
        # C4); an empty head runs none
        FA.flash_fwd(x, x, x, sm_scale=1.0)
    x = torch.zeros((1, 64, 2, 64), device=card)
    with pytest.raises(TypeError):
        FA.flash_fwd(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="strides"):
        FA.flash_fwd(x, x.transpose(1, 2).contiguous().transpose(1, 2), x)
    p = torch.zeros(16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        CK.megakernel_adamw_flat(p, p, p, torch.zeros(32, device=card)[::2],
                                 p, 1e-3, 1.0, 0.1, 0.1)
    from paddle_tpu_torch.ops import chunked_ce as CE
    from paddle_tpu_torch.ops import fused_ln as FL

    x = torch.zeros((4, 64), device=card)
    one = torch.ones(64, device=card)
    with pytest.raises(TypeError):
        FL.fused_ln_fwd(x, one, one, residual=x.bfloat16())
    with pytest.raises(TypeError):
        FL.fused_ln_fwd(x, one, one, mask=x)
    # D 4096 (past the backward's old 2048 cap) and a CE row of D 6 (not
    # a whole 16-byte vector) now run on their kernels (ROADMAP C5)
    big = torch.zeros((2, 4096), device=card)
    FL.fused_ln_bwd(big, torch.zeros(2, device=card),
                    torch.ones(2, device=card),
                    torch.ones(4096, device=card), big)
    labels = torch.zeros(4, dtype=torch.int32, device=card)
    lse, gold = CE.ce_fwd(torch.zeros((4, 6), device=card),
                          torch.zeros((6, 128), device=card), None, labels,
                          128, 128)
    torch.testing.assert_close(lse, torch.full_like(lse, float(np.log(128))))
    with pytest.raises(ValueError, match="labels"):
        CE.ce_fwd(x, torch.zeros((64, 128), device=card), None, labels[:3],
                  128, 128)
    with pytest.raises(ValueError, match="dtype"):
        CE.ce_fwd(x, torch.zeros((64, 128), device=card).bfloat16(), None,
                  labels, 128, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [64, 8])
def test_flash_bias_kernels_match_plain(chip_smoke, dtype, causal, hd):
    """The bias forms (``chip_smoke.py`` phase 8's cases): BB in {B,
    B·nh} x SQ in {1, T}, a random bias and a padding bias whose first
    key tile is wholly padded, T 200; f32 within 1e-5,
    bf16 per element, every output finite."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(hd + causal)
    for per_head in (False, True):
        for sq1 in (True, False):
            for kind in ("random", "padding"):
                chip_smoke._flash_case(dtype, hd, 200, per_head, sq1,
                                       causal, kind, g)


@pytest.mark.cuda
def test_flash_bias_autograd_on_card(card):
    """``flash_attention(bias=)`` on CUDA tensors launches the three bias
    kernels once each (and no bias-free one) and gives the plain path's
    gradients (float32, 3e-4); the bias gets none."""
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=card)
    g.manual_seed(2)
    q, k, v, w = (torch.randn((2, 128, 2, 64), generator=g, device=card)
                  for _ in range(4))
    bias = torch.zeros((2, 1, 1, 128), device=card)
    bias[1, ..., 100:] = -0.5 * torch.finfo(torch.float32).max
    grads = []
    for on_card in (True, False):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        if on_card:
            CK.reset_launches()
            out = FA.flash_attention(*xs, causal=False, bias=bias)
        else:
            out = FA.flash_fwd_plain(*xs, False, bias=bias[:, 0])[0]
        (out * w).sum().backward()
        grads.append([x.grad for x in xs])
    assert {k: v for k, v in CK.LAUNCHES.items() if v} == {
        "flash_fwd_bias": 1, "flash_bwd_dq_bias": 1, "flash_bwd_dkv_bias": 1}
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
def test_ernie_tiny_trains_with_flash_bias_on_card(card):
    """ERNIE_TINY (head_dim 8: the 16 instance on zero-padded inputs) with
    padded lengths, f32: 3 pretrain steps with flash and its padding bias
    equal the plain attention arm's (losses 1e-5 relative, params 1e-5),
    each bias kernel launched once a layer a step."""
    from paddle_tpu_torch.models import ernie as E
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.parallel.parallelize import flat_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(9)
    cfg = E.ERNIE_TINY
    M = cfg.max_masked
    lens = rng.integers(16, 65, 4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 64)),
             "seg_ids": rng.integers(0, 2, (4, 64)),
             "pad_mask": np.arange(64)[None] < lens[:, None],
             "mlm_pos": rng.integers(0, 64, (4, M)),
             "mlm_ids": rng.integers(0, cfg.vocab_size, (4, M)),
             "mlm_valid": np.ones((4, M), bool),
             "nsp_label": rng.integers(0, 2, (4,))}
    out = {}
    for flash in (True, False):
        acfg = cfg.scaled(use_flash=flash)
        params = E.init_params(acfg, seed=9, device=card)
        opt = E.init_opt(params)
        step = E.make_pretrain_step(acfg, lr=1e-2, device=card)
        CK.reset_launches()
        losses = [step(params, opt, batch)[2].item() for _ in range(3)]
        L = 3 * cfg.num_layers if flash else 0
        assert (CK.LAUNCHES["flash_fwd_bias"],
                CK.LAUNCHES["flash_bwd_dq_bias"],
                CK.LAUNCHES["flash_bwd_dkv_bias"]) == (L, L, L)
        out[flash] = (losses, flat_leaves(params))
    assert np.all(np.isfinite(out[True][0]))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_ernie_parity_kernel_matches_plain(chip_smoke):
    """2-layer ERNIE_BASE float32: the flash and fused arms vs plain."""
    chip_smoke.phase_ernie_parity()


@pytest.mark.cuda
def test_flash_bias_wrappers_raise_on_biases_the_kernels_do_not_take(card):
    from paddle_tpu_torch.ops import flash_attention as FA

    x = torch.zeros((2, 64, 2, 64), device=card)
    with pytest.raises(TypeError, match="float32"):
        FA.flash_fwd(x, x, x, bias=torch.zeros((2, 1, 64), device=card,
                                               dtype=torch.bfloat16))
    for shape in ((3, 1, 64), (2, 2, 64), (2, 1, 32)):
        with pytest.raises(ValueError, match="bias"):
            FA.flash_fwd(x, x, x, bias=torch.zeros(shape, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_bwd_dq(x, x, x, x, torch.zeros((2, 2, 64), device=card), x,
                        bias=torch.zeros((2, 1, 128), device=card)[..., ::2])


@pytest.mark.cuda
def test_opt_kinds_match_plain_bitwise(chip_smoke):
    """The sgd, momentum and adam sweeps against their plain versions,
    bitwise, at ResNet-50's group size and at odd, small and unaligned n
    (sgd also bf16; Nesterov; AdamW)."""
    recs = chip_smoke.phase_opt_kernels(time_it=False)
    assert set(recs) == {"opt_sgd", "opt_momentum", "opt_adam",
                         "opt_adamw"}


@pytest.mark.cuda
def test_fluid_fused_routes_match_plain_bitwise(chip_smoke):
    """The fluid MLP under each fused optimizer, ResNet-18 at 32² and
    the same ResNet-18 under bf16 AMP (``decorate(Momentum(fuse=True))``)
    train the same bits through the kernels and the unfused expressions,
    with one launch of the kernel a step; the fp16 loss-scale sequence
    equals the CPU's."""
    launches = chip_smoke.phase_fluid_parity()
    assert launches == {"opt_sgd": 5, "opt_momentum": 5 + 3 + 3,
                        "opt_adam": 5, "opt_adamw": 5}


@pytest.mark.cuda
def test_executor_run_is_a_fresh_process_first_card_work(card):
    """A process whose first card work is ``Executor(CUDAPlace(0)).run``
    (the README's fluid example) runs: the program report's peak-memory
    counter used to raise "Invalid device argument" before any CUDA
    context existed."""
    import subprocess

    code = (
        "import numpy as np, paddle_tpu_torch as T\n"
        "main, startup = T.Program(), T.Program()\n"
        "with T.program_guard(main, startup):\n"
        "    x = T.layers.data('x', [4])\n"
        "    loss = T.layers.reduce_mean(T.layers.fc(x, 3))\n"
        "    T.optimizer.SGD(0.1).minimize(loss)\n"
        "exe, scope = T.Executor(T.CUDAPlace(0)), T.Scope()\n"
        "exe.run(startup, scope=scope)\n"
        "(lv,) = exe.run(main, feed={'x': np.ones((2, 4), np.float32)},\n"
        "                fetch_list=[loss], scope=scope)\n"
        "assert np.isfinite(lv), lv\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


class _Op:
    def __init__(self, attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _mha_run(dev, ins, attrs, cot):
    """``multihead_matmul``'s lowering on ``dev`` with autograd: Out and
    the gradients of Input, W and Bias for the cotangent ``cot``."""
    from paddle_tpu_torch.framework.registry import LowerCtx, get_op_spec

    leaves = {k: [v.to(dev).clone().requires_grad_(k != "BiasQK")]
              for k, v in ins.items()}
    out = get_op_spec("multihead_matmul").lower(
        LowerCtx(torch.device(dev)), _Op(attrs), leaves)["Out"]
    out.backward(cot.to(dev))
    return [out.detach().cpu()] + [leaves[k][0].grad.cpu()
                                   for k in ("Input", "W", "Bias")]


def _mha_out_bf16_projection(ins, attrs):
    """``multihead_matmul``'s Out on the CPU as the card rounds it: the
    projection in bf16 (q, k and v are bf16 values when the flash kernels
    get them), then the naive attention in float32."""
    x, w, b = ins["Input"], ins["W"], ins["Bias"]
    B, S, H = x.shape
    nh = attrs["head_number"]
    qkv = (torch.matmul(x, w.reshape(H, 3 * H)) + b.reshape(3 * H)) \
        .float().reshape(B, S, 3, nh, H // nh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bsnd,btnd->bnst", q, k) * attrs["alpha"]
    if "BiasQK" in ins:
        logits = logits + ins["BiasQK"].float()
    out = torch.einsum("bnst,btnd->bsnd", torch.softmax(logits, -1), v)
    return out.reshape(B, S, H)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("bias", ["none", "full", "pad", "unflashable"])
def test_multihead_matmul_on_card_matches_cpu(chip_smoke, dtype, bias):
    """``multihead_matmul`` on CUDA tensors (the flash kernels, their
    bias forms with a bias; a bias they cannot take, [1, nh, S, S] at B
    2, the naive path) against the same lowering on CPU tensors (the
    naive path) at ERNIE's head width: Out and the Input / W / Bias
    gradients, f32 (TF32 off) within 3e-4 of their scale (the flash
    gradients' band). In bf16, Out is held to ``chip_smoke.bf16_check``'s
    bound against :func:`_mha_out_bf16_projection` (the card's rounding:
    the projection in bf16, then float32 attention), or, for the
    unflashable bias, against the CPU's naive path in bf16; the gradients
    against the CPU path on the same bf16 values in float32, within 2e-2
    of their scale (the projection's products sum 192 bf16 terms).
    Launches: one of each flash kernel (``_bias`` forms with a bias),
    none for the unflashable bias."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    B, S, nh, hd = 2, 200, 3, 64
    H = nh * hd
    ins = {"Input": torch.randn((B, S, H), generator=g),
           "W": torch.randn((H, 3 * H), generator=g) * H ** -0.5,
           "Bias": torch.randn((3 * H,), generator=g) * 0.1}
    shape = {"full": (B, nh, S, S), "pad": (B, 1, 1, S),
             "unflashable": (1, nh, S, S)}.get(bias)
    if bias == "pad":
        ins["BiasQK"] = torch.where(torch.arange(S) < 150, 0.0, -1e4) \
            .expand(shape).contiguous()
    elif shape is not None:
        ins["BiasQK"] = torch.randn(shape, generator=g)
    ins = {k: v.to(dtype) for k, v in ins.items()}
    attrs = {"head_number": nh, "alpha": hd ** -0.5}
    cot = torch.randn((B, S, H), generator=g).to(dtype)
    CK.reset_launches()
    got = _mha_run("cuda", ins, attrs, cot)
    launched = {k: v for k, v in CK.LAUNCHES.items() if v}
    # the unflashable bias takes the naive path on both devices
    ref = dtype if bias == "unflashable" else torch.float32
    want = _mha_run("cpu", {k: v.to(ref) for k, v in ins.items()}, attrs,
                    cot.to(ref))
    if bias == "unflashable":
        assert launched == {}
    else:
        sfx = "" if bias == "none" else "_bias"
        assert launched == {f"flash_fwd{sfx}": 1, f"flash_bwd_dq{sfx}": 1,
                            f"flash_bwd_dkv{sfx}": 1}
    ratios = [((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item() for a, b in zip(got, want)]
    print(f"multihead_matmul {bias} {dtype}: Out, dInput, dW, dBias diff "
          f"over scale {ratios}")
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == dtype
        if dtype == torch.bfloat16 and i == 0:
            if bias != "unflashable":
                b = _mha_out_bf16_projection(ins, attrs)
            chip_smoke.bf16_check(f"multihead_matmul {bias} bf16 Out",
                                  a.reshape(B, S, nh, hd),
                                  b.reshape(B, S, nh, hd))
            continue
        tol = 3e-4 if dtype == torch.float32 else 2e-2
        assert ratios[i] <= tol, (i, ratios)


@pytest.mark.cuda
def test_encoder_card_matches_cpu(chip_smoke):
    """Phase 10ep: the 2-layer float32 encoder on the card (flash bias
    kernels) against the CPU (naive path), 3 AdamW steps, and the
    vocab-chunked CE at [2048, 30522]."""
    launches = chip_smoke.phase_encoder_parity()
    assert launches == {"flash_fwd_bias": 6, "flash_bwd_dq_bias": 6,
                        "flash_bwd_dkv_bias": 6, "opt_adamw": 3}


@pytest.mark.cuda
def test_optimizers_on_card_match_cpu(chip_smoke):
    """Phase 10o: every per-parameter update rule past SGD, Momentum and
    Adam, Lookahead, EMA and ModelAverage, RecomputeOptimizer(Lamb) and
    the merged fused Momentum over a batch norm, 3 steps on the card
    against the CPU (losses 1e-5 relative, persistables 1e-5 of their
    scale); recompute's dropout masks replayed on each device."""
    assert chip_smoke.phase_optimizer_parity() == {"opt_momentum": 3}


@pytest.mark.cuda
def test_opt_kind_wrappers_raise_on_inputs_the_kernels_do_not_take(card):
    from paddle_tpu_torch.ops import cuda_kernels as CK

    f = torch.zeros(8, device=card)
    with pytest.raises(TypeError, match="float32"):
        CK.megakernel_momentum(f.half(), f, f.clone(), 0.1)
    with pytest.raises(ValueError, match="share a dtype"):
        CK.megakernel_sgd(f.clone(), f.bfloat16(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        CK.megakernel_adam(f.clone(), torch.zeros(16, device=card)[::2],
                           f.clone(), f.clone(), 0.1, 0.9, 0.999)
    with pytest.raises(ValueError, match="mixed"):
        CK.megakernel_sgd(f.clone(), f.cpu(), 0.1)


def _handoff_engines(dev, layout, wd):
    """(prefill, decode) GPT_TINY engines (2 layers) on ``dev`` from one set
    of seed-0 weights, bf16 or f32 throughout, page 8 on the paged
    layout."""
    from paddle_tpu_torch.models.gpt import GPT_TINY, init_params
    from paddle_tpu_torch.serving import DecodeEngine, EngineConfig

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[wd]
    cfg = GPT_TINY.scaled(num_layers=2, max_seq_len=64, dtype=dt)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(dev)

    params = to(init_params(cfg, seed=0, device="cpu"))
    kw = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16),
              weight_dtype=wd, kv_layout=layout, page_size=8)
    return tuple(DecodeEngine(params, cfg, EngineConfig(role=r, **kw),
                              device=dev) for r in ("prefill", "decode"))


def _slot_kv(eng, slot):
    """The slot's valid pages or rows, (k, v) on the host."""
    n = eng.cache.length(slot)
    if eng.paged:
        return eng.cache.read_pages(
            eng.cache.table_row(slot)[:eng.cache.pages_for(n)])
    return eng.cache.read_rows(slot, 0, n)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("wd", ["bf16", "f32"])
def test_kv_handoff_between_card_engines_bitwise(card, layout, wd):
    """A card prefill engine hands a 13-token prompt's KV to a card decode
    engine: pages or rows bitwise and the same 4 greedy tokens on both
    sides; the card's frames adopt into a CPU engine bitwise, and the CPU
    engine's export adopts back on the card bitwise."""
    from paddle_tpu_torch.serving import kv_transfer as kvt

    src, dst = _handoff_engines(card, layout, wd)
    prompt = list(range(3, 16))
    slot, logits = src.start_sequence(prompt)
    handoff = src.export_request_kv(slot, tokens=prompt)
    assert handoff["fingerprint"]["dtype"] == {"bf16": "bfloat16",
                                               "f32": "float32"}[wd]
    dslot = dst.adopt_request_kv(handoff)
    want = _slot_kv(src, slot)
    for a, b in zip(_slot_kv(dst, dslot), want):
        assert torch.equal(a, b)
    a_tok = b_tok = int(np.argmax(logits))
    for _ in range(4):
        a_tok = int(np.argmax(src.decode_step({slot: a_tok})[slot]))
        b_tok = int(np.argmax(dst.decode_step({dslot: b_tok})[dslot]))
        assert a_tok == b_tok
    # card -> CPU (through JSON) -> card
    _, host = _handoff_engines(torch.device("cpu"), layout, wd)
    hslot = host.adopt_request_kv(kvt.handoff_from_jsonable(json.loads(
        json.dumps(kvt.handoff_to_jsonable(handoff)))))
    for a, b in zip(_slot_kv(host, hslot), want):
        assert torch.equal(a, b)
    back = dst.adopt_request_kv(host.export_request_kv(hslot))
    for a, b in zip(_slot_kv(dst, back), want):
        assert torch.equal(a, b)
    assert kvt.last_stats("adopt").peak_bytes <= \
        kvt.last_stats("adopt").budget_bytes


@pytest.mark.cuda
def test_disagg_parity_on_card(chip_smoke):
    """Phase 5d: router tokens equal the colocated kernel engine's (f32,
    slab and paged), adopted KV bitwise, the page_size mismatch refused
    by name, the empty decode fleet degrading to the same tokens."""
    chip_smoke.phase_disagg_parity()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_engines_decoding_at_once_match_one_at_a_time(card, chip_smoke,
                                                      layout):
    """Two f32 kernel engines (TF32 off, GPT_TINY at 2 layers; their roles
    only label metrics), each on a thread of its own, decode different
    prompts at once on the default stream, as two replicas' loop threads
    do: each emits the greedy tokens the first emitted alone. The decode
    kernels' workspace is one a stream, so a split pass of one engine
    queued between another's split and merge would show here as other
    tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    engines = _handoff_engines(card, layout, "f32")
    prompts = [list(range(3, 3 + n)) for n in (3, 5, 9, 14)]
    want = [chip_smoke._greedy_tokens(engines[0], p, 16) for p in prompts]
    for got in chip_smoke.concurrent_greedy(engines, prompts, 16):
        assert got == want


def _world_one_step(cfg, params_np, tokens, labels, steps, card):
    """The one-device step (no mesh) from ``params_np`` on the card."""
    from paddle_tpu_torch.parallel import parallelize as PZ

    params, opt = PZ.init_sharded(cfg, device=card)
    for dst, src in zip(PZ.flat_leaves(params), PZ.flat_leaves(params_np)):
        dst.copy_(torch.from_numpy(src))
    step = PZ.make_train_step(cfg, lr=1e-2, device=card)
    losses = []
    for _ in range(steps):
        params, opt, loss, _g = step(params, opt, tokens.reshape(
            1, -1, tokens.shape[-1]), labels.reshape(1, -1, labels.shape[-1]))
        losses.append(float(loss))
    return losses, [p.cpu().numpy() for p in PZ.flat_leaves(params)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [dict(dp=2), dict(tp=2),
                                    dict(pp=2, microbatches=2)],
                         ids=["dp2", "tp2", "pp2"])
def test_world_two_on_one_card_matches_world_one(card, tmp_path, layout):
    """Two gloo ranks on cuda:0 (each collective staged through host
    memory) train 3 steps of a float32 GPT_TINY with the flash and
    fused-LN kernels; losses and every rank's param shards equal the
    one-device step's within the reference's tolerances (losses rtol
    2e-4, params rtol 2e-3 / atol 2e-4)."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_dist_worker as W
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel import parallelize as PZ

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_kw = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64,
                  d_ff=128, use_flash=True, fused_ln=True)
    cfg = G.GPT_TINY.scaled(**cfg_kw)
    params = G.init_params(cfg, seed=0, device="cpu")
    pnp = PZ._unflatten(params, [p.numpy() for p in PZ.flat_leaves(params)])
    m = layout.get("microbatches", 1)
    rng = np.random.default_rng(3)
    tokens, labels = (rng.integers(0, 64, (m, 4 // m, 64)) for _ in "tl")
    ranks = [r[0] for r in W.spawn(
        W.step_worker, 2, cfg_kw, layout, pnp, tokens, labels,
        [dict(step_kw=dict(lr=1e-2), steps=3)], out_dir=str(tmp_path),
        device="cuda:0", timeout=300)]
    want_losses, want = _world_one_step(cfg, pnp, tokens, labels, 3, card)
    pcfg = PZ.ParallelConfig(**layout)
    sizes = dict(dp=pcfg.dp, pp=pcfg.pp, tp=pcfg.tp)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=2e-4)
        mesh = type("M", (), {"sizes": sizes, "coords": r["coords"]})
        for got, full, spec in zip(r["params"], want,
                                   PZ.flat_specs(cfg, pcfg)):
            np.testing.assert_allclose(
                got, mesh_mod.local_shard(full, spec, mesh), rtol=2e-3,
                atol=2e-4)


@pytest.mark.cuda
def test_adamw_sweep_on_shards_at_odd_offsets(card):
    """The reduce-scatter step's sweep runs on a dp shard of the bucket
    layout, which may start at any element: the kernel on views at odd
    offsets of one buffer (n odd, so no 16-byte vector lines up) equals
    the plain sweep bitwise at float32 moments."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    gen = torch.Generator(device=card).manual_seed(4)
    n, total = 100_003, 300_017
    bufs = [torch.randn(total, generator=gen, device=card) for _ in range(5)]
    bufs[3] = bufs[3].abs()
    bufs[4] = (bufs[4] > 0).float()
    for off in (1, 353, 100_005):
        ins = [b[off:off + n] for b in bufs]
        want = [t.clone() for t in ins]
        CK.megakernel_adamw_flat(*ins, 1e-3, 0.7, 0.1, 0.05)
        CK.megakernel_adamw_flat_plain(*want, 1e-3, 0.7, 0.1, 0.05)
        for a, b in zip(ins, want):
            assert torch.equal(a, b), off


@pytest.mark.cuda
def test_ring_attention_on_card(chip_smoke):
    """Phase 12r: ring attention at cp 2 over gloo on the card at
    GPT_SMALL's attention shape [16, 1024, 12, 64] against plain
    full-sequence float32 attention: output within 1e-5, gradients within
    1e-4."""
    rec = chip_smoke.phase_ring()
    assert rec["max_abs_err"] <= 1e-5 and rec["grad_max_abs_err"] <= 1e-4


@pytest.mark.cuda
def test_checkpoint_round_trip_gpt_small_bitwise(card, tmp_path):
    """GPT_SMALL (phase 7b's levers, bf16 moments, params views of one flat
    buffer): an async save, then at once an in-place step, then the
    restore: every param and moment is the pre-step state bit for bit,
    the params are still views of the flat buffer the sweep updates, and
    the next step reproduces the first step's state bit for bit."""
    from paddle_tpu_torch.parallel import checkpoint as C
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.tools import train_bench as TB

    cfg = TB.bench_config(fused_ln=True, ce_vchunk=1024)
    params, opt = PZ.init_sharded(cfg, seed=0, moment_dtype=torch.bfloat16,
                                  fused_opt=True, device=card)
    step = PZ.make_train_step(cfg, lr=1e-3, fused_opt=True, device=card)
    rng = np.random.default_rng(0)
    toks, labs = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (1, 2, 1024))).to(card)
                  for _ in "tl")
    step(params, opt, toks, labs)          # nonzero moments

    def snapshot():
        return [t.clone() for _, t in C.flatten_with_keys(
            {"params": params, "opt": opt})]

    before = snapshot()
    ck = C.ElasticCheckpointer(tmp_path / "ckpt", use_async=True)
    ck.save(1, {"params": params, "opt": opt})
    step(params, opt, toks, labs)          # in place, while the write runs
    after = snapshot()
    ck.wait()
    C.restore_train_state(ck, params, opt, step=1)
    for a, b in zip(snapshot(), before):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert PZ._flat_base(PZ.flat_leaves(params)) is not None
    step(params, opt, toks, labs)
    for a, b in zip(snapshot(), after):
        assert torch.equal(a, b)
    ck.close()


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["pp2", "dp2", "c_allreduce_sum"])
def test_fluid_mesh_gates_on_card(card, tmp_path, gate):
    """chip_smoke's 11f gates at 2 gloo ranks sharing the card: the
    encoder at 2 layers pipelined against one rank (rtol 2e-4, atol 1e-5;
    Adam's noise-floor elements within lr a step), ResNet-18 under
    ``with_data_parallel`` against one rank on the whole batch (rtol
    5e-4, atol 5e-5), the per-rank ``c_allreduce_sum`` program against
    the numpy sum (rtol 1e-6)."""
    if str(REPO / "tests") not in sys.path:
        sys.path.insert(0, str(REPO / "tests"))
    import torch_dist_worker as W
    from paddle_tpu_torch.tools import train_bench as TB

    ranks = W.spawn(W.fluid_gate_worker, 2, gate, out_dir=str(tmp_path),
                    device="cuda:0", timeout=600)
    for par in ranks:
        assert (par["ok"] if gate == "c_allreduce_sum"
                else TB.fluid_parity_ok(par)), par
