"""Every width the reference takes has a hand kernel in the port: the
repairs of ROADMAP C4 (head dims) and C5 (row widths), on the CPU.

- Flash at head_dim 24 and 96 goes through the wrappers' padded route —
  zero columns up to the next compiled instance (32, 128), the scale
  1/sqrt(true hd), outputs sliced back — against JAX's
  ``flash_attention`` in interpret mode: output to 2e-5, gradients to
  3e-4 (``tests/test_pallas.py:37, :57``). The route is what a CUDA
  tensor takes; here the wrappers' device test is patched so the padded
  call runs (each padded call then lands on the plain versions).
- Past 128 every head_dim takes the split route as it is (no padding);
  on the CPU it runs the plain versions, held at hd 256 against JAX's
  interpret-mode kernel and at hd 160 and 320 against plain attention in
  JAX: JAX's Pallas kernel takes hd up to 128 and whole multiples of 128
  past it (``_bcast_lanes`` raises "width 160 not a multiple of 128").
- The decode kernels' instance (the next power of two) and split plan
  for any hd up to 128, and the split route's plan past it.
- The fused-LN forward and backward plans and the logits-head plan give
  an instance at D = 2,560, 4,096, 16,384 and 20,000; the CE plan takes
  any D (it depends on rows and columns only) and covers the vocab.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as PK
from paddle_tpu_torch.ops import chunked_ce as TCE
from paddle_tpu_torch.ops import cuda_kernels as CK
from paddle_tpu_torch.ops import flash_attention as TFA
from paddle_tpu_torch.ops import fused_ln as TFL

WIDE = (2560, 4096, 16384, 20000)


def _padded_route(monkeypatch):
    """Route a call whose head_dim has no instance as a CUDA tensor
    would (the padded branch), and the padded call to the plain
    versions; returns the head dims the padded branch was entered
    with."""
    seen = []

    def on_card(*ts):
        hd = ts[0].shape[-1]
        if hd in TFA._HEAD_DIMS:
            return False
        seen.append(hd)
        return True

    monkeypatch.setattr(TFA._ck, "_on_card", on_card)
    return seen


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [24, 96])
def test_flash_padded_head_dims_match_jax(monkeypatch, hd, causal):
    rng = np.random.default_rng(hd)
    q, k, v, w = (rng.standard_normal((2, 128, 2, hd)).astype(np.float32)
                  for _ in range(4))
    jf = lambda q, k, v: PK.flash_attention(  # noqa: E731
        q, k, v, causal=causal, block_q=64, block_k=64)
    want = jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = jax.grad(lambda q, k, v: jnp.sum(jf(q, k, v) * w),
                  argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    seen = _padded_route(monkeypatch)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = TFA.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (2, 128, 2, hd)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        assert a.shape == (2, 128, 2, hd)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4,
                                   rtol=3e-4)
    # forward, dQ (with D) and dK/dV each went through the padded branch
    assert len(seen) >= 3 and set(seen) == {hd}
    assert TFA._padded_hd(hd) == {24: 32, 96: 128}[hd]


def test_flash_head_dims_past_128_name_the_remainder():
    """Up to 128 a head_dim without an instance pads to the next one;
    past 128 none pads: every hd runs the split route as it is."""
    assert [TFA._padded_hd(h) for h in (1, 8, 16, 17, 48, 80, 128)] == [
        16, 16, None, 32, 64, 128, None]
    for hd in (129, 160, 250, 256, 320, 1000):
        assert TFA._padded_hd(hd) is None and TFA._wide(hd)
    assert not TFA._wide(128)
    with pytest.raises(ValueError):
        TFA._padded_hd(0)


def _jax_attention(q, k, v, causal):
    """Plain attention in JAX, [B, T, nh, hd] float32."""
    s = jnp.einsum("bqnh,bknh->bnqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        T = q.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -jnp.inf)
    return jnp.einsum("bnqk,bknh->bqnh", jax.nn.softmax(s, -1), v)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [160, 256, 320])
def test_flash_wide_head_dims_match_jax(hd, causal):
    """The wrappers past 128 (the plain versions on CPU tensors) against
    JAX's interpret-mode kernel at hd 256 and plain JAX attention at 160
    and 320: output to 2e-5, gradients to 3e-4."""
    rng = np.random.default_rng(hd)
    q, k, v, w = (rng.standard_normal((1, 128, 2, hd)).astype(np.float32)
                  for _ in range(4))
    if hd % 128 == 0:
        jf = lambda q, k, v: PK.flash_attention(  # noqa: E731
            q, k, v, causal=causal, block_q=64, block_k=64)
    else:
        jf = lambda q, k, v: _jax_attention(q, k, v, causal)  # noqa: E731
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    want = jf(*args)
    jg = jax.grad(lambda q, k, v: jnp.sum(jf(q, k, v) * w),
                  argnums=(0, 1, 2))(*args)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = TFA.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4,
                                   rtol=3e-4)


def test_decode_instances_cover_every_head_dim():
    """Every hd in 1..128 runs the power-of-two instance at or above it
    (8 at least); the 16-byte-vector instance where hd is a whole number
    of 16-byte cache vectors, else the scalar one; the split plan tiles
    by the instance's width. Past 128 the split route: column blocks of
    128, element loads, the plan of the HD-128 instance."""
    for hd in range(1, 129):
        for esz in (2, 4):
            inst, vec = CK._decode_instance(hd, esz)
            assert inst >= max(hd, 8) and inst & (inst - 1) == 0
            assert inst == 8 or inst // 2 < hd
            assert vec == (hd * esz % 16 == 0)
            chunk, nsplit = CK._decode_split(1024, hd, esz)
            assert chunk * nsplit >= 1024
            assert chunk % (4 * 128 * (16 // esz) // inst) == 0
    assert CK._decode_split(1024, 64, 2) == CK._decode_split(1024, 48, 2)
    for hd in (129, 160, 256, 320, 1000):
        for esz in (2, 4):
            assert CK._decode_instance(hd, esz) == (128, False)
            chunk, nsplit = CK._decode_split(1024, hd, esz)
            assert chunk * nsplit >= 1024 and nsplit <= 64
            assert (chunk, nsplit) == CK._decode_split(1024, 128, esz)
    with pytest.raises(ValueError):
        CK._decode_instance(0, 2)


@pytest.mark.parametrize("D", WIDE)
def test_ln_plans_give_wide_rows_an_instance(D):
    """The forward keeps the block-a-row instance while its float32 row
    fits a block's shared memory (opted in past 48 KB) and takes the
    two-pass instance past it; the backward's block a row loops over the
    row in chunks past 2048 columns. Neither raises."""
    fwd = TFL.fused_ln_plan(D)
    assert fwd == (TFL.ROW_SMEM if D * 4 <= TFL._FWD_SMEM_MAX
                   else TFL.ROW_TWO_PASS)
    assert TFL.ln_bwd_plan(D) == (TFL.ROW_SMEM if D <= TFL._MAX_D
                                  else TFL.ROW_TWO_PASS)
    assert TFL.fused_ln_plan(64000) == TFL.ROW_TWO_PASS


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", WIDE)
def test_logits_head_plan_gives_wide_rows_an_instance(D, esz):
    """Where a group's normed rows fit beside the weight ring, the
    shared-memory instance as before; past that the streamed instance:
    the rows normalised once (the fused-LN kernel) and streamed through
    the ring beside the weight, whose block fits 227 KB at any D."""
    for B in (1, 8, 96):
        plan = CK.logits_head_plan(B, D, 50304, esz, 132)
        pad = 16 // esz
        fits = 16 * ((-(-D // 32) * 32) + pad) * esz + \
            4 * 32 * (128 + pad) * esz <= 227 * 1024
        assert plan["stream_rows"] == (not fits)
        assert plan["smem"] <= 227 * 1024 and plan["bps"] >= 1
        rows = [r for gi in range(plan["groups"])
                for r in range(gi * plan["bm"], (gi + 1) * plan["bm"])
                if r < B]
        assert rows == list(range(B))


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,vp", [(2048, 51200), (960, 30720), (1, 128),
                                  (300, 1024), (20000, 50304)])
def test_ce_plan_covers_the_vocab_in_one_wave(n, vp, esz):
    """The CE forward's plan (the kernel takes any D and head stride, so
    the plan depends only on rows and columns): the vocab ranges take
    every tile exactly once, none empty; the blocks make at most one wave
    of 132 unless the row tiles alone need more."""
    plan = TCE.ce_fwd_plan(n, vp, esz, 132)
    bn, per, ns = plan["bn"], plan["tiles_per_split"], plan["nsplit"]
    assert bn == {2: 256, 4: 128}[esz]
    assert plan["row_tiles"] == -(-n // 128)
    vtiles = -(-vp // bn)
    tiles = [t for y in range(ns) for t in range(y * per,
                                                  min(vtiles, (y + 1) * per))]
    assert tiles == list(range(vtiles))
    assert (ns - 1) * per < vtiles                 # no empty range
    assert plan["row_tiles"] * ns <= max(132, plan["row_tiles"])
    if (n, vp, esz) == (2048, 51200, 2):
        assert (plan["row_tiles"], ns) == (16, 8)
