"""The port's flash attention against the JAX Pallas kernels, on the CPU.

On CPU tensors ``paddle_tpu_torch.ops.flash_attention`` runs the plain
versions of its three kernels; here they are held against
``paddle_tpu.ops.pallas_kernels.flash_attention`` in interpret mode (as
``tests/test_pallas.py`` runs it), with ``block_q = block_k = 64`` so
that the JAX side walks several blocks and skips the causal ones. The
CUDA kernels are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as PK
from paddle_tpu_torch.ops import flash_attention as TFA


def _inputs(seed, t, hd, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, t, 2, hd)).astype(np.float32)
            for _ in range(n)]


def _jax_flash(causal):
    return lambda q, k, v: PK.flash_attention(q, k, v, causal=causal,
                                              block_q=64, block_k=64)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("t", [128, 256])
def test_forward_and_grads_match_jax(causal, t, hd):
    """f32: output to 2e-5 (tests/test_pallas.py:37), gradients through
    ``_Flash`` to 3e-4 (:57)."""
    q, k, v, w = _inputs(0, t, hd, n=4)
    jf = _jax_flash(causal)
    want = jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = jax.grad(lambda q, k, v: jnp.sum(jf(q, k, v) * w),
                  argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = TFA.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (2, t, 2, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4,
                                   rtol=3e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_head_dim_16_matches_jax(causal):
    """head_dim 16 (GPT_TINY's), which the kernels now take: output to
    2e-5 and gradients to 3e-4, as at the other head_dims."""
    q, k, v, w = _inputs(16, 128, 16, n=4)
    jf = _jax_flash(causal)
    want = jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = jax.grad(lambda q, k, v: jnp.sum(jf(q, k, v) * w),
                  argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = TFA.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4,
                                   rtol=3e-4)


def test_head_dim_8_padding_is_exact():
    """head_dim 8 (ERNIE_TINY's) runs the 16 instance on zero-padded
    inputs: pad -> plain -> slice equals the plain path at 8 (forward,
    lse and the three gradients) and JAX's flash at 8, with the true
    scale 1/sqrt(8)."""
    q, k, v, do = _inputs(8, 128, 8, n=4)
    scale = 1.0 / np.sqrt(8.0)
    tq, tk, tv, tdo = [torch.from_numpy(x) for x in (q, k, v, do)]
    pad = [TFA.pad_head_dim(x, 16) for x in (tq, tk, tv, tdo)]
    assert pad[0].shape == (2, 128, 2, 16) and pad[0].is_contiguous()
    assert torch.equal(pad[0][..., 8:], torch.zeros(2, 128, 2, 8))
    o8, lse8 = TFA.flash_fwd_plain(tq, tk, tv, True, scale)
    o16, lse16 = TFA.flash_fwd_plain(*pad[:3], True, scale)
    np.testing.assert_allclose(o16[..., :8].numpy(), o8.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse16.numpy(), lse8.numpy(), atol=1e-6)
    assert torch.equal(o16[..., 8:], torch.zeros_like(o16[..., 8:]))
    po = TFA.pad_head_dim(o8, 16)
    dq8 = TFA.flash_bwd_dq_plain(tq, tk, tv, o8, lse8, tdo, True, scale)
    dq16 = TFA.flash_bwd_dq_plain(*pad[:3], po, lse8, pad[3], True, scale)
    np.testing.assert_allclose(dq16[..., :8].numpy(), dq8.numpy(),
                               atol=1e-6)
    for a8, a16 in zip(
            TFA.flash_bwd_dkv_plain(tq, tk, tv, o8, lse8, tdo, True, scale),
            TFA.flash_bwd_dkv_plain(*pad[:3], po, lse8, pad[3], True,
                                    scale)):
        np.testing.assert_allclose(a16[..., :8].numpy(), a8.numpy(),
                                   atol=1e-6)
    want = _jax_flash(True)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o16[..., :8].numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_lse_matches_jax():
    """The forward's lse [B, nh, T] against the Pallas kernel's
    lane-replicated [BH, T, 128] (one lane kept, as the vjp keeps it)."""
    q, k, v = _inputs(1, 128, 64)
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
        4, 128, 64)
    _o, lse = PK._fwd(to_bh(q), to_bh(k), to_bh(v), None, True, 0.125, 64,
                      64)
    _o2, got = TFA.flash_fwd(*[torch.from_numpy(x) for x in (q, k, v)])
    assert got.shape == (2, 2, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.reshape(4, 128).numpy(),
                               np.asarray(lse)[..., 0], atol=2e-5)


def test_bf16_matches_jax():
    """bf16 inputs: both sides round P (and dS for dQ) to bf16 at the same
    points but sum in another order, so results may differ by one bf16
    ulp of the output: 1e-2 × the largest |value| (forward and grads)."""
    q, k, v, w = _inputs(2, 128, 64, n=4)
    jf = _jax_flash(True)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jf(*jb)
    jg = jax.grad(lambda q, k, v: jnp.sum(
        jf(q, k, v).astype(jnp.float32) * w), argnums=(0, 1, 2))(*jb)
    tb = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
          for x in (q, k, v)]
    got = TFA.flash_attention(*tb)
    assert got.dtype == torch.bfloat16
    (got.float() * torch.from_numpy(w)).sum().backward()
    for a, b in [(got.detach(), want)] + [(t.grad, g)
                                          for t, g in zip(tb, jg)]:
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b,
                                   atol=1e-2 * np.abs(b).max())


def test_packed_qkv_slices_and_block_args():
    """q, k, v sliced out of one packed [B, T, 3, nh, hd] tensor (as the
    model does) give the same result as contiguous copies, for any
    block_q/block_k."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 3, 2, 32))
                           .astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    a = TFA.flash_attention(q, k, v)
    b = TFA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            block_q=16, block_k=32)
    assert torch.equal(a, b)


def test_bias_refused():
    """A bias the kernels do not take is refused: a head dim other than 1
    or nh, a query length other than 1 or T (the bias form itself is
    held against JAX in tests/test_torch_flash_bias.py)."""
    x = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="head dim"):
        TFA.flash_attention(x, x, x, bias=torch.zeros((1, 3, 8, 8)))
    with pytest.raises(ValueError, match="bias"):
        TFA.flash_attention(x, x, x, bias=torch.zeros((1, 1, 4, 8)))


def _jax_bwd_inputs(seed, causal, bias=None, t=128, hd=64):
    """q, k, v, dO (numpy [B, T, nh, hd]) and the JAX forward's o and lse
    at them, in both layouts: (numpy inputs, JAX [BH, T, hd] inputs with
    o and the lane-replicated lse, port o [B, T, nh, hd] and lse [B, nh,
    T])."""
    q, k, v, do = _inputs(seed, t, hd, n=4)
    B, nh = q.shape[0], q.shape[2]
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(  # noqa
        B * nh, t, hd)
    jb = [to_bh(x) for x in (q, k, v, do)]
    o, lse = PK._fwd(jb[0], jb[1], jb[2], bias, causal, 1.0 / np.sqrt(hd),
                     64, 64)
    o_t = torch.from_numpy(np.asarray(o).reshape(B, nh, t, hd)
                           .transpose(0, 2, 1, 3).copy())
    lse_t = torch.from_numpy(np.asarray(lse)[..., 0].reshape(B, nh, t)
                             .copy())
    return (q, k, v, do), (*jb, o, lse), o_t, lse_t


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_di_matches_jax(causal):
    """D = rowsum(dO * o) as ``flash_bwd_dq_plain(return_di=True)`` gives
    it ([B, nh, T] float32) against ``jnp.sum(do * o, -1)`` on the
    reference's o, to 1e-5; the dq beside it is the call without
    ``return_di``, bitwise."""
    (q, k, v, do), (_q, _k, _v, jdo, jo, _lse), o_t, lse_t = \
        _jax_bwd_inputs(9, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    dq, di = TFA.flash_bwd_dq_plain(tq, tk, tv, o_t, lse_t, tdo, causal,
                                    return_di=True)
    assert di.shape == (2, 2, 128) and di.dtype == torch.float32
    assert di.is_contiguous()
    want = np.asarray(jnp.sum(jdo * jo, -1)).reshape(2, 2, 128)
    np.testing.assert_allclose(di.numpy(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(dq, TFA.flash_bwd_dq_plain(tq, tk, tv, o_t, lse_t,
                                                  tdo, causal))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_dkv_with_di_matches_without_and_jax(causal):
    """``flash_bwd_dkv_plain(..., di=D)`` with dQ's D equals the call
    without it bitwise (the kernels' route: dK/dV reads D, never o), and
    JAX's interpret-mode ``_bwd`` on the same inputs to 3e-4
    (tests/test_pallas.py:57)."""
    (q, k, v, do), jargs, o_t, lse_t = _jax_bwd_inputs(10, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    _dq, di = TFA.flash_bwd_dq_plain(tq, tk, tv, o_t, lse_t, tdo, causal,
                                     return_di=True)
    with_di = TFA.flash_bwd_dkv_plain(tq, tk, tv, o_t, lse_t, tdo, causal,
                                      di=di)
    without = TFA.flash_bwd_dkv_plain(tq, tk, tv, o_t, lse_t, tdo, causal)
    for a, b in zip(with_di, without):
        assert torch.equal(a, b)
    jq, jk, jv, jdo, jo, jlse = jargs
    _jdq, jdk, jdv = PK._bwd(jq, jk, jv, jo, jlse, jdo, None, causal,
                             0.125, 64, 64)
    for got, want in zip(with_di, (jdk, jdv)):
        want = np.asarray(want).reshape(2, 2, 128, 64).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=3e-4)


def test_di_contract():
    """The dK/dV kernel's contract on D, checked before any launch (here
    on CPU tensors): float32, [B, nh, T], contiguous."""
    TFA._check_di(torch.zeros((2, 3, 64)), 2, 3, 64, "t")
    with pytest.raises(TypeError, match="float32"):
        TFA._check_di(torch.zeros((2, 3, 64), dtype=torch.bfloat16), 2, 3,
                      64, "t")
    for bad in (torch.zeros((2, 3, 63)), torch.zeros((3, 2, 64)),
                torch.zeros((2, 3, 128))[..., ::2], torch.zeros((6, 64))):
        with pytest.raises(ValueError, match="di"):
            TFA._check_di(bad, 2, 3, 64, "t")
