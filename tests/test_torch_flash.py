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
    x = torch.zeros((1, 8, 1, 32))
    with pytest.raises(NotImplementedError, match="ERNIE"):
        TFA.flash_attention(x, x, x, bias=torch.zeros((1, 1, 8, 8)))
