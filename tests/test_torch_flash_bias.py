"""The bias form of the port's flash attention against the JAX Pallas
kernels, on the CPU.

On CPU tensors ``paddle_tpu_torch.ops.flash_attention(bias=)`` runs the
plain versions of its three kernels with the bias; here they are held
against ``paddle_tpu.ops.pallas_kernels.flash_attention(bias=)`` in
interpret mode, on the three bias shapes of ``tests/test_pallas.py:69-91``
(per head, per batch row, the row-broadcast padding form). The CUDA bias
kernels are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 8).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as PK
from paddle_tpu_torch.ops import flash_attention as TFA

B, T, NH, HD = 2, 256, 2, 64
PAD = -0.5 * float(np.finfo(np.float32).max)   # ERNIE's padding value


def _qkvw(seed, t=T, hd=HD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, NH, hd)).astype(np.float32)
            for _ in range(4)]


def _bias(kind, seed, t=T):
    rng = np.random.default_rng(seed)
    if kind == "full":
        return rng.standard_normal((B, NH, t, t)).astype(np.float32)
    if kind == "batch":
        return rng.standard_normal((B, 1, t, t)).astype(np.float32)
    m = np.zeros((B, 1, 1, t), np.float32)       # padding: last quarter
    m[..., 3 * t // 4:] = -1e9
    return m


def _jax_and_port(q, k, v, w, bias, causal, block=128):
    """(JAX output, JAX grads, port output, port grads, port bias grad)
    of sum(flash(q, k, v) * w)."""
    jb = jnp.asarray(bias)

    def jf(q, k, v):
        return PK.flash_attention(q, k, v, causal=causal, bias=jb,
                                  block_q=block, block_k=block)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jf(jq, jk, jv)
    jg = jax.grad(lambda q, k, v: jnp.sum(jf(q, k, v) * w),
                  argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tb = torch.from_numpy(bias).requires_grad_()
    got = TFA.flash_attention(tq, tk, tv, causal=causal, bias=tb)
    (got * torch.from_numpy(w)).sum().backward()
    return (np.asarray(want), [np.asarray(g) for g in jg],
            got.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)],
            tb.grad)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("kind", ["full", "batch", "padmask"])
def test_bias_forward_and_grads_match_jax(kind, causal):
    """f32: output to 2e-5 (tests/test_pallas.py:90), dq, dk, dv to 3e-4;
    the bias's gradient is zero, as the reference's cotangent."""
    q, k, v, w = _qkvw(0)
    want, jg, got, tg, dbias = _jax_and_port(q, k, v, w, _bias(kind, 1),
                                             causal)
    assert got.shape == (B, T, NH, HD)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=3e-4)
    assert dbias is None or not dbias.any()


def test_bias_gradient_is_none_or_zero():
    """No gradient flows to the bias: None when it asks for none, zeros
    of its shape when it does (JAX's zero cotangent)."""
    q, k, v, _w = [torch.from_numpy(x) for x in _qkvw(2, t=64)]
    q.requires_grad_()
    bias = torch.from_numpy(_bias("batch", 3, t=64))
    TFA.flash_attention(q, k, v, causal=False, bias=bias).sum().backward()
    assert bias.grad is None and q.grad is not None
    bias.requires_grad_()
    TFA.flash_attention(q, k, v, causal=False, bias=bias).sum().backward()
    assert bias.grad.shape == bias.shape and not bias.grad.any()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_padding_bias_with_a_whole_key_tile_padded_stays_finite(causal):
    """ERNIE's padding value (-0.5 f32 max) over a whole key tile —
    batch row 0's first 64 keys, batch row 1's keys 64..127 and its tail —
    with 64-key blocks on the JAX side, so its online softmax meets a
    wholly padded first block too: output and gradients finite and equal
    to JAX's (causal rows 0..63 of batch row 0 see only padded keys, and
    their lse is -0.5 f32 max)."""
    q, k, v, w = _qkvw(4)
    m = np.zeros((B, 1, 1, T), np.float32)
    m[0, ..., :64] = PAD
    m[1, ..., 64:128] = PAD
    m[1, ..., 230:] = PAD
    want, jg, got, tg, _ = _jax_and_port(q, k, v, w, m, causal, block=64)
    for x in [got] + tg:
        assert np.isfinite(x).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=3e-4)
    _o, lse = TFA.flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal, bias=torch.from_numpy(m)[:, 0])
    assert np.isfinite(lse.numpy()).all()
    if causal:
        assert (lse[0, :, :64] == PAD).all()


def test_kernel_form_folds_as_jax():
    """The public [B, nh | 1, SQ, T] bias folds into the kernels' [BB, SQ,
    T]: a per-head bias with every head equal, a per-batch bias and its
    row-broadcast form give the same result as the expanded square."""
    q, k, v, _w = [torch.from_numpy(x) for x in _qkvw(5, t=64)]
    row = torch.from_numpy(_bias("padmask", 6, t=64))            # [B,1,1,T]
    square = row.expand(B, 1, 64, 64).contiguous()
    heads = row.expand(B, NH, 64, 64).contiguous()
    want = TFA.flash_attention(q, k, v, causal=False, bias=heads)
    for bias in (row, square):
        torch.testing.assert_close(
            TFA.flash_attention(q, k, v, causal=False, bias=bias), want,
            atol=1e-6, rtol=1e-6)
    o, _lse = TFA.flash_fwd(q, k, v, False, bias=row.reshape(B, 1, 64))
    torch.testing.assert_close(o, want, atol=1e-6, rtol=1e-6)


def test_head_dim_8_with_bias_matches_jax():
    """ERNIE_TINY's head_dim 8 with the padding bias: output to 2e-5 and
    gradients to 3e-4 against JAX."""
    q, k, v, w = _qkvw(7, t=64, hd=8)
    m = np.zeros((B, 1, 1, 64), np.float32)
    m[:, ..., 40:] = PAD
    want, jg, got, tg, _ = _jax_and_port(q, k, v, w, m, False)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=3e-4)


def test_bad_bias_shapes_raise():
    """A head dim other than 1 or nh raises ValueError, as JAX's does;
    so do a query length other than 1 or T and a batch or key mismatch."""
    x = torch.zeros((B, 64, NH, 16))
    with pytest.raises(ValueError, match="head dim 3"):
        TFA.flash_attention(x, x, x, bias=torch.zeros((B, 3, 64, 64)))
    with pytest.raises(ValueError, match="bias head dim 3"):
        PK.flash_attention(jnp.zeros((B, 64, NH, 16)),
                           jnp.zeros((B, 64, NH, 16)),
                           jnp.zeros((B, 64, NH, 16)),
                           bias=jnp.zeros((B, 3, 64, 64)))
    for shape in ((B, 1, 8, 64), (1, 1, 1, 64), (B, 1, 1, 32),
                  (B, 1, 64)):
        with pytest.raises(ValueError, match="bias"):
            TFA.flash_attention(x, x, x, bias=torch.zeros(shape))


def test_kernel_bias_contract():
    """The kernels' contract on a bias, checked before any launch:
    float32, [B or B·nh, 1 or T, T], contiguous; it returns how many heads
    share a bias row and the bias's query rows."""
    ptr, heads, rows = TFA._check_bias(torch.zeros((B, 1, 64)), B, 64, NH,
                                       "t")
    assert ptr is not None and (heads, rows) == (NH, 1)
    assert TFA._check_bias(torch.zeros((B * NH, 64, 64)), B, 64, NH,
                           "t")[1:] == (1, 64)
    assert TFA._check_bias(None, B, 64, NH, "t") == (None, 1, 1)
    with pytest.raises(TypeError, match="float32"):
        TFA._check_bias(torch.zeros((B, 1, 64), dtype=torch.bfloat16), B,
                        64, NH, "t")
    for bad in (torch.zeros((3, 1, 64)), torch.zeros((B, 2, 64)),
                torch.zeros((B, 1, 63)), torch.zeros((B, 1, 128))[..., ::2]):
        with pytest.raises(ValueError):
            TFA._check_bias(bad, B, 64, NH, "t")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bias_dkv_with_di_matches_without_and_jax(causal):
    """With the row-broadcast padding bias: dQ's D (``return_di=True``)
    against ``jnp.sum(do * o, -1)`` to 1e-5, ``flash_bwd_dkv_plain(...,
    di=D)`` equal to the call without it bitwise, and to JAX's
    interpret-mode ``_bwd`` with the bias to 3e-4."""
    q, k, v, do = _qkvw(21)
    bias = _bias("padmask", 0)                     # [B, 1, 1, T]
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(  # noqa
        B * NH, T, HD)
    jq, jk, jv, jdo = (to_bh(x) for x in (q, k, v, do))
    jb = jnp.asarray(bias).reshape(B, 1, T)
    scale = 1.0 / np.sqrt(HD)
    jo, jlse = PK._fwd(jq, jk, jv, jb, causal, scale, 128, 128)
    o_t = torch.from_numpy(np.asarray(jo).reshape(B, NH, T, HD)
                           .transpose(0, 2, 1, 3).copy())
    lse_t = torch.from_numpy(np.asarray(jlse)[..., 0].reshape(B, NH, T)
                             .copy())
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = torch.from_numpy(bias).reshape(B, 1, T)  # the kernels' form
    _dq, di = TFA.flash_bwd_dq_plain(tq, tk, tv, o_t, lse_t, tdo, causal,
                                     scale, tb, return_di=True)
    np.testing.assert_allclose(
        di.numpy(), np.asarray(jnp.sum(jdo * jo, -1)).reshape(B, NH, T),
        atol=1e-5, rtol=1e-5)
    with_di = TFA.flash_bwd_dkv_plain(tq, tk, tv, o_t, lse_t, tdo, causal,
                                      scale, tb, di=di)
    for a, b in zip(with_di, TFA.flash_bwd_dkv_plain(
            tq, tk, tv, o_t, lse_t, tdo, causal, scale, tb)):
        assert torch.equal(a, b)
    _jdq, jdk, jdv = PK._bwd(jq, jk, jv, jo, jlse, jdo, jb, causal, scale,
                             128, 128)
    for got, want in zip(with_di, (jdk, jdv)):
        want = np.asarray(want).reshape(B, NH, T, HD).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=3e-4)
