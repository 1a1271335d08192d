"""The port's vocab-chunked CE (``paddle_tpu_torch/ops/chunked_ce.py``)
against the JAX package's (``paddle_tpu/ops/pallas_kernels.py:481-777``),
on the CPU: the plain forward sweep against the Pallas forward kernel in
interpret mode and its lax sweep, and ``chunked_lm_loss`` with its
gradients in both head layouts, with bias, ``valid``, a padded vocab and
padded rows. Tolerances are ``tests/test_memory_levers.py``'s (:29-83)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as PK
from paddle_tpu_torch.ops import chunked_ce as TCE


@pytest.mark.parametrize("vocab", [512, 500], ids=["V512", "V500-padded"])
def test_ce_fwd_plain_matches_pallas_and_lax(vocab):
    """n=32, D=8, a 512-column head in chunks of 128 (with V=500 the last
    12 columns are padding, masked): lse and gold within 1e-4 of the Pallas
    kernel (interpret mode) and of the lax sweep."""
    rng = np.random.default_rng(1)
    n, D, vp, vc = 32, 8, 512, 128
    x = rng.standard_normal((n, D)).astype(np.float32)
    head = (rng.standard_normal((D, vp)) * 0.1).astype(np.float32)
    labels = rng.integers(0, vocab, n).astype(np.int32)
    jx, jh, jl = jnp.asarray(x), jnp.asarray(head), jnp.asarray(labels)
    want_p = PK._ce_fwd_pallas(jx, jh, None, jl, vc, vocab)
    want_l = PK._ce_fwd_lax(jx, jh, None, jl, vc, vocab, "dv")
    got = TCE.ce_fwd(torch.from_numpy(x), torch.from_numpy(head), None,
                     torch.from_numpy(labels), vc, vocab)
    for want in (want_p, want_l):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-6)


def test_ce_fwd_plain_with_bias_matches_pallas():
    """The gold logit includes the bias term (pallas_kernels.py:577)."""
    rng = np.random.default_rng(2)
    n, D, vp, vc, vocab = 16, 8, 256, 128, 250
    x = rng.standard_normal((n, D)).astype(np.float32)
    head = (rng.standard_normal((D, vp)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(vp).astype(np.float32)
    labels = rng.integers(0, vocab, n).astype(np.int32)
    want = PK._ce_fwd_pallas(jnp.asarray(x), jnp.asarray(head),
                             jnp.asarray(bias), jnp.asarray(labels), vc,
                             vocab)
    got = TCE.ce_fwd(torch.from_numpy(x), torch.from_numpy(head),
                     torch.from_numpy(bias), torch.from_numpy(labels), vc,
                     vocab)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-6)


def _ref_ce(x, head, labels):
    logits = (x @ head).astype(jnp.float32)
    lse = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, labels[:, None], -1)[:, 0]
    return jnp.sum(lse - gold)


_REF = {}


def _reference(V):
    """The unchunked JAX loss and its gradients, once per vocab size."""
    if V not in _REF:
        rng = np.random.default_rng(0)
        n, D = (16 if V > 10000 else 33), 16
        x = rng.standard_normal((n, D)).astype(np.float32)
        head = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
        labels = rng.integers(0, V, n).astype(np.int32)
        r, (gx, gh) = jax.value_and_grad(_ref_ce, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(head), jnp.asarray(labels))
        _REF[V] = (x, head, labels, float(r), np.asarray(gx),
                   np.asarray(gh))
    return _REF[V]


@pytest.mark.parametrize("V", [1000, 50257])
@pytest.mark.parametrize("chunk", [128, 1024, "V"])
def test_chunked_lm_loss_matches_jax(V, chunk):
    """"dv" head, chunk sizes that do and do not divide V plus chunk == V,
    row_chunk=8 (padded rows at n=33): the loss to 1e-5 relative against
    the unchunked reference and to JAX's chunked_lm_loss, gradients within
    1e-5 / 1e-4."""
    x, head, labels, r, rgx, rgh = _reference(V)
    vc = V if chunk == "V" else chunk
    jf = lambda x, h: PK.chunked_lm_loss(x, h, jnp.asarray(labels),
                                         vocab_chunk=vc, row_chunk=8)
    jc = float(jf(jnp.asarray(x), jnp.asarray(head)))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    c = TCE.chunked_lm_loss(tx, th, torch.from_numpy(labels),
                            vocab_chunk=vc, row_chunk=8)
    c.backward()
    for want in (r, jc):
        assert abs(c.item() - want) / max(1.0, abs(want)) < 1e-5, vc
    np.testing.assert_allclose(tx.grad.numpy(), rgx, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(th.grad.numpy(), rgh, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [None, False],
                         ids=["default", "sweep"])
def test_chunked_lm_loss_vd_bias_valid_matches_jax(use_pallas):
    """"vd" head (a tied embedding), bias and ``valid``, vocab 301 in
    chunks of 96 (padded), rows 21 in chunks of 10 (padded): the loss
    within 1e-4 and the gradients of x, head and bias within 1e-5 / 1e-4
    of JAX's chunked_lm_loss."""
    rng = np.random.default_rng(2)
    n, D, V = 21, 12, 301
    x = rng.standard_normal((n, D)).astype(np.float32)
    head_t = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, n).astype(np.int32)
    valid = rng.integers(0, 2, n).astype(bool)

    def jf(x, ht, b):
        return PK.chunked_lm_loss(x, ht, jnp.asarray(labels), bias=b,
                                  valid=jnp.asarray(valid), vocab_chunk=96,
                                  row_chunk=10, head_layout="vd")

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(head_t), jnp.asarray(bias))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, head_t, bias)]
    tv = TCE.chunked_lm_loss(ts[0], ts[1], torch.from_numpy(labels),
                             bias=ts[2], valid=torch.from_numpy(valid),
                             vocab_chunk=96, row_chunk=10, head_layout="vd",
                             use_pallas=use_pallas)
    tv.backward()
    assert abs(tv.item() - float(jv)) < 1e-4
    for t, w in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_labels_are_clipped_like_jax():
    """Out-of-range labels clip to [0, V-1] before the sweep."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    head = (rng.standard_normal((8, 40)) * 0.3).astype(np.float32)
    labels = np.array([-3, 0, 39, 40, 1000, 7], np.int32)
    want = float(PK.chunked_lm_loss(jnp.asarray(x), jnp.asarray(head),
                                    jnp.asarray(labels), vocab_chunk=16))
    got = TCE.chunked_lm_loss(torch.from_numpy(x), torch.from_numpy(head),
                              torch.from_numpy(labels), vocab_chunk=16)
    assert abs(got.item() - want) < 1e-5


def test_bf16_head_gradient_adds_row_chunks_like_jax():
    """bf16 rows and head in 4 row chunks: each chunk's head gradient is
    cast to bf16 and the four are added in bf16, last chunk first, as
    JAX's transposed scan adds them — the port's gradient is bitwise that
    sum of its own per-chunk gradients, and within one bf16 rounding of
    the largest element of JAX's."""
    rng = np.random.default_rng(4)
    n, D, V, rc = 64, 16, 200, 16
    x = rng.standard_normal((n, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 0.2).astype(np.float32)
    labels = rng.integers(0, V, n).astype(np.int32)
    jg = jax.grad(lambda h: PK.chunked_lm_loss(
        jnp.asarray(x, jnp.bfloat16), h, jnp.asarray(labels),
        vocab_chunk=64, row_chunk=rc))(jnp.asarray(head, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16()
    th = torch.from_numpy(head).bfloat16().requires_grad_()
    tl = torch.from_numpy(labels)
    TCE.chunked_lm_loss(tx, th, tl, vocab_chunk=64, row_chunk=rc).backward()
    assert th.grad.dtype == torch.bfloat16
    parts = []
    for j in range(0, n, rc):
        h = torch.from_numpy(head).bfloat16().requires_grad_()
        TCE.chunked_lm_loss(tx[j:j + rc], h, tl[j:j + rc],
                            vocab_chunk=64).backward()
        parts.append(h.grad)
    acc = parts[-1]
    for part in parts[-2::-1]:
        acc = acc + part
    assert torch.equal(th.grad, acc)
    want = np.asarray(jg, np.float32)
    np.testing.assert_allclose(th.grad.float().numpy(), want,
                               atol=np.abs(want).max() * 2 ** -7)
