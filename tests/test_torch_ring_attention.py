"""The port's ring attention (``paddle_tpu_torch/parallel/ring_attention.py``)
against the JAX package's ``ring_attention`` under ``shard_map`` on the
conftest's 8-device CPU mesh and against plain full-sequence float32
attention: cp 2 and 4 gloo ranks on the CPU (``torch_dist_worker``), causal
and not, output within 1e-5 and the gradients through the reverse ring
within 1e-4 (``tests/test_ring_attention.py``'s bars); and the ring as the
cp line of a dp x cp mesh."""
import math
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.parallel.parallelize import shard_map_compat
from paddle_tpu.parallel.ring_attention import ring_attention as j_ring

import torch_dist_worker as W

CASES = ((True, False), (False, False), (True, True), (False, True))
B, NH, HD = 2, 2, 16


def _inputs(cp, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, 8 * cp, NH, HD)).astype(np.float32)
            for _ in range(4)]


def plain(q, k, v, causal):
    """Full-sequence float32 attention (the reference test's
    ``ref_attention``)."""
    T = q.shape[1]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -1e30)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)


def jax_ring(cp, causal):
    mesh = Mesh(np.array(jax.devices()[:cp]), ("cp",))
    return shard_map_compat(partial(j_ring, axis_name="cp", causal=causal),
                            mesh, in_specs=(P(None, "cp"),) * 3,
                            out_specs=P(None, "cp"))


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """cp -> (inputs, each rank's results): one spawned world a cp, every
    case in it."""
    out = {}
    for cp in (2, 4):
        ins = _inputs(cp, seed=cp)
        out[cp] = (ins, W.spawn(W.ring_worker, cp, *ins, CASES,
                                out_dir=str(tmp_path_factory.mktemp("r")),
                                timeout=120))
    return out


def _cat(ranks, fn):
    return np.concatenate([fn(r) for r in sorted(
        ranks, key=lambda r: r["index"])], axis=1)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax_ring_and_plain(rings, cp, causal):
    (q, k, v, _), ranks = rings[cp]
    got = _cat(ranks, lambda r: r[(causal, False)]["o"])
    ref = np.asarray(jax.jit(jax_ring(cp, causal))(q, k, v))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(plain(q, k, v, causal)),
                               atol=1e-5, rtol=1e-5)
    # the grads-on call returns the same forward
    np.testing.assert_array_equal(
        got, _cat(ranks, lambda r: r[(causal, True)]["o"]))


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_through_the_reverse_ring(rings, cp, causal):
    (q, k, v, w), ranks = rings[cp]
    f = jax_ring(cp, causal)
    g_ring = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w),
                              argnums=(0, 1, 2)))(q, k, v)
    g_plain = jax.grad(lambda q, k, v: jnp.sum(plain(q, k, v, causal) * w),
                       argnums=(0, 1, 2))(q, k, v)
    for i in range(3):
        got = _cat(ranks, lambda r: r[(causal, True)]["grads"][i])
        for ref in (g_ring[i], g_plain[i]):
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4,
                                       rtol=1e-4)


def test_ring_on_a_mesh_line(tmp_path):
    """Four ranks as a dp 2 x cp 2 mesh: each dp row runs its own ring over
    its cp line (``mesh.group("cp")``), both equal to plain attention."""
    q, k, v, w = _inputs(2, seed=9)
    ranks = W.spawn(W.ring_worker, 4, q, k, v, w, ((True, True),),
                    (("dp", 2), ("cp", 2)), out_dir=str(tmp_path),
                    timeout=120)
    g_plain = jax.grad(lambda q, k, v: jnp.sum(plain(q, k, v, True) * w),
                       argnums=(0, 1, 2))(q, k, v)
    for row in (ranks[:2], ranks[2:]):
        got = _cat(row, lambda r: r[(True, True)]["o"])
        np.testing.assert_allclose(got, np.asarray(plain(q, k, v, True)),
                                   atol=1e-5, rtol=1e-5)
        for i in range(3):
            np.testing.assert_allclose(
                _cat(row, lambda r: r[(True, True)]["grads"][i]),
                np.asarray(g_plain[i]), atol=1e-4, rtol=1e-4)
