"""The port's AdamW against the JAX package, on the CPU: the plain flat
sweep (``megakernel_adamw_flat_plain``, what ``megakernel_adamw_flat``
runs on CPU tensors) against the Pallas megakernel in interpret mode, and
``_adamw_update`` / ``_adamw_update_fused`` against JAX's, fed the same
scalars. The CUDA sweep is held bitwise against the plain one on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as PK
from paddle_tpu.parallel import parallelize as PZ
from paddle_tpu_torch.ops import cuda_kernels as CK
from paddle_tpu_torch.parallel import parallelize as TPZ

_MDT = {"f32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


def _sweep_inputs(jdt):
    rng = np.random.default_rng(3)
    n = 1000
    p, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    m, v = (np.asarray(jnp.asarray(x, jdt), np.float32) for x in (m, v))
    mask = rng.integers(0, 2, n).astype(np.float32)
    return p, g, m, v, mask


_SC = (1e-3, 0.7, 0.4, 0.2)                 # lr, scale, c1, c2
_HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _numpy_sweep(p, g, m, v, mask):
    """The sweep as numpy float32 ops, each rounded on its own (IEEE)."""
    f = np.float32
    lr, scale, c1, c2 = (f(x) for x in _SC)
    b1, b2, eps, wd = (_HP[k] for k in ("b1", "b2", "eps", "weight_decay"))
    gf = g * scale
    mf = f(b1) * m + f(1 - b1) * gf
    vf = f(b2) * v + (f(1 - b2) * gf) * gf
    u = (mf / c1) / (np.sqrt(vf / c2) + f(eps))
    return p - lr * (u + (f(wd) * mask) * p), mf, vf


def _torch_sweep(p, g, m, v, mask, tdt):
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    tm, tv = tm.to(tdt), tv.to(tdt)
    got = CK.megakernel_adamw_flat(
        tp, torch.from_numpy(g), tm, tv, torch.from_numpy(mask),
        *[torch.tensor(x, dtype=torch.float32) for x in _SC], **_HP)
    assert got[0] is tp and got[1] is tm and got[2] is tv   # in place
    assert tm.dtype == tdt and tv.dtype == tdt
    return got


@pytest.mark.parametrize("mdt", ["f32", "bf16"])
def test_plain_sweep_bitwise_vs_float32_ops(mdt):
    """The sweep is defined as float32 ops each rounded to nearest, no
    fused multiply-add — what the CUDA kernel computes with its _rn
    intrinsics. p, m and v bit for bit against numpy doing exactly that,
    with float32 and with bfloat16 moments (stored rounded to nearest
    even)."""
    jdt, tdt = _MDT[mdt]
    p, g, m, v, mask = _sweep_inputs(jdt)
    want = _numpy_sweep(p, g, m, v, mask)
    got = _torch_sweep(p, g, m, v, mask, tdt)
    want = [want[0]] + [np.asarray(jnp.asarray(x, jdt), np.float32)
                        for x in want[1:]]
    for a, b, name in zip(got, want, ("p", "m", "v")):
        np.testing.assert_array_equal(_np32(a), b, err_msg=name)


@pytest.mark.parametrize("mdt", ["f32", "bf16"])
def test_plain_sweep_vs_megakernel(mdt):
    """Against the Pallas megakernel in interpret mode. XLA on the CPU
    contracts b1*m + (1-b1)*g into one fused multiply-add (checked:
    fma(b1, m, (1-b1)*g) reproduces its m bit for bit), which the port's
    per-op rounding does not, so bitwise equality is impossible here. Each
    element agrees to 2^-22 of its own size, at least 2 float32 ulps (2^-7,
    at least 1 bf16 ulp, for moments stored in bf16, where a 1-ulp float32
    difference can flip the rounding); for m, of the larger of its size and
    its summands'
    |b1*m| + |(1-b1)*g*scale|, since the fused rounding differs by up to
    an ulp of the summands where they cancel."""
    jdt, tdt = _MDT[mdt]
    p, g, m, v, mask = _sweep_inputs(jdt)
    want = PK.megakernel_adamw_flat(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m, jdt),
        jnp.asarray(v, jdt), jnp.asarray(mask),
        *[jnp.asarray(x, jnp.float32) for x in _SC], **_HP)
    got = _torch_sweep(p, g, m, v, mask, tdt)
    summands = np.abs(_HP["b1"] * m) + np.abs((1 - _HP["b1"]) * _SC[1] * g)
    for i, (a, b, name) in enumerate(zip(got, want, ("p", "m", "v"))):
        b = _np32(b)
        ulp = 2.0 ** -7 if (i and mdt == "bf16") else 2.0 ** -22
        size = np.maximum(np.abs(b), summands) if name == "m" else np.abs(b)
        bad = np.abs(_np32(a) - b) > ulp * size
        assert not bad.any(), (name, np.flatnonzero(bad)[:8])


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": (5,), "blocks": {"w": (2, 4, 3),
                                                 "z": (2, 3)}}

    def make(s, scale):
        return {k: make(v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in s.items()}

    return make(shapes, 1.0), make(shapes, 0.3)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(
        v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-leaf"])
@pytest.mark.parametrize("grad_clip", [1.0, None], ids=["clip", "noclip"])
def test_adamw_updates_match_jax(fused, grad_clip):
    """Two updates from the same params, grads and scalars (lr, b1, b2,
    eps, wd, clip). The grad norm is a float32 sum in another order, so
    it is held to 1e-6 relative and the params to 1e-6; the moments —
    elementwise from the grads and the clip scale — to 1e-6."""
    params, grads = _trees(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = PZ.init_adamw_state(jp, fused=fused)
    tp = _to_torch(params)
    topt = TPZ.init_adamw_state(tp, fused=fused)
    jupd = PZ._adamw_update_fused if fused else PZ._adamw_update
    tupd = TPZ._adamw_update_fused if fused else TPZ._adamw_update
    for i in range(2):
        g = jax.tree_util.tree_map(lambda x: x * (1 + i), grads)
        jp, jopt, jn = jupd(jp, jax.tree_util.tree_map(jnp.asarray, g),
                            jopt, 1e-2, grad_clip=grad_clip)
        tp2, topt2, tn = tupd(tp, _to_torch(g), topt, 1e-2,
                              grad_clip=grad_clip)
        assert tp2 is tp and topt2 is topt                   # in place
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    assert int(topt["step"]) == int(jopt["step"]) == 2
    for a, b in zip(TPZ.flat_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(TPZ.flat_leaves({"x": topt[key]}),
                        jax.tree_util.tree_leaves(jopt[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)


def test_bias_corrections_bitwise():
    """c1, c2 = 1 - b ** step in float32, as JAX computes them."""
    for step in (1, 2, 3, 10, 1000):
        js = jnp.asarray(step, jnp.int32).astype(jnp.float32)
        ts = torch.tensor(step, dtype=torch.int32)
        _s, c1, c2 = TPZ._bias_corrections({"step": ts - 1}, 0.9, 0.95)
        assert c1.item() == float(1 - 0.9 ** js)
        assert c2.item() == float(1 - 0.95 ** js)


def test_sweep_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version, updating in
    place, for Python-float scalars too."""
    n = 8
    p, g, mask = torch.zeros(n), torch.ones(n), torch.ones(n)
    m, v = torch.zeros(n, dtype=torch.bfloat16), torch.zeros(
        n, dtype=torch.bfloat16)
    CK.megakernel_adamw_flat(p, g, m, v, mask, 1e-3, 1.0, 0.1, 0.05)
    assert torch.isfinite(p).all() and (p != 0).all()
