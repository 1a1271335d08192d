"""The port's AdamW against the JAX package, on the CPU: the plain flat
sweep (``megakernel_adamw_flat_plain``, what ``megakernel_adamw_flat``
runs on CPU tensors) against the Pallas megakernel in interpret mode, and
``_adamw_update`` / ``_adamw_update_fused`` against JAX's, fed the same
scalars; and the fluid kinds of the same megakernel (sgd, momentum, adam
and AdamW) the same way. The CUDA sweeps are held bitwise against the
plain ones on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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


# ---------------------------------------------------------------------------
# The fluid optimizer sweeps: kinds "sgd", "momentum" and "adam"
# ---------------------------------------------------------------------------


def _kind_inputs(n=1001, seed=2):
    """p, g, m, v, velocity (odd n: the kernels' scalar tail)."""
    rng = np.random.default_rng(seed)
    p, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    vel = rng.standard_normal(n).astype(np.float32)
    return p, g, m, v, vel


_LR, _B1P, _B2P = np.float32(1e-3), np.float32(0.9 ** 3), np.float32(0.999 ** 3)
_MU = 0.9


def _t(*arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _port_kind(kind, p, g, m, v, vel):
    """The port's kernel route on CPU tensors (its plain version); returns
    the updated buffers as numpy, after checking they were updated in
    place."""
    if kind == "sgd":
        tp, tg = _t(p, g)
        got = [CK.megakernel_sgd(tp, tg, torch.tensor(_LR))]
        assert got[0] is tp
    elif kind.startswith("momentum"):
        tp, tg, tv = _t(p, g, vel)
        got = CK.megakernel_momentum(tp, tg, tv, torch.tensor(_LR), mu=_MU,
                                     nesterov=kind.endswith("nesterov"))
        assert got[0] is tp and got[1] is tv
    else:
        tp, tg, tm, tv = _t(p, g, m, v)
        got = CK.megakernel_adam(
            tp, tg, tm, tv, torch.tensor(_LR), torch.tensor(_B1P),
            torch.tensor(_B2P), b1=0.9, b2=0.999, eps=1e-8,
            coeff=0.01 if kind == "adamw" else 0.0)
        assert got[0] is tp and got[1] is tm and got[2] is tv
    return [x.numpy() for x in got]


def _numpy_kind(kind, p, g, m, v, vel):
    """The kind as numpy float32 operations, each rounded on its own
    (IEEE), in the reference expression's order."""
    f = np.float32
    if kind == "sgd":
        return [p - _LR * g]
    if kind.startswith("momentum"):
        vn = f(_MU) * vel + g
        if kind.endswith("nesterov"):
            return [p - (g + f(_MU) * vn) * _LR, vn]
        return [p - _LR * vn, vn]
    mn = f(0.9) * m + f(1 - 0.9) * g
    vn = f(0.999) * v + f(1 - 0.999) * g * g
    lr_t = _LR * np.sqrt(f(1) - _B2P * f(0.999)) / (f(1) - _B1P * f(0.9))
    pn = p - lr_t * mn / (np.sqrt(vn) + f(1e-8))
    if kind == "adamw":
        pn = pn - (_LR * f(0.01)) * p
    return [pn, mn, vn]


_KINDS = ["sgd", "momentum", "momentum_nesterov", "adam", "adamw"]


@pytest.mark.parametrize("kind", _KINDS)
def test_plain_kinds_bitwise_vs_float32_ops(kind):
    """Each kind is defined as float32 operations each rounded to nearest,
    no fused multiply-add — what the CUDA kernels compute with their _rn
    intrinsics: the plain versions bit for bit against numpy doing
    exactly that."""
    ins = _kind_inputs()
    for a, b in zip(_port_kind(kind, *ins), _numpy_kind(kind, *ins)):
        np.testing.assert_array_equal(a, b)


def _jax_unfused(kind, p, g, m, v, vel):
    """The reference's unfused expressions (``fused_sgd`` /
    ``fused_momentum`` / ``_fused_adam_impl`` with the megakernel off),
    jitted as the JAX executor runs them."""
    lr, b1p, b2p = (jnp.asarray(x) for x in (_LR, _B1P, _B2P))
    if kind == "sgd":
        return [jax.jit(lambda p, g: p - lr.astype(p.dtype) * g)(p, g)]
    if kind.startswith("momentum"):
        nesterov = kind.endswith("nesterov")

        @jax.jit
        def mom(p, g, v):
            v_new = _MU * v + g
            if nesterov:
                return p - (g + _MU * v_new) * lr, v_new
            return p - lr * v_new, v_new

        return list(mom(p, g, vel))
    coeff = 0.01 if kind == "adamw" else 0.0

    @jax.jit
    def adam(p, g, m, v):
        b1, b2 = 0.9, 0.999
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        lr_t = lr * jnp.sqrt(1 - b2p * b2) / (1 - b1p * b1)
        p_new = p - lr_t * m_new / (jnp.sqrt(v_new) + 1e-8)
        if coeff:
            p_new = p_new - lr * coeff * p
        return p_new, m_new, v_new

    return list(adam(p, g, m, v))


@pytest.mark.parametrize("ref", ["megakernel", "unfused"])
@pytest.mark.parametrize("kind", _KINDS)
def test_plain_kinds_vs_megakernel(kind, ref):
    """Against ``PK.megakernel_sgd/momentum/adam`` in interpret mode, and
    against the reference's unfused expressions, jitted. XLA
    on the CPU contracts a product and a sum into one fused multiply-add
    (p - lr*g, mu*v + g, b1*m + (1-b1)*g, ...), which the port's per-op
    rounding does not (``test_plain_kinds_bitwise_vs_float32_ops``), so
    bitwise equality is impossible here, moments included: here 19 of
    1001 sgd params, about 28% of the moments, differ by an ulp.
    p within the reference's own bands (``tests/test_pallas_fused.py``:
    momentum 1e-6; adam atol 1e-8 and rtol 1e-7, widened to rtol 2^-23,
    one float32 ulp, because one adam p element here sits just above 1.0
    where an ulp is 1.19e-7; sgd bitwise there, 1e-7 here for the
    contraction); each moment element within 2^-22 of the larger of its
    size and its summands' (2 float32 ulps: the fused rounding differs by
    up to an ulp of the summands where they cancel)."""
    p, g, m, v, vel = ins = _kind_inputs()
    j = jnp.asarray
    if kind == "sgd":
        want = [PK.megakernel_sgd(j(p), j(g), j(_LR))]
        summands = []
    elif kind.startswith("momentum"):
        want = PK.megakernel_momentum(j(p), j(g), j(vel), j(_LR), mu=_MU,
                                      nesterov=kind.endswith("nesterov"))
        summands = [np.abs(_MU * vel) + np.abs(g)]
    else:
        want = PK.megakernel_adam(j(p), j(g), j(m), j(v), j(_LR), j(_B1P),
                                  j(_B2P), b1=0.9, b2=0.999, eps=1e-8,
                                  coeff=0.01 if kind == "adamw" else 0.0)
        summands = [np.abs(0.9 * m) + np.abs(0.1 * g),
                    np.abs(0.999 * v) + np.abs(0.001 * g * g)]
    if ref == "unfused":
        want = _jax_unfused(kind, *(j(x) for x in ins))
    got = _port_kind(kind, *ins)
    want = [np.asarray(w) for w in want]
    band = {"sgd": (1e-7, 1e-7), "momentum": (1e-6, 1e-6),
            "momentum_nesterov": (1e-6, 1e-6), "adam": (1e-8, 2.0 ** -23),
            "adamw": (1e-8, 2.0 ** -23)}[kind]
    np.testing.assert_allclose(got[0], want[0], atol=band[0], rtol=band[1],
                               err_msg="p")
    for a, b, s in zip(got[1:], want[1:], summands):
        bad = np.abs(a - b) > 2.0 ** -22 * np.maximum(np.abs(b), s)
        assert not bad.any(), np.flatnonzero(bad)[:8]


def test_plain_sgd_bf16_vs_xla():
    """bf16 sgd keeps the dtype-native chain (lr, the product and the
    difference each rounded to bf16): within one bf16 ulp of XLA's CPU
    rounding, in interpret mode and in the jitted unfused expression
    (here no element differs)."""
    p, g, _m, _v, _vel = _kind_inputs()
    pj, gj = jnp.asarray(p, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    lr = jnp.asarray(_LR)
    wants = [PK.megakernel_sgd(pj, gj, lr),
             jax.jit(lambda p, g, lr: p - lr.astype(p.dtype) * g)(pj, gj,
                                                                   lr)]
    tp = torch.from_numpy(np.asarray(pj, np.float32)).to(torch.bfloat16)
    tg = torch.from_numpy(np.asarray(gj, np.float32)).to(torch.bfloat16)
    got = CK.megakernel_sgd(tp, tg, torch.tensor(_LR)).float().numpy()
    for want in wants:
        want = np.asarray(want, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_kinds_take_plain_version_on_cpu():
    """On CPU tensors each wrapper runs its plain version (no launch is
    counted), in place, for Python-float scalars too."""
    before = dict(CK.LAUNCHES)
    p, g, v, m = torch.zeros(5), torch.ones(5), torch.zeros(5), torch.zeros(5)
    CK.megakernel_sgd(p, g, 0.5)
    assert (p == -0.5).all()
    CK.megakernel_momentum(p, g, v, 0.5, mu=0.9)
    assert (v == 1).all() and (p == -1).all()
    CK.megakernel_adam(p, g, m, v, 1e-3, 0.9, 0.999, coeff=0.1)
    assert torch.isfinite(p).all() and (m != 0).all()
    assert CK.LAUNCHES == before
