"""The port's fused layernorm (``paddle_tpu_torch/ops/fused_ln.py``)
against the JAX package's (``paddle_tpu/ops/pallas_kernels.py:871-1154``),
on the CPU: every forward form, the dropout form with JAX's mask carried
across, the gradients of every operand and the backward kernel's plain
version against ``_fused_ln_vjp_bwd``. The JAX side runs its Pallas
kernels in interpret mode, as ``tests/test_pallas_fused.py`` runs them;
the tolerances are that file's (:51-157)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as PK
from paddle_tpu_torch.ops import fused_ln as TFL

_DT = {"f32": (jnp.float32, torch.float32, 1e-5),
       "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(arr, name):
    jdt, tdt, _ = _DT[name]
    return jnp.asarray(arr, jdt), torch.from_numpy(np.array(arr)).to(tdt)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _inputs(rng, shape):
    d = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32))


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["plain", "residual", "bias_add",
                                  "residual+bias_add"])
def test_forward_forms_match_jax(form, name):
    """y within 1e-5 (f32) / 2e-2 (bf16); the returned s bitwise."""
    x, res, scale, bias, badd = _inputs(np.random.default_rng(0), (5, 7, 96))
    jx, tx = _pair(x, name)
    kw_j, kw_t = {}, {}
    if "residual" in form:
        kw_j["residual"], kw_t["residual"] = _pair(res, name)
    if "bias_add" in form:
        kw_j["bias_add"], kw_t["bias_add"] = _pair(badd, name)
    ret = form != "plain"
    want = PK.fused_ln(jx, jnp.asarray(scale), jnp.asarray(bias), eps=1e-5,
                       return_residual=ret, **kw_j)
    got = TFL.fused_ln(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                       eps=1e-5, return_residual=ret, **kw_t)
    if ret:
        (want, want_s), (got, got_s) = want, got
        assert got_s.dtype == tx.dtype
        np.testing.assert_array_equal(_np(got_s), _np(want_s))
    tol = _DT[name][2]
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _jax_mask(key, keep, shape):
    return np.array(jax.random.bernoulli(key, keep, shape))


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_dropout_form_matches_jax(name):
    """JAX's bernoulli mask for the key, passed across: s bitwise (with
    1/keep rounded to x's dtype, 1.109375 in bf16), y within 1e-5 (f32) /
    2e-2 (bf16)."""
    rng = np.random.default_rng(1)
    x, res, scale, bias, _b = _inputs(rng, (33, 64))
    key, keep = jax.random.PRNGKey(3), 0.9
    jx, tx = _pair(x, name)
    jr, tr = _pair(res, name)
    y, s = PK.fused_ln(jx, jnp.asarray(scale), jnp.asarray(bias), residual=jr,
                       eps=1e-5, dropout_rate=1.0 - keep, dropout_key=key,
                       return_residual=True)
    mask = torch.from_numpy(_jax_mask(key, keep, x.shape))
    ty, ts = TFL.fused_ln_masked(tx, torch.from_numpy(scale),
                                 torch.from_numpy(bias), tr, mask=mask,
                                 eps=1e-5, keep=keep, return_residual=True)
    np.testing.assert_array_equal(_np(ts), _np(s))
    tol = _DT[name][2]
    np.testing.assert_allclose(_np(ty), _np(y), atol=tol, rtol=tol)


def test_dropout_key_draws_a_keep_mask():
    """A torch.Generator key: a fresh mask each draw, the same for the same
    seed, about ``keep`` of the elements kept; no key raises."""
    x = torch.ones((64, 128))
    one, zero = torch.ones(128), torch.zeros(128)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return TFL.fused_ln(x, one, zero, torch.zeros_like(x),
                            dropout_rate=0.25, dropout_key=gen,
                            return_residual=True)[1]

    s0, s1, s2 = run(0), run(0), run(1)
    assert torch.equal(s0, s1) and not torch.equal(s0, s2)
    kept = (s0 != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    assert set(torch.unique(s0).tolist()) == {0.0, float(np.float32(
        1 / 0.75))}
    with pytest.raises(ValueError, match="dropout_key"):
        TFL.fused_ln(x, one, zero, dropout_rate=0.1)


def _grads_jax(x, scale, bias, res, badd, w, w2):
    def fused(x, scale, bias, res, badd):
        y, s = PK.fused_ln(x, scale, bias, residual=res, bias_add=badd,
                           eps=1e-5, return_residual=True, block_rows=64)
        return jnp.sum(y * w) + jnp.sum(s * w2)

    return jax.jit(jax.grad(fused, argnums=(0, 1, 2, 3, 4)))(
        x, scale, bias, res, badd)


def test_gradients_match_jax():
    """Every differentiable operand (x, scale, bias, residual, bias_add) at
    150 rows with block_rows=64, so the JAX rows pad: within 2e-5 / 1e-4."""
    rng = np.random.default_rng(2)
    x, res, scale, bias, badd = _inputs(rng, (150, 80))
    w = rng.standard_normal((150, 80)).astype(np.float32)
    w2 = rng.standard_normal((150, 80)).astype(np.float32)
    want = _grads_jax(*(jnp.asarray(a) for a in (x, scale, bias, res, badd,
                                                 w, w2)))
    ts = [torch.from_numpy(a).requires_grad_()
          for a in (x, scale, bias, res, badd)]
    y, s = TFL.fused_ln(ts[0], ts[1], ts[2], ts[3], ts[4], eps=1e-5,
                        return_residual=True, block_rows=64)
    (torch.sum(y * torch.from_numpy(w))
     + torch.sum(s * torch.from_numpy(w2))).backward()
    for t, b, name in zip(ts, want, ("x", "scale", "bias", "res", "badd")):
        np.testing.assert_allclose(_np(t.grad), np.asarray(b), atol=2e-5,
                                   rtol=1e-4, err_msg=name)


def test_dropout_gradient_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    scale, bias = np.ones(64, np.float32), np.zeros(64, np.float32)
    key, keep = jax.random.PRNGKey(9), 0.8

    def fused(x):
        return jnp.sum(PK.fused_ln(x, jnp.asarray(scale), jnp.asarray(bias),
                                   eps=1e-5, dropout_rate=1.0 - keep,
                                   dropout_key=key) ** 2)

    want = jax.jit(jax.grad(fused))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    mask = torch.from_numpy(_jax_mask(key, keep, x.shape))
    y = TFL.fused_ln_masked(tx, torch.from_numpy(scale),
                            torch.from_numpy(bias), mask=mask, eps=1e-5,
                            keep=keep)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("with_dsx,with_mask", [(False, False), (True, False),
                                                (True, True)],
                         ids=["plain", "dsx", "dsx+mask"])
def test_bwd_plain_matches_jax_vjp_bwd(with_dsx, with_mask):
    """fused_ln_bwd_plain against PK._fused_ln_vjp_bwd on the residuals of
    PK._fused_ln_vjp_fwd (one block of rows, so the JAX statistics are not
    padded): ds/dx, dscale and dbias within 1e-5."""
    rng = np.random.default_rng(4)
    R, D, keep = 64, 96, 0.9
    x, res, scale, bias, _b = _inputs(rng, (R, D))
    dy = rng.standard_normal((R, D)).astype(np.float32)
    dsx = rng.standard_normal((R, D)).astype(np.float32)
    mask = _jax_mask(jax.random.PRNGKey(5), keep, (R, D)) if with_mask \
        else None
    jr = jnp.asarray(res) if with_dsx else None
    _out, resid = PK._fused_ln_vjp_fwd(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), jr, None,
        None if mask is None else jnp.asarray(mask), 1e-5,
        keep if with_mask else 1.0, with_dsx, R)
    ct = (jnp.asarray(dy), jnp.asarray(dsx)) if with_dsx else jnp.asarray(dy)
    jdx, jdscale, jdbias, _dres, _dbadd, _dm = PK._fused_ln_vjp_bwd(
        1e-5, keep if with_mask else 1.0, with_dsx, R, resid, ct)
    sx, mu, rstd = (np.asarray(a) for a in resid[:3])
    ds, dx, dscale, dbias = TFL.fused_ln_bwd_plain(
        torch.from_numpy(sx), torch.from_numpy(mu[:, 0]),
        torch.from_numpy(rstd[:, 0]), torch.from_numpy(scale),
        torch.from_numpy(dy), torch.from_numpy(dsx) if with_dsx else None,
        None if mask is None else torch.from_numpy(mask),
        float(np.float32(1.0 / keep)) if with_mask else 1.0)
    got_dx = dx if with_mask else ds
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(jdscale),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(jdbias), atol=1e-5,
                               rtol=1e-5)


def test_statistics_match_jax_stats():
    """mu and rstd of fused_ln_fwd_plain against the JAX kernel's lane-0
    statistics, within 1e-6."""
    x, res, scale, bias, badd = _inputs(np.random.default_rng(6), (40, 64))
    _y, _s, _sx, mu, rstd = PK._ln_fwd(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(res), jnp.asarray(badd), None, 1e-5, 1.0, 40)
    _y, _s, tmu, trstd = TFL.fused_ln_fwd_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(res), torch.from_numpy(badd))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu)[:, 0], atol=1e-6)
    np.testing.assert_allclose(trstd.numpy(), np.asarray(rstd)[:, 0],
                               rtol=1e-6)



def test_fused_ln_plan_gives_every_accepted_width_an_instance():
    """Every D gets a kernel instance, never a ValueError: on the
    register path (D <= 2048) the lanes' columns cover the row (32 lanes x
    lane_elems >= D) with the fewest elements of the instance set, each a
    whole number of 16-byte vectors in bf16 and in float32; past it one
    block a row with its float32 row in shared memory (ROW_SMEM) while
    that fits a block's 227 KB; past that (the cap this plan raised at,
    12,288, is gone) the two-pass block a row (ROW_TWO_PASS)."""
    for D in range(0, 12289):
        lane_elems = TFL.fused_ln_plan(D)
        if D > 2048:
            assert lane_elems == TFL.ROW_SMEM
            continue
        assert lane_elems in TFL._FWD_ELEMS and lane_elems % 8 == 0
        assert 32 * lane_elems >= D
        assert all(32 * e < D for e in TFL._FWD_ELEMS if e < lane_elems)
    last = TFL._FWD_SMEM_MAX // 4
    assert TFL.fused_ln_plan(12289) == TFL.ROW_SMEM
    assert TFL.fused_ln_plan(last) == TFL.ROW_SMEM
    assert TFL.fused_ln_plan(last + 1) == TFL.ROW_TWO_PASS
    assert TFL.fused_ln_plan(1 << 20) == TFL.ROW_TWO_PASS


@pytest.mark.parametrize("R", [1, 7, 529, 16384, 100000])
def test_ln_bwd_plan_covers_every_row_once(R):
    """The backward's instance for every D: lanes cover the row on the
    register path (D <= 1024), one block a row past it (ROW_SMEM), and
    past 2048 (where this plan raised before) the block a row that walks
    the row in chunks (ROW_TWO_PASS). The grid is one wave (at most
    SMs x blocks an SM), never a block without a row, and its row walkers
    (4 warps a block, or the block) take rows w, w + W, ... so every row
    0..R-1 falls to exactly one walker, each walker ceil(R / W) or one
    fewer."""
    for D in range(0, 2049):
        lane_elems = TFL.ln_bwd_plan(D)
        if D > 1024:
            assert lane_elems == TFL.ROW_SMEM
        else:
            assert lane_elems in TFL._BWD_ELEMS and 32 * lane_elems >= D
            assert all(32 * e < D for e in TFL._BWD_ELEMS if e < lane_elems)
    for D in (2049, 2560, 4096, 20000):
        assert TFL.ln_bwd_plan(D) == TFL.ROW_TWO_PASS
    for lane_elems in (24, TFL.ROW_SMEM, TFL.ROW_TWO_PASS):
        per = TFL.WARPS if lane_elems > 0 else 1
        for sms, bps in ((132, 4), (132, 1), (2, 3), (132, 5)):
            blocks = TFL.ln_bwd_grid(R, lane_elems, sms, bps)
            assert 1 <= blocks <= sms * bps
            walkers = blocks * per
            assert (blocks - 1) * per < R          # no block without a row
            seen = sorted(r for w in range(walkers)
                          for r in range(w, R, walkers))
            assert seen == list(range(R))
            assert max(len(range(w, R, walkers)) for w in range(walkers)) \
                == -(-R // walkers)
