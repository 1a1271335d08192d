"""The port's decode-path operators against the JAX package, on the CPU.

On a CPU tensor each of ``paddle_tpu_torch.ops.cuda_kernels``' public
functions runs its plain PyTorch version; here those are held against the
JAX Pallas kernels they replace (``paddle_tpu.ops.pallas_kernels``, run in
interpret mode as ``tests/test_pallas_fused.py`` runs them), with the same
inputs made by numpy from a seed. The CUDA kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import decode_attention as DA
from paddle_tpu.ops import pallas_kernels as PK
from paddle_tpu_torch.ops import cuda_kernels as CK
from paddle_tpu_torch.ops import decode_attention as TDA

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arr, name):
    """The same numpy values as a JAX array and a torch tensor of dtype
    ``name`` (both round float32 to bf16 to nearest even)."""
    jdt, tdt = _DT[name]
    return jnp.asarray(arr, jdt), torch.from_numpy(np.array(arr)).to(tdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("name,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_fused_ln_matches_jax(name, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 96)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(96)).astype(np.float32)
    jx, tx = _pair(x, name)
    want = PK.fused_ln(jx, jnp.asarray(scale), jnp.asarray(bias), eps=1e-5)
    got = CK.fused_ln(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                      eps=1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_fused_ln_training_forms_refused():
    x = torch.zeros((2, 8))
    one = torch.ones(8)
    for kw in (dict(residual=x), dict(bias_add=one),
               dict(dropout_rate=0.1), dict(return_residual=True)):
        with pytest.raises(NotImplementedError):
            CK.fused_ln(x, one, one, **kw)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_fused_decode_attention_matches_jax(name):
    """Caches bitwise (masked lane included), outputs within 2e-6 —
    the bar of test_pallas_fused.py:512-519."""
    rng = np.random.default_rng(0)
    B, S, nh, hd = 4, 32, 2, 64
    kc = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    nk = rng.standard_normal((B, nh, hd)).astype(np.float32)
    nv = rng.standard_normal((B, nh, hd)).astype(np.float32)
    positions = np.array([3, 5, 0, 7], np.int32)
    active = np.array([1, 1, 0, 1], np.int32)
    jkc, tkc = _pair(kc, name)
    jvc, tvc = _pair(vc, name)
    j_out, j_kc, j_vc = PK.fused_decode_attention(
        jnp.asarray(q), jkc, jvc, jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(positions), active=jnp.asarray(active))
    t_out, t_kc, t_vc = CK.fused_decode_attention(
        torch.from_numpy(q), tkc, tvc, torch.from_numpy(nk),
        torch.from_numpy(nv), torch.from_numpy(positions),
        torch.from_numpy(active))
    assert t_kc is tkc and t_vc is tvc           # updated in place
    np.testing.assert_array_equal(_np(t_kc), _np(j_kc))
    np.testing.assert_array_equal(_np(t_vc), _np(j_vc))
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=2e-6, rtol=2e-6)


def test_fused_decode_masked_lane_no_write():
    """A dead lane's slab comes back bit-identical; the live lane's row
    lands (test_pallas_fused.py:522-543)."""
    rng = np.random.default_rng(1)
    B, S, nh, hd = 3, 16, 2, 64
    kc = torch.from_numpy(rng.standard_normal((B, S, nh, hd)).astype(
        np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, S, nh, hd)).astype(
        np.float32))
    k0, v0 = kc.clone(), vc.clone()
    q = torch.from_numpy(rng.standard_normal((B, nh, hd)).astype(np.float32))
    nk = torch.full((B, nh, hd), 123.0)
    nv = torch.full((B, nh, hd), 456.0)
    positions = torch.tensor([2, 0, 9], dtype=torch.int32)
    active = torch.tensor([1, 0, 0], dtype=torch.int32)
    CK.fused_decode_attention(q, kc, vc, nk, nv, positions, active)
    for dead in (1, 2):
        assert torch.equal(kc[dead], k0[dead])
        assert torch.equal(vc[dead], v0[dead])
    assert torch.equal(kc[0, 2], torch.full((nh, hd), 123.0))
    assert torch.equal(vc[0, 2], torch.full((nh, hd), 456.0))


def test_fused_logits_head_matches_jax():
    """V=300 is not a multiple of the vocab tile: the ragged tile."""
    rng = np.random.default_rng(3)
    B, d, V = 4, 64, 300
    x = rng.standard_normal((B, d)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    head = (rng.standard_normal((d, V)) * 0.05).astype(np.float32)
    want = np.asarray(PK.fused_logits_head(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(head), eps=1e-5, block_v=128))
    got = CK.fused_logits_head(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias),
                               torch.from_numpy(head), eps=1e-5).numpy()
    assert got.shape == (B, V)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_cpu_tensors_take_plain_versions():
    """CPU tensors run the plain versions — identical to calling them —
    and launch nothing."""
    rng = np.random.default_rng(4)
    CK.reset_launches()
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    s = torch.ones(32)
    b = torch.zeros(32)
    assert torch.equal(CK.fused_ln(x, s, b), CK.fused_ln_plain(x, s, b))
    w = torch.from_numpy(rng.standard_normal((32, 50)).astype(np.float32))
    assert torch.equal(CK.fused_logits_head(x, s, b, w),
                       CK.fused_logits_head_plain(x, s, b, w))
    kc = torch.zeros((3, 8, 2, 16))
    vc = torch.zeros((3, 8, 2, 16))
    q = torch.from_numpy(rng.standard_normal((3, 2, 16)).astype(np.float32))
    pos = torch.tensor([0, 3, 7], dtype=torch.int32)
    out, _, _ = CK.fused_decode_attention(q, kc, vc, q, q, pos)
    want, _, _ = CK.fused_decode_attention_plain(
        q, torch.zeros_like(kc), torch.zeros_like(vc), q, q, pos)
    assert torch.equal(out, want)
    assert CK.LAUNCHES == dict.fromkeys(CK.KERNELS, 0)


def test_non_cpu_non_cuda_tensors_raise():
    """No silent plain path off the CPU: a device the kernels do not take
    raises instead of running the plain version."""
    x = torch.empty((2, 8), device="meta")
    one = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="devices"):
        CK.fused_ln(x, one, one)
    with pytest.raises(ValueError, match="devices"):
        CK.fused_ln(torch.zeros((2, 8)), one, one)


_FAKE_NVCC = """#!/bin/sh
# stand-in compiler: writes the -o target, reports like ptxas, and fails
# on any source named in $FAIL_SOURCE
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  case "$a" in *.cu) src="$a";; esac
  prev="$a"
done
if [ -n "$FAIL_SOURCE" ] && [ "${src##*/}" = "$FAIL_SOURCE" ]; then
  echo "$src: error: stand-in failure"; exit 2
fi
echo "ptxas info    : Used 12 registers"
: > "$out"
"""


def test_build_orchestration_with_a_stand_in_compiler(tmp_path, monkeypatch):
    """ops/_build.py without the card's toolchain: one compiler process per
    source, logs kept per source, a content-addressed build reused, and a
    failing source reported by name."""
    from paddle_tpu_torch.ops import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.delenv("FAIL_SOURCE", raising=False)
    info = _build.build()
    assert not info.cached and info.path.is_file()
    assert info.path.parent.parent == tmp_path / "_build"
    assert set(info.logs) == {p.stem for p in _build.SOURCE_DIR.glob("*.cu")}
    assert all("Used 12 registers" in log for log in info.logs.values())
    again = _build.build()
    assert again.cached and again.path == info.path
    monkeypatch.setenv("FAIL_SOURCE", "decode_slab.cu")
    with pytest.raises(RuntimeError, match="decode_slab.cu"):
        _build.build(force=True)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == \
        [info.path.parent.name]                # no half-built directory


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    from paddle_tpu_torch.ops import _build

    if _build.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_decode_attention_module_matches_jax():
    """cache_update (in place), decode_attention (empty lane -> zeros) and
    prefill_attention against ops/decode_attention.py."""
    rng = np.random.default_rng(5)
    B, S, nh, hd = 3, 12, 2, 16
    cache = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    new = rng.standard_normal((B, nh, hd)).astype(np.float32)
    pos = np.array([4, 0, 11], np.int32)
    act = np.array([1, 0, 1], np.int32)
    want = np.asarray(DA.cache_update(jnp.asarray(cache), jnp.asarray(new),
                                      jnp.asarray(pos), jnp.asarray(act)))
    tc = torch.from_numpy(cache.copy())
    TDA.cache_update(tc, torch.from_numpy(new), torch.from_numpy(pos),
                     torch.from_numpy(act))
    np.testing.assert_array_equal(tc.numpy(), want)

    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    lengths = np.array([5, 0, 12], np.int32)
    want = np.asarray(DA.decode_attention(jnp.asarray(q), jnp.asarray(want),
                                          jnp.asarray(want),
                                          jnp.asarray(lengths)))
    got = TDA.decode_attention(torch.from_numpy(q), tc, tc,
                               torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    assert np.all(got[1] == 0.0)

    qkv = rng.standard_normal((3, 1, 9, nh, hd)).astype(np.float32)
    want = np.asarray(DA.prefill_attention(*map(jnp.asarray, qkv)))
    got = TDA.prefill_attention(*map(torch.from_numpy, qkv)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
