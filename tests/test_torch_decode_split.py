"""The decode kernels' split plan and checks, on the CPU.

The slab and paged decode kernels (``ops/csrc/decode_attention.cuh``) cut
each lane's rows into chunks, one block per (chunk, head, lane), and merge
the blocks' float32 partials (m, l, o) in a second pass. The kernels run
only on the card (``tests/test_torch_cuda.py``); here the chunking that
``ops/cuda_kernels.py`` picks is checked for what the kernels rely on, the
split-and-merge arithmetic over those chunks (written out in numpy below,
as the kernel does it) is held against the JAX package's
``decode_attention``, and the wrappers' host-side checks and workspace
are exercised on CPU tensors.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import decode_attention as DA
from paddle_tpu_torch.ops import cuda_kernels as CK

# (rows a lane, head dim, cache element bytes, page)
PLANS = [(1024, 64, 2, 1), (1024, 64, 2, 16), (1024, 64, 4, 1),
         (1000, 64, 2, 1), (16384, 64, 2, 1), (512, 32, 2, 8),
         (512, 128, 4, 32), (32, 16, 4, 8), (96, 128, 2, 48),
         (65536, 16, 2, 1)]


@pytest.mark.parametrize("rows,hd,esz,page", PLANS)
def test_split_plan_covers_the_rows_in_whole_pages(rows, hd, esz, page):
    """Chunks are whole tiles rounded up to whole pages, cover the rows
    with no chunk wholly past them, and number at most 64 a lane."""
    chunk, nsplit = CK._decode_split(rows, hd, esz, page)
    tile = 4 * 128 * (16 // esz) // hd
    assert chunk % page == 0
    assert chunk * nsplit >= rows > chunk * (nsplit - 1)
    assert chunk >= tile
    assert nsplit <= CK._DECODE_MAX_SPLITS


def test_split_plan_at_the_serving_path():
    """GPT_SMALL's decode tick: 16 chunks of 64 rows (bf16) or 32 of 32
    rows (float32) over max_seq 1024, slab and paged (page 16) alike."""
    assert CK._decode_split(1024, 64, 2) == (64, 16)
    assert CK._decode_split(1024, 64, 2, 16) == (64, 16)
    assert CK._decode_split(1024, 64, 4, 16) == (32, 32)
    assert CK._decode_split(16384, 64, 2) == (256, 64)


def _split_decode(q, k, v, positions, chunk, sm_scale):
    """The kernels' arithmetic in numpy float32: per (lane, head) a
    partial (m, l, o) for each chunk holding rows 0..pos — the chunk's
    max score, its sum of e^(s - m) and its e^(s - m)-weighted V rows —
    then the merge: M the partials' max made finite, L = sum l_i
    e^(m_i - M), out = sum o_i e^(m_i - M) / max(L, 1e-30)."""
    B, _S, nh, _hd = k.shape
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        pos = int(positions[b])
        for h in range(nh):
            parts = []
            for c0 in range(0, pos + 1, chunk):
                r = np.arange(c0, min(c0 + chunk, pos + 1))
                s = (k[b, r, h] @ q[b, h]) * np.float32(sm_scale)
                m = s.max()
                p = np.exp(s - m)
                parts.append((m, p.sum(), p @ v[b, r, h]))
            assert len(parts) == pos // chunk + 1
            M = max(m for m, _l, _o in parts)
            M = M if np.isfinite(M) else np.float32(0)
            L = sum(l * np.exp(m - M) for m, l, _o in parts)
            o = sum(o * np.exp(m - M) for m, _l, o in parts)
            out[b, h] = o / max(L, np.float32(1e-30))
    return out


@pytest.mark.parametrize("S,hd,esz", [(1024, 64, 2), (1000, 32, 4),
                                      (300, 128, 2)])
def test_split_and_merge_match_jax_decode_attention(S, hd, esz):
    """Lanes at the chunk edges (0, C-1, C, C+1, S-1) and a random one:
    split over the wrapper's chunks and merged, float32, within 1e-5 of
    the JAX package's decode_attention over rows 0..pos."""
    chunk, _ = CK._decode_split(S, hd, esz)
    rng = np.random.default_rng(S + hd)
    positions = np.array([0, chunk - 1, chunk, chunk + 1, S - 1,
                          rng.integers(0, S)], np.int32) % S
    B, nh = len(positions), 2
    q = rng.standard_normal((B, nh, hd), np.float32)
    k = rng.standard_normal((B, S, nh, hd), np.float32)
    v = rng.standard_normal((B, S, nh, hd), np.float32)
    scale = 1.0 / np.sqrt(hd)
    got = _split_decode(q, k, v, positions, chunk, scale)
    want = np.asarray(DA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions + 1), scale))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _decode_tensors(hd=64, dtype=torch.bfloat16):
    B, S, nh = 2, 32, 3
    qkv = torch.zeros((B, 3, nh, hd), dtype=dtype)
    kc = torch.zeros((B, S, nh, hd), dtype=dtype)
    return qkv[:, 0], qkv[:, 1], qkv[:, 2], kc, kc.clone(), (B, S, nh, hd)


def test_decode_checks_take_the_serving_layout():
    """q/new_k/new_v as strided slices of one qkv, contiguous caches: the
    dtype codes of q and the cache (bf16 = 1, float32 = 0)."""
    q, nk, nv, kc, vc, shape = _decode_tensors()
    assert CK._check_decode_inputs("f", q, nk, nv, kc, vc, shape, 2) == (1,
                                                                          1)
    q32, nk32, nv32 = q.float(), nk.float(), nv.float()
    assert CK._check_decode_inputs("f", q32, nk32, nv32, kc, vc, shape,
                                   2) == (0, 1)


@pytest.mark.parametrize("case", ["head_dim", "16-byte", "contiguous",
                                  "batch stride", "V cache"])
def test_decode_checks_refuse_what_the_kernels_do_not_take(case):
    q, nk, nv, kc, vc, shape = _decode_tensors()
    if case == "head_dim":
        # every hd >= 1 runs a kernel (an instance up to 128, the split
        # route past it: ROADMAP C4); an empty head runs none
        q, nk, nv, kc, vc, shape = _decode_tensors(hd=0)
    elif case == "16-byte":
        flat = torch.zeros(kc.numel() + 1, dtype=kc.dtype)
        kc = flat[1:].view(shape)
    elif case == "contiguous":
        kc = kc.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "batch stride":
        nk = nk.clone()
    else:
        vc = vc[:, :16]
    with pytest.raises(ValueError, match=case):
        CK._check_decode_inputs("f", q, nk, nv, kc, vc, shape, 2)


def test_workspace_is_kept_per_stream_and_grows():
    """One float32 buffer per (device, stream), reused while it is large
    enough, replaced by a larger one when a call needs more."""
    dev = torch.device("cpu")
    CK._WORKSPACE.clear()
    try:
        a = CK._workspace(dev, 1, 100)
        assert a.dtype == torch.float32 and a.numel() == 100
        assert CK._workspace(dev, 1, 60) is a
        b = CK._workspace(dev, 1, 200)
        assert b is not a and b.numel() == 200
        assert CK._workspace(dev, 1, 100) is b
        assert CK._workspace(dev, 2, 100) is not b
    finally:
        CK._WORKSPACE.clear()


class _SlowLib:
    """A stand-in for the kernel library whose decode entry points sleep
    without the GIL, as the real C call runs with it released, and record
    how many calls were inside at once."""

    def __init__(self):
        self.inside = self.most = 0
        self.guard = threading.Lock()

    def _call(self, *args):
        with self.guard:
            self.inside += 1
            self.most = max(self.most, self.inside)
        time.sleep(0.002)
        with self.guard:
            self.inside -= 1
        return 0

    ptt_decode_slab = ptt_decode_paged = _call


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_decode_calls_of_two_threads_never_overlap(layout, monkeypatch):
    """The call that queues a decode kernel's split pass and its merge
    holds the workspace lock: two engines' loop threads launching on one
    stream share one workspace, and another split queued between a
    split and its merge would overwrite the partials the merge reads.
    Driven on CPU tensors with the card's route forced and the library
    replaced, from two threads at once: at most one call inside at any
    time, and every call counted."""
    lib = _SlowLib()
    monkeypatch.setattr(CK, "_on_card", lambda *t: True)
    monkeypatch.setattr(CK, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(CK, "_WORKSPACE", {})
    monkeypatch.setattr(CK, "LAUNCHES", dict.fromkeys(CK.LAUNCHES, 0))
    q, nk, nv, kc, vc, (B, S, nh, hd) = _decode_tensors()
    pos = torch.zeros(B, dtype=torch.int32)
    if layout == "slab":
        call = lambda: CK.fused_decode_attention(  # noqa: E731
            q, kc, vc, nk, nv, pos, torch.ones(B, dtype=torch.int32))
    else:
        pool = kc.reshape(B * S // 8, 8, nh, hd)
        tables = torch.arange(B * S // 8, dtype=torch.int32).reshape(B, -1)
        call = lambda: CK.fused_paged_decode_attention(  # noqa: E731
            q, pool, pool.clone(), nk, nv, tables, pos)
    threads = [threading.Thread(target=lambda: [call() for _ in range(10)])
               for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert lib.most == 1
    assert CK.LAUNCHES[f"decode_{layout}"] == 20
