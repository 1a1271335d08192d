"""The port's communication levers (``paddle_tpu_torch/parallel/comm_opt.py``)
against the JAX package's ``comm_opt``: the bucket layout and its
helpers, the chunked quantizer, the wire-byte model, and — in spawned
gloo worlds on the CPU (``torch_dist_worker``) — the reduce-scatter step
against the psum step, the quantized collectives, the byte counter and
error feedback, each on the reference test's bar
(``tests/test_comm_opt.py``)."""
import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.parallel import comm_opt as JC

import torch
import torch_dist_worker as W
from paddle_tpu_torch.models import gpt as G
from paddle_tpu_torch.parallel import comm_opt as C
from paddle_tpu_torch.parallel import parallelize as PZ

SHAPES = [
    [((64, 64), np.float32), ((64,), np.float32), ((7, 5), np.float32),
     ((3,), np.float32)],
    [((100,), np.float32)],
    [((4, 4), np.float32), ((4,), np.float32), ((5, 3, 2), np.float32),
     ((1,), np.float32), ((33,), np.float32)],
]


@pytest.mark.parametrize("shapes", SHAPES, ids=["cap-split", "one", "mixed"])
@pytest.mark.parametrize("ranks,cap,pad", [(8, 64 * 64 * 4, 1),
                                           (4, 1 << 20, 64), (3, 100, 1)])
def test_bucket_layout_and_helpers_equal_jax(shapes, ranks, cap, pad):
    want = JC.build_bucket_layout(shapes, ranks=ranks, cap_bytes=cap,
                                  pad_multiple=pad)
    got = C.build_bucket_layout(shapes, ranks=ranks, cap_bytes=cap,
                                pad_multiple=pad)
    assert (got.ranks, got.total_len, got.shard_len) == \
        (want.ranks, want.total_len, want.shard_len)
    assert len(got.buckets) == len(want.buckets)
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(d) for s, d in shapes]
    for gb, wb in zip(got.buckets, want.buckets):
        assert (gb.dtype, gb.entries, gb.size, gb.pad, gb.nbytes) == \
            (wb.dtype, wb.entries, wb.size, wb.pad, wb.nbytes)
        np.testing.assert_array_equal(C.bucket_wd_mask(gb),
                                      JC.bucket_wd_mask(wb))
        vec = C.flatten_bucket([torch.from_numpy(x) for x in leaves], gb)
        jvec = JC.flatten_bucket([jnp.asarray(x) for x in leaves], wb)
        np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
        back = C.unflatten_bucket(vec, gb)
        jback = JC.unflatten_bucket(jvec, wb)
        assert back.keys() == jback.keys()
        for i in back:
            np.testing.assert_array_equal(back[i].numpy(),
                                          np.asarray(jback[i]))
            np.testing.assert_array_equal(back[i].numpy(), leaves[i])


@pytest.mark.parametrize("comm_dtype,chunk", [("bf16", 64), ("int8", 64),
                                              ("int8", 256), (None, 64)])
def test_quantize_chunked_equals_jax(comm_dtype, chunk):
    """Payload and scales bitwise equal to JAX's (both round half to even
    and divide in float32); so is the float32 dequantized vector. An
    all-zero chunk stays exact."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4 * chunk) * 3).astype(np.float32)
    x[:chunk] = 0.0
    q, s = C.quantize_chunked(torch.from_numpy(x), comm_dtype, chunk)
    jq, js = JC.quantize_chunked(jnp.asarray(x), comm_dtype, chunk)
    np.testing.assert_array_equal(q.float().numpy(),
                                  np.asarray(jq, np.float32))
    assert (s is None) == (js is None)
    if s is not None:
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = C.dequantize_chunked(q, s, comm_dtype, chunk)
    jback = JC.dequantize_chunked(jq, js, comm_dtype, chunk)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    assert (back[:chunk] == 0).all()
    if comm_dtype == "int8":
        np.testing.assert_allclose(back.numpy(), x,
                                   atol=np.abs(x).max() / 127 + 1e-6)


def test_wire_bytes_model_equals_jax():
    for op in ("psum", "psum_scatter", "all_gather", "all_to_all",
               "ppermute"):
        for ranks in (1, 2, 3, 8):
            for n in (4, 800, 12345):
                assert C.wire_bytes(op, n, ranks) == \
                    JC.wire_bytes(op, n, ranks), (op, ranks, n)
    with pytest.raises(ValueError):
        C.wire_bytes("gather", 8, 2)
    with pytest.raises(ValueError):
        C.CommConfig(error_feedback=True)
    with pytest.raises(ValueError):
        C.CommConfig(grad_reduce="ring")
    assert C.CommConfig(comm_dtype="bfloat16").comm_dtype == "bf16"


SMALL = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=32, d_ff=64)
ODD = dict(SMALL, num_layers=2, d_ff=65)    # b_fc: 130 elements
RS = dict(grad_reduce="reduce_scatter")


def _step_job(dp, runs, cfg_kw=None, b=8, pp=1, tp=1, m=1):
    """A ``step_worker`` job training each run of ``runs`` ({name: (step
    kwargs, steps)}) in turn from ``G.init_params(seed=0)``."""
    cfg = G.GPT_TINY.scaled(**(cfg_kw or {}))
    params = G.init_params(cfg, seed=0, device="cpu")
    pnp = PZ._unflatten(params, [p.numpy() for p in PZ.flat_leaves(params)])
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (m, b, 32))
    labels = rng.integers(0, cfg.vocab_size, (m, b, 32))
    return ("step_worker", (
        cfg_kw or {}, dict(dp=dp, pp=pp, tp=tp, microbatches=m), pnp, tokens,
        labels, [dict(step_kw=dict(lr=1e-2, **kw), steps=n)
                 for kw, n in runs.values()])), list(runs)


def _spawn(out_dir, world, cases):
    """Each case {case: (job, run names)} in one spawned world; {case:
    {run name: ranks' results}} (a collective job's ranks' results)."""
    ranks = W.spawn(W.jobs_worker, world, [c[0] for c in cases.values()],
                    out_dir=str(out_dir))
    out = {}
    for i, (case, (_, names)) in enumerate(cases.items()):
        res = [r[i] for r in ranks]
        out[case] = ({n: [x[k] for x in res] for k, n in enumerate(names)}
                     if names else res)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """dp 2: psum against reduce-scatter on the odd-shard config, and the
    reference's int8 error-feedback bar on GPT_TINY, in one world."""
    return _spawn(tmp_path_factory.mktemp("w2"), 2, {
        "odd": _step_job(2, {
            "psum": (dict(grad_clip=None), 3),
            "rs": (dict(RS, grad_clip=None, bucket_mb=0.01,
                        fused_opt=True), 3)}, cfg_kw=ODD),
        "ef": _step_job(2, {
            "f32": (RS, 5),
            "int8": (dict(RS, grad_allreduce_dtype="int8",
                          error_feedback=True), 5)}, b=16)})


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    """The psum and the reduce-scatter step at dp 4, 3 steps each."""
    return _spawn(tmp_path_factory.mktemp("dp4"), 4, {"dp4": _step_job(
        4, {"psum": ({}, 3), "rs": (RS, 3)}, cfg_kw=SMALL)})["dp4"]


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """8 ranks: psum against reduce-scatter at dp 2 x pp 2 x tp 2, and the
    reference's quantized all-reduce case."""
    rng = np.random.default_rng(1)
    xs = (rng.standard_normal((8, 512)) * 3).astype(np.float32)
    out = _spawn(tmp_path_factory.mktemp("w8"), 8, {
        "mixed": _step_job(2, {"psum": ({}, 3), "rs": (RS, 3)},
                           cfg_kw=SMALL, pp=2, tp=2, m=2),
        "collective": (("collective_worker", (list(xs), 64)), None)})
    out["xs"] = xs
    return out


def test_reduce_scatter_bitwise_equal_to_psum_dp2(world2):
    """dp 2, float32 wire, grad_clip=None (as the reference's bitwise
    test): the reduce-scatter step's losses and params equal the psum
    step's bit for bit — a sum of two is order-free. The buckets are
    small, so there are several, and one shard starts at an odd
    element."""
    layout, _ = PZ.rs_param_layout(G.GPT_TINY.scaled(**ODD),
                                   PZ.ParallelConfig(dp=2), bucket_mb=0.01)
    assert len(layout.buckets) > 2
    assert (layout.buckets[0].size // 2) % 2
    runs = world2["odd"]
    for a, b in zip(runs["psum"], runs["rs"]):
        assert a["losses"] == b["losses"]
        for x, y in zip(a["params"], b["params"]):
            np.testing.assert_array_equal(x, y)
    # flat sharded moments: half the params (plus padding) a rank
    n = sum(x.size for x in runs["psum"][0]["params"])
    assert runs["rs"][0]["opt"]["m"].size == layout.shard_len < 0.51 * n


def test_reduce_scatter_close_to_psum_dp4(dp4):
    """dp 4: what holds is the reference's mixed-mesh tolerance (losses
    rtol 1e-5, params rtol 2e-4 / atol 2e-5) — gloo's all-reduce and its
    reduce-scatter may add four terms in different orders, so bitwise
    equality is not promised."""
    for a, b in zip(dp4["psum"], dp4["rs"]):
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
        for x, y in zip(a["params"], b["params"]):
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5)


def test_reduce_scatter_mixed_mesh_close(world8):
    """dp 2 x pp 2 x tp 2 (the reference's mixed-mesh test): the pp/tp
    sums come before the dp scatter, so the association differs from the
    psum step's — losses rtol 1e-5, params rtol 2e-4 / atol 2e-5, as the
    reference holds them."""
    runs = world8["mixed"]
    for a, b in zip(runs["psum"], runs["rs"]):
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
        for x, y in zip(a["params"], b["params"]):
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5)


def test_quantized_allreduce_parity(world8):
    """The reference test's 8-way case and bound: bf16 within rtol 0.02 /
    atol 0.05 of the exact sum, int8 (chunk 64) within 0.1 / 0.3; the
    quantized reduce-scatter op within the int8 bound of its block."""
    exact = world8["xs"].sum(0)
    for i, r in enumerate(world8["collective"]):
        # rank i is index i of the dp line, inside mesh_guard only
        assert r["guard"] == (True, i, 8) and r["unguarded"]
        np.testing.assert_allclose(r["exact"], exact, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["bf16"], exact, rtol=0.02, atol=0.05)
        np.testing.assert_allclose(r["int8"], exact, rtol=0.1, atol=0.3)
        # [8, 64] -> this rank's [1, 64] block of the sum
        np.testing.assert_allclose(r["rs"], exact[None, i * 64:(i + 1) * 64],
                                   rtol=0.1, atol=0.3)


def test_wire_byte_counter_halves_for_reduce_scatter(dp4):
    """The paddle_collective_bytes_total counter records about half the
    gradient-reduction bytes for the reduce-scatter step (the twin of the
    reference's test, at dp 4), and exactly the ring model's bytes (the
    port counts every call: 3 steps here)."""
    def grad_bytes(r):
        return sum(v for k, v in r["wire"].items()
                   if k[0] in ("psum", "psum_scatter", "all_to_all"))

    layout, _ = PZ.rs_param_layout(G.GPT_TINY.scaled(**SMALL),
                                   PZ.ParallelConfig(dp=4))
    loss = C.wire_bytes("psum", 4, 4)
    for a, b in zip(dp4["psum"], dp4["rs"]):
        assert grad_bytes(a) / grad_bytes(b) > 1.9
        assert grad_bytes(a) == 3 * (sum(
            C.wire_bytes("psum", x.size * 4, 4) for x in a["params"]) + loss)
        assert grad_bytes(b) == 3 * (C.wire_bytes(
            "psum_scatter", layout.total_len * 4, 4) + loss)
        assert b["wire"][("all_gather", "float32")] == 3 * C.wire_bytes(
            "all_gather", layout.total_len * 4, 4)


def test_int8_error_feedback_converges(world2):
    """The reference's bar on GPT_TINY at lr 1e-2 over 5 steps: int8 wire
    with error feedback tracks the float32 reduce-scatter run within rtol
    0.05 and its loss falls by more than 0.2; the residual carries state
    (non-zero, each rank its own)."""
    runs = world2["ef"]
    for a, b in zip(runs["f32"], runs["int8"]):
        assert np.isfinite(b["losses"]).all()
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=0.05)
        assert b["losses"][-1] < b["losses"][0] - 0.2
        assert np.abs(b["opt"]["ef"]).max() > 0
    assert not np.array_equal(runs["int8"][0]["opt"]["ef"],
                              runs["int8"][1]["opt"]["ef"])
