"""The port's ``ShardedCheckpointer`` (on ``torch.distributed.checkpoint``)
held to the reference's by behaviour and restored values
(``tests/test_sharded_checkpoint.py``): on a gloo world of 4 on the CPU a
same-layout round trip is bitwise, a (dp 2, tp 2) save restores at
(dp 4, tp 1) and at (dp 1, tp 4) with every leaf the saved one's block,
the (dp 2, tp 2) Megatron and fsdp saves restore whole at dp 1 (one
process) bitwise, and a save without a mesh in the world is refused;
step selection (``keep_last``, ``gc`` of debris, uncommitted steps
skipped, ``latest_step``) and an async save joined by ``wait`` on one
process. The params come from the JAX ``init_params``, through numpy.
"""
import os

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import gpt as JG

from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.parallel import checkpoint as C
from paddle_tpu_torch.parallel import parallelize as TPZ
from paddle_tpu_torch.sharding import make_gpt_plan

import torch_dist_worker as W

CFG_KW = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=32, d_ff=64)


@pytest.fixture(scope="module")
def params_np():
    cfg = JG.GPT_TINY.scaled(**CFG_KW)
    return jax.tree_util.tree_map(
        np.asarray, JG.init_params(jax.random.PRNGKey(2), cfg))


def _full_state(params_np):
    """The whole state the ranks saved, made on this process."""
    params = TG.params_from_numpy(params_np, device="cpu")
    return W.ckpt_state(params, None)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, params_np):
    d = str(tmp_path_factory.mktemp("ckpt"))
    ranks = W.spawn(W.sharded_ckpt_worker, 4, CFG_KW, params_np, d,
                    out_dir=str(tmp_path_factory.mktemp("world4")))
    return d, ranks


def _block(x, spec, coords, sizes):
    for dim, entry in enumerate(spec):
        if entry is None or sizes[entry] == 1:
            continue
        n = x.shape[dim] // sizes[entry]
        i = coords[entry]
        x = x[(slice(None),) * dim + (slice(i * n, (i + 1) * n),)]
    return x


def test_same_layout_round_trip_is_bitwise(world4):
    _, ranks = world4
    assert all(r["same"] for r in ranks)
    assert all(r["latest"] == 3 for r in ranks)


@pytest.mark.parametrize("target", ["dp4", "tp4"])
def test_reshard_on_restore(world4, params_np, target):
    """dp 2 x tp 2 -> dp 4 x tp 1 and dp 1 x tp 4: each rank's leaves are
    its blocks of the saved leaves, bitwise (bf16 moments as raw words)."""
    _, ranks = world4
    specs = TG.param_specs(TG.GPT_TINY.scaled(**CFG_KW), pp="pp", tp="tp")
    want = W._host_leaves(_full_state(params_np))
    spec_of = dict(C.flatten_with_keys(
        {"params": specs, "opt": {"m": specs, "v": specs}},
        is_leaf=lambda x: isinstance(x, tuple)))
    sizes = {"dp": 4, "pp": 1, "tp": 1} if target == "dp4" else \
        {"dp": 1, "pp": 1, "tp": 4}
    for r in ranks:
        rec = r[target]
        got = dict(rec["leaves"])
        assert list(got) == [k for k, _ in want]
        for key, full in want:
            exp = _block(full, spec_of.get(key, ()), rec["coords"], sizes)
            np.testing.assert_array_equal(got[key], exp, err_msg=key)


@pytest.mark.parametrize("which", ["megatron", "fsdp"])
def test_restore_whole_at_dp1(world4, params_np, which):
    """A save by the 4 ranks restores on one process, without a process
    group, as the whole leaves, bitwise."""
    d, ranks = world4
    want = _full_state(params_np)
    ck = C.ShardedCheckpointer(os.path.join(d, which), use_async=False)
    assert ck.all_steps() == ([3] if which == "megatron" else [1])
    got = ck.restore(ck.latest_step(), C.abstract_like(want))
    for (k, a), (_, b) in zip(W._host_leaves(got), W._host_leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    if which == "fsdp":
        cfg = TG.GPT_TINY.scaled(**CFG_KW)
        plan = make_gpt_plan(cfg, TPZ.ParallelConfig(dp=2, tp=2), "fsdp")
        total = TPZ.resident_bytes(TG.params_from_numpy(params_np,
                                                        device="cpu"))
        tail = 4 * sum(int(np.prod(sh)) for sh, s in zip(
            TPZ.flat_leaves(TG.param_shapes(cfg)),
            TPZ.flat_leaves(plan.param_specs)) if "dp" not in s)
        assert all(r["fsdp_local_bytes"] <= total / 2 + tail for r in ranks)


def test_save_without_mesh_in_a_world_is_refused(world4):
    """A checkpointer without a mesh in a world of 4 raises on every rank
    (each would write the same files) and writes no step."""
    _, ranks = world4
    for r in ranks:
        assert r["no_mesh"] is not None and "mesh=" in r["no_mesh"], r
        assert r["no_mesh_steps"] == []


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g),
            "m": torch.randn(8, 4, generator=g).bfloat16(),
            "step": torch.tensor(seed, dtype=torch.int32)}


def test_keep_last_gc_and_uncommitted_steps(tmp_path):
    ck = C.ShardedCheckpointer(tmp_path / "ck", use_async=False)
    for step in range(1, 5):
        ck.save(step, _state(step), keep_last=2)
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    # debris: a save killed before its metadata landed
    junk = tmp_path / "ck" / "step_00000009"
    junk.mkdir()
    (junk / "__0_0.distcp").write_bytes(b"partial")
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    with pytest.raises(C.CheckpointError, match=r"\[3, 4\]"):
        ck.restore(9, C.abstract_like(_state(0)))
    with pytest.raises(C.CheckpointError, match="committed"):
        ck.save(4, _state(4))
    ck.save(4, _state(7), force=True)
    got = ck.restore(4, C.abstract_like(_state(0)))
    assert all(torch.equal(got[k], v) for k, v in _state(7).items())
    removed = ck.gc()
    assert removed == [str(junk)] and not junk.exists()
    assert ck.gc(keep_last=1) == [str(tmp_path / "ck" / "step_00000003")]
    assert ck.all_steps() == [4]


def test_async_save_snapshots_before_returning(tmp_path):
    """The async save copies the state before it returns: updating it in
    place while the write is in flight (the port's step updates params and
    moments in place) does not reach the checkpoint; ``wait`` joins."""
    ck = C.ShardedCheckpointer(tmp_path / "ck", use_async=True)
    state = _state(1)
    want = {k: v.clone() for k, v in state.items()}
    ck.save(1, state)
    for v in state.values():
        v.add_(1)
    ck.wait()
    assert ck.latest_step() == 1
    got = ck.restore(1, C.abstract_like(want))
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert got["m"].dtype == torch.bfloat16 and got["step"].dtype == \
        torch.int32
    ck.close()
