"""The fluid mesh of the port against ``paddle_tpu``'s, on the CPU:
``CompiledProgram.with_data_parallel``, per-rank programs with ``c_*``
ops, ``sync_batch_norm``, ``dgc_momentum`` over dp and gradient merge
over dp.

The port's ranks are one gloo world of two CPU processes
(``tests/torch_dist_worker.py``), spawned once for the file; every rank
runs ``Executor.run`` with the global batch and takes its own rows. The
JAX side runs in this process on the conftest's 8 virtual devices, from
its own startup, whose persistables start the port
(``scope_from_numpy``). The bands are the reference's own:

- data parallel: the port's dp-2 run against the JAX package's
  data-parallel run and its single-device run, losses and every
  persistable within rtol 2e-4, atol 2e-5 (the MLP, the conv + batch
  norm net in float32 and under bf16 ``decorate``, the small encoder);
- a per-rank program's ``c_*`` ops against numpy sums (the JAX package's
  per-rank path raises here under jax 0.9.0, so numpy is the oracle, as
  in ``tests/test_data_parallel.py``), their gradients too;
- ``sync_batch_norm`` (with the gradients averaged by ``c_allreduce_avg``,
  as a collective transpile inserts it) against the global batch on one
  device: rtol 5e-4, atol 5e-5 (``tests/test_sync_bn.py``);
- ``dgc_momentum`` over dp: keep-all against single-device SGD (rtol
  1e-4, atol 1e-5, ``tests/test_dgc_halfasync.py``), sparse against the
  JAX package's per-rank run on two devices;
- gradient merge over dp against the JAX package's merge under its
  data-parallel plan and the single-device run
  (``test_parallel_compose.py``: rtol 2e-4, atol 1e-5);
- a loss made by neither a mean nor a sum, and another op reducing over
  the batch or mixing its rows, are refused by name.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as JUN
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.testing import mesh_feed, mesh_program, state_gap

import torch_dist_worker as W

STEPS = 3
DP_TOL = dict(rtol=2e-4, atol=2e-5)
AMP_TOL = dict(rtol=2e-3, atol=2e-4)


def _persistables(main):
    return [n for n, v in main.global_block().vars.items() if v.persistable]


def _jax_run(kw, feed, start=None, how="single", places=None,
             steps=STEPS):
    """(the start state, each step's fetched loss, the persistables after)
    of ``mesh_program(**kw)`` in the JAX package: its startup (or
    ``start``), then ``steps`` runs of the program ("single") or of its
    ``with_data_parallel`` ("dp", over ``places`` or every device)."""
    main, startup, loss = mesh_program(fluid, JUN, **kw)
    exe, scope = fluid.Executor(fluid.XLAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    names = [n for n in _persistables(main) if scope.find_var(n) is not None]
    if start is not None:
        for n in names:
            if n in start:
                scope.set_var(n, jnp.asarray(start[n]))
    first = {n: np.array(scope.find_var(n)) for n in names}
    target = main
    if how == "dp":
        target = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=places)
    losses = [np.asarray(exe.run(target, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]) for _ in range(steps)]
    return first, losses, {n: np.array(scope.find_var(n)) for n in names}


def _close(got, want, names=None, **tol):
    for n in (names or want):
        np.testing.assert_allclose(np.asarray(got[n], np.float64),
                                   np.asarray(want[n], np.float64),
                                   err_msg=n, **tol)


def _losses(runs):
    return [float(np.mean(r[0])) for r in runs]


# the data-parallel cases: name -> mesh_program kwargs
DP_CASES = {
    "mlp": dict(net="mlp"),
    "conv_bn": dict(net="conv_bn", opt="momentum", lr=0.1),
    "conv_bn_amp": dict(net="conv_bn", opt="momentum", lr=0.1, amp=True),
    "encoder": dict(net="encoder", opt="momentum", lr=0.1),
}
MERGE = dict(net="mlp", wrap="merge", k=2)
SYNC_BN = dict(net="bn_square", lr=0.01)
DGC = {"dgc_keep": dict(net="classifier", opt="dgc_keep", lr=0.1),
       "dgc_sparse": dict(net="classifier", opt="dgc_sparse", lr=0.1)}
COLL_X = np.random.RandomState(5).randn(4, 4).astype(np.float32)
COLL_W = np.random.RandomState(6).randn(4, 1).astype(np.float32)
COLL_LR = 0.1


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side of every case, then every port case on one world of
    two ranks: name -> (the JAX record(s), the ranks' results)."""
    jobs, jax_side = [], {}
    for name, kw in DP_CASES.items():
        feed = mesh_feed(kw["net"], 16)
        start, single_l, single_s = _jax_run(kw, feed)
        _, dp_l, dp_s = _jax_run(kw, feed, start, how="dp")
        jax_side[name] = (single_l, single_s, dp_l, dp_s)
        jax_side[name + "/start"] = start
        fetch = ("x",) if kw["net"] == "mlp" else ()
        jobs.append((name, "fluid_mesh_worker",
                     (kw, start, feed, STEPS, "dp", fetch)))
    feed = mesh_feed("mlp", 16)
    start, single_l, single_s = _jax_run(dict(net="mlp"), feed)
    _, merge_l, merge_s = _jax_run(MERGE, feed, start, how="dp")
    jax_side["merge"] = (single_l, single_s, merge_l, merge_s)
    jobs.append(("merge", "fluid_mesh_worker",
                 (MERGE, start, feed, STEPS, "dp")))
    feed = mesh_feed("bn_square", 32, seed=3)
    start, single_l, single_s = _jax_run(SYNC_BN, feed)
    jax_side["sync_bn"] = (single_l, single_s)
    jobs.append(("sync_bn", "fluid_mesh_worker",
                 (dict(SYNC_BN, sync_grads=True), start, feed, STEPS,
                  "dp_sync")))
    feed = mesh_feed("classifier", 32, seed=7)
    for name, kw in DGC.items():
        start, dgc_l, dgc_s = _jax_run(kw, feed, how="dp",
                                       places=[0, 1])
        sgd = _jax_run(dict(net="classifier", lr=0.1), feed, start)
        jax_side[name] = (dgc_l, dgc_s, sgd[1], sgd[2])
        jobs.append((name, "fluid_mesh_worker",
                     (kw, start, feed, STEPS, "dp")))
    jobs.append(("collectives", "collective_ops_worker",
                 (COLL_X, COLL_W, COLL_LR)))
    ranks = W.spawn(W.jobs_worker, 2, [j[1:] for j in jobs],
                    out_dir=str(tmp_path_factory.mktemp("mesh2")),
                    timeout=150)
    out = {name: (jax_side.get(name), [r[i] for r in ranks])
           for i, (name, _, _) in enumerate(jobs)}
    out.update({k: v for k, v in jax_side.items() if k.endswith("/start")})
    return out


def _port_single(kw, feed, start, steps=STEPS):
    """Each step's loss and the persistables after, of the port's own
    single-device run of ``mesh_program(**kw)`` from ``start``."""
    main, _startup, loss = mesh_program(T, TUN, **kw)
    exe, scope = T.Executor(T.CPUPlace()), T.scope_from_numpy(start,
                                                               T.CPUPlace())
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, {n: scope.find_var(n).float().numpy() for n in start}


@pytest.mark.parametrize("name", sorted(DP_CASES))
def test_with_data_parallel_matches_jax(world, name):
    """Losses and every persistable of the port's dp-2 run equal the JAX
    package's data-parallel run (8 devices) and its single-device run,
    on every rank; a fetched batch var comes back whole. Under bf16 AMP
    the port's dp run is held to the port's single-device run in that
    band, and to the JAX runs, in the bf16 band ``AMP_TOL`` (losses
    relative; each persistable's max |diff| over the larger of its
    largest |value| and 1, measured at most 2.5e-4): a float32
    statistic summed in another order flips bf16 roundings, which moves
    the JAX package's own dp loss 2.3e-4 from its single-device loss at
    the second step here, and the port's by as much (measured)."""
    (single_l, single_s, dp_l, dp_s), ranks = world[name]
    amp = DP_CASES[name].get("amp")
    # the reference's own dp run against its single-device run
    np.testing.assert_allclose(dp_l, single_l, **(AMP_TOL if amp
                                                  else DP_TOL))
    if amp:
        kw = DP_CASES[name]
        own_l, own_s = _port_single(kw, mesh_feed(kw["net"], 16),
                                    world[name + "/start"])
        for rank in ranks:
            got = _losses(rank["runs"])
            for want_l, want_s in ((own_l, own_s), (single_l, single_s)):
                np.testing.assert_allclose(
                    got, [float(np.mean(v)) for v in want_l], **AMP_TOL)
                worst, n = state_gap(rank["state"], want_s)
                assert worst <= AMP_TOL["rtol"], (n, worst)
        return
    for rank in ranks:
        got = _losses(rank["runs"])
        np.testing.assert_allclose(got, [float(np.mean(v)) for v in dp_l],
                                   **DP_TOL)
        np.testing.assert_allclose(got, [float(np.mean(v)) for v in single_l],
                                   **DP_TOL)
        _close(rank["state"], dp_s, **DP_TOL)
        _close(rank["state"], single_s, **DP_TOL)
        if name == "mlp":
            np.testing.assert_array_equal(rank["runs"][0][1],
                                          mesh_feed("mlp", 16)["x"])


def test_grad_merge_over_dp_matches_jax(world):
    (single_l, single_s, merge_l, merge_s), ranks = world["merge"]
    for rank in ranks:
        got = _losses(rank["runs"])
        np.testing.assert_allclose(got, [float(np.mean(v)) for v in merge_l],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got, [float(np.mean(v)) for v in single_l],
                                   rtol=2e-4, atol=1e-5)
        _close(rank["state"], merge_s, ["w1", "w2", "w3"],
               rtol=2e-4, atol=1e-5)
        _close(rank["state"], single_s, ["w1", "w2", "w3"],
               rtol=2e-4, atol=1e-5)


def test_sync_batch_norm_matches_global_batch(world):
    """Per-rank ``sync_batch_norm`` (``BuildStrategy(sync_batch_norm=
    True)``) with the gradients averaged: the mean of the ranks' losses,
    the parameters and the moving statistics equal the single-device run
    on the global batch."""
    (single_l, single_s), ranks = world["sync_bn"]
    for rank in ranks:
        got = [float(np.mean(r[0])) for r in rank["runs"]]
        assert all(r[0].shape == (2,) for r in rank["runs"])
        np.testing.assert_allclose(got, [float(np.mean(v)) for v in single_l],
                                   rtol=5e-4, atol=5e-5)
        _close(rank["state"], single_s, rtol=5e-4, atol=5e-5)
    stats = [n for n in single_s if n.endswith(("w_1", "w_2"))]
    assert stats and not np.allclose(single_s[stats[0]], 0.0)


def test_dgc_over_dp_matches_jax(world):
    """Keep-all DGC over dp steps as single-device SGD; sparse DGC over
    dp as the JAX package's per-rank run on two devices (each rank's
    top-k of its own accumulation, the sparse gradients averaged, rank
    0's U and V kept)."""
    (dgc_l, dgc_s, sgd_l, sgd_s), ranks = world["dgc_keep"]
    for rank in ranks:
        got = [np.asarray(r[0]) for r in rank["runs"]]
        assert all(g.shape == (2,) for g in got)
        np.testing.assert_allclose([g.mean() for g in got],
                                   [float(np.mean(v)) for v in sgd_l],
                                   rtol=1e-4, atol=1e-5)
        params = [n for n in sgd_s if n.startswith("fc_")]
        _close(rank["state"], sgd_s, params, rtol=1e-4, atol=1e-5)
    (dgc_l, dgc_s, _, _), ranks = world["dgc_sparse"]
    params = [n for n in dgc_s if n.startswith("fc_") and "_dgc_" not in n]
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(np.stack([r[0] for r in rank["runs"]]),
                                   np.stack(dgc_l), rtol=1e-4, atol=1e-5)
        # the scope of the reference shows device 0's U and V
        _close(rank["state"], dgc_s, None if r == 0 else params,
               rtol=1e-4, atol=1e-5)


def test_per_rank_collective_ops_match_numpy(world):
    _, ranks = world["collectives"]
    x0, x1 = COLL_X[:2], COLL_X[2:]
    s = x0 + x1
    want = {
        "sum": np.concatenate([s, s]),
        "max": np.concatenate([np.maximum(x0, x1)] * 2),
        "min": np.concatenate([np.minimum(x0, x1)] * 2),
        "prod": np.concatenate([x0 * x1] * 2),
        "avg": np.concatenate([s / 2] * 2),
        "allgather": np.concatenate([COLL_X, COLL_X]),
        "reducescatter": s,
        "broadcast": np.concatenate([x1, x1]),
        "c_concat": np.concatenate([np.concatenate([x0, x1], 1)] * 2),
        "c_split": np.concatenate([x0[:, :2], x1[:, 2:]]),
        "c_identity": COLL_X,
        "legacy_allreduce": np.concatenate([np.maximum(x0, x1)] * 2),
        "legacy_broadcast": np.concatenate([x1, x1]),
    }
    # mean(c_allreduce_sum(x_r @ w)) on each rank: the sum's cotangent
    # all-reduced, 2 ranks x 1/2 a row, so rank r steps by its own rows'
    # sum (no collective syncs the update: each rank keeps its own w)
    loss = float(np.mean(s @ COLL_W))
    for r, rank in enumerate(ranks):
        for k, v in want.items():
            np.testing.assert_allclose(rank["fetch"][k], v, rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(rank["loss"], [loss, loss], rtol=1e-6)
        xr = COLL_X[2 * r:2 * r + 2]
        np.testing.assert_allclose(
            rank["w"], COLL_W - COLL_LR * xr.sum(0)[:, None], rtol=1e-6,
            atol=1e-7)


def test_mesh_annotation_takes_the_per_rank_plan(world):
    """A program whose ``_annotations["mesh"]`` names the per-rank plan
    runs on it through a plain ``Executor.run``: every fetch equals the
    one ``with_data_parallel`` gives the same program."""
    _, ranks = world["collectives"]
    for rank in ranks:
        assert set(rank["annotated"]) == set(rank["fetch"])
        for k, v in rank["fetch"].items():
            np.testing.assert_array_equal(rank["annotated"][k], v,
                                          err_msg=k)


def test_collective_ops_are_identities_on_one_rank():
    """Outside a mesh every c_* op is the identity, as on a ring of one;
    a CompiledProgram without a world is the plain run."""
    from paddle_tpu_torch.layers import collective as C

    with TUN.guard():
        main, startup = T.Program(), T.Program()
        with T.program_guard(main, startup):
            x = T.layers.data("x", [4], dtype="float32")
            outs = [C._c_allreduce(x, reduce_type=k)
                    for k in ("sum", "max", "prod", "avg")]
            outs += [C._c_allgather(x, 1), C._c_broadcast(x, 0)]
    got = T.Executor(T.CPUPlace()).run(
        T.CompiledProgram(main).with_data_parallel(), feed={"x": COLL_X},
        fetch_list=outs, scope=T.Scope())
    for g in got:
        np.testing.assert_array_equal(g, COLL_X)
    assert T.CompiledProgram(main).with_data_parallel().num_devices == 1
    assert T.CompiledProgram(main).with_data_parallel(
        places=[T.CPUPlace()] * 3).num_devices == 3


@pytest.mark.parametrize("loss_op,what", [
    ("scale", "the loss 'scale_0.tmp_0' is made by op 'scale'"),
    ("batch_sum", "op 'reduce_sum' .* reduces over the batch dim"),
    ("in_batch", "op 'matmul' .* mixes its rows"),
    ("batch_softmax", "op 'softmax' .* mixes its rows")])
def test_data_parallel_refuses_other_reductions(loss_op, what):
    """A loss made by neither a mean nor a sum, and another op reducing
    over the batch or mixing its rows (a product with the batch
    transposed, a softmax along it), raise ``NotImplementedError`` naming
    the op (the plan is built before any rank is asked for)."""
    main, startup, loss = mesh_program(T, TUN, net="mlp", loss_op=loss_op)
    exe, scope = T.Executor(T.CPUPlace()), T.Scope()
    exe.run(startup, scope=scope)
    prog = T.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    with pytest.raises(NotImplementedError, match=what):
        exe.run(prog, feed=mesh_feed("mlp", 8), fetch_list=[loss],
                scope=scope)


def test_sync_batch_norm_rewrite_and_local_fallback():
    """``BuildStrategy(sync_batch_norm=True)`` rewrites both directions;
    outside a mesh the op uses local statistics, as the reference's."""
    from paddle_tpu_torch.framework.compiler import rewrite_sync_batch_norm

    feed = mesh_feed("bn_square", 16, seed=3)
    runs = []
    for sync in (False, True):
        main, startup, loss = mesh_program(T, TUN, **SYNC_BN)
        if sync:
            rewrite_sync_batch_norm(main)
            types = [op.type for op in main.global_block().ops]
            assert "sync_batch_norm" in types and "batch_norm" not in types
            assert "sync_batch_norm_grad" in types
        exe, scope = T.Executor(T.CPUPlace()), T.Scope()
        exe.run(startup, scope=scope)
        runs.append([float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0]) for _ in range(3)])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)
