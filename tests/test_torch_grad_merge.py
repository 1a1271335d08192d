"""``GradientMergeOptimizer`` (batch-merge) in the port against
``paddle_tpu``'s, on the CPU; ported from the reference's
``tests/test_grad_merge.py``.

- k microbatches merged train as the whole batch fed at once (the
  reference's test: losses and weights within rtol 2e-4, atol 1e-5), and
  as the reference's merge does (losses 1e-6 relative, every persistable
  within 1e-6 of its scale; measured at most 1.8e-7).
- A batch k does not divide, and data feeds of two batch sizes, are
  refused with the reference's ``ValueError``s.
- Batch norm's statistics, written in the forward, thread through the
  microbatches in order, and a forward fetch comes from the last
  microbatch: both as the reference's.
- The fused ``Momentum`` under bf16 AMP, and ``RecomputeOptimizer(Lamb)``,
  merged as the reference merges them: the optimizer tail (the AMP
  check and the fused update) runs once a step.
- A per-rank mesh plan with an axis besides dp is refused with the
  reference's ``NotImplementedError``.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as JMP
from paddle_tpu.framework import unique_name as JUN
import paddle_tpu_torch as T
from paddle_tpu_torch.contrib import mixed_precision as TMP
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.parallel.grad_merge import GradMergeBlock
from paddle_tpu_torch.testing import state_gap

from test_torch_fluid_program import _assert_same_desc

TOL = 1e-6


def _build(pk, un, merge_k=None, seed=21, opt="momentum", bn=False,
           amp=False):
    """The reference test's classifier (fc 16 relu, fc 4, softmax CE)
    under Momentum(0.1, 0.9); ``opt`` "fused" its fused form, "lamb"
    ``RecomputeOptimizer(Lamb(0.01))`` with the hidden output as the
    checkpoint; ``bn`` a batch norm before the relu; ``amp`` bf16 AMP.
    Returns (main, startup, loss, the softmax)."""
    MP = {fluid: JMP, T: TMP}[pk]
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = seed
        with pk.program_guard(main, startup):
            x = pk.layers.data("x", [8], dtype="float32")
            y = pk.layers.data("y", [1], dtype="int64")
            h = pk.layers.fc(x, 16)
            if bn:
                h = pk.layers.batch_norm(h)
            h = pk.layers.relu(h)
            logits = pk.layers.fc(h, 4)
            prob = pk.layers.softmax(logits)
            loss = pk.layers.reduce_mean(
                pk.layers.softmax_with_cross_entropy(logits, y))
            if opt == "lamb":
                inner = pk.optimizer.RecomputeOptimizer(
                    pk.optimizer.Lamb(0.01))
                inner._set_checkpoints([h])
            else:
                inner = pk.optimizer.Momentum(0.1, 0.9,
                                              fuse=opt == "fused")
            if amp:
                inner = MP.decorate(inner, use_bf16=True)
            if merge_k:
                pk.optimizer.GradientMergeOptimizer(
                    inner, k_steps=merge_k).minimize(loss)
            else:
                inner.minimize(loss)
    return main, startup, loss, prob


def _feed(rows=32):
    rng = np.random.RandomState(3)
    xb = rng.rand(rows, 8).astype("float32")
    return {"x": xb,
            "y": xb[:, :4].argmax(1).astype("int64").reshape(-1, 1)}


def _train_port(merge_k, steps=6):
    main, startup, loss, _ = _build(T, TUN, merge_k)
    exe, scope = T.Executor(T.CPUPlace()), T.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=_feed(), fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(steps)]
    return losses, scope.find_var("fc_0.w_0").numpy()


def test_grad_merge_matches_full_batch():
    ref_losses, ref_w = _train_port(None)
    for k in (2, 4):
        ml, mw = _train_port(k)
        np.testing.assert_allclose(ml, ref_losses, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(mw, ref_w, rtol=2e-4, atol=1e-5)


def _against_jax(steps=3, fetch_prob=False, **kw):
    """Build both, start the port from the JAX startup's persistables,
    run ``steps`` merged steps (k 2) of a 16-row feed in both: losses
    (and the last step's softmax) within 1e-6, every persistable within
    1e-6 of its scale. Returns the JAX and port scopes."""
    jm, js, jl, jp = _build(fluid, JUN, 2, seed=4, **kw)
    tm, _ts, tl, tp = _build(T, TUN, 2, seed=4, **kw)
    _assert_same_desc(jm, tm)
    exe = fluid.Executor(fluid.XLAPlace(0))
    jscope = fluid.Scope()
    exe.run(js, scope=jscope)
    names = [n for n, v in jm.global_block().vars.items()
             if v.persistable and jscope.find_var(n) is not None]
    tscope = T.scope_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, T.CPUPlace())
    texe = T.Executor(T.CPUPlace())
    feed = _feed(16)
    feed["x"] = feed["x"] * 3 + 1
    fetch = [jl, jp] if fetch_prob else [jl]
    for _ in range(steps):
        a = exe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        b = texe.run(tm, feed=feed, fetch_list=[v.name for v in fetch],
                     scope=tscope)
        np.testing.assert_allclose(b[0], np.asarray(a[0]), rtol=TOL)
    if fetch_prob:
        assert b[1].shape == (8, 4)      # the last microbatch's rows
        np.testing.assert_allclose(b[1], np.asarray(a[1]), rtol=0,
                                   atol=TOL)
    worst, name = state_gap(
        {n: tscope.find_var(n).float().numpy() for n in names},
        {n: np.asarray(jscope.find_var(n), np.float32) for n in names})
    assert worst <= TOL, (name, worst)
    return jscope, tscope


def test_grad_merge_matches_jax():
    _against_jax()


def test_grad_merge_batch_norm_stats_and_extra_fetch():
    """The moving mean and variance move over the merged steps, equal to
    the reference's; the softmax fetched is the last microbatch's."""
    _jscope, tscope = _against_jax(steps=2, fetch_prob=True, bn=True)
    mean = tscope.find_var("batch_norm_0.w_1").numpy()
    assert np.abs(mean).max() > 0


@pytest.mark.parametrize("kw", [dict(opt="fused"),
                                dict(opt="fused", bn=True, amp=True),
                                dict(opt="lamb")],
                         ids=["momentum_fused", "momentum_fused_bn_amp",
                              "recompute_lamb"])
def test_merged_optimizers_match_jax(kw):
    _against_jax(**kw)


def test_tail_runs_once_a_step():
    """Under bf16 AMP the tail (``check_finite_and_unscale`` and the fused
    momentum, ``__opt_tail__``) runs once a step and the region twice:
    the loss scale stays 1.0, the overflow flag false."""
    from paddle_tpu_torch.framework import registry

    main, startup, loss, _ = _build(T, TUN, 2, opt="fused", amp=True)
    exe, scope = T.Executor(T.CPUPlace()), T.Scope()
    exe.run(startup, scope=scope)
    calls = {"fused_momentum": 0, "check_finite_and_unscale": 0, "mul": 0}
    saved = {t: registry.get_op_spec(t).lower for t in calls}

    def counted(t):
        def lower(ctx, op, ins):
            calls[t] += 1
            return saved[t](ctx, op, ins)
        return lower

    try:
        for t in calls:
            registry.get_op_spec(t).lower = counted(t)
        exe.run(main, feed=_feed(16), fetch_list=[loss], scope=scope)
    finally:
        for t, fn in saved.items():
            registry.get_op_spec(t).lower = fn
    assert calls == {"fused_momentum": 1, "check_finite_and_unscale": 1,
                     "mul": 4}
    assert float(scope.find_var("loss_scaling_0")[0]) == 1.0
    assert not bool(scope.find_var("find_infinite_scale_0")[0])


def test_grad_merge_rejects_indivisible():
    main, startup, loss, _ = _build(T, TUN, merge_k=3)
    exe, scope = T.Executor(T.CPUPlace()), T.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="not divisible by k_steps 3"):
        exe.run(main, feed=_feed(32), fetch_list=[loss], scope=scope)
    feed = _feed(30)
    feed["y"] = feed["y"][:15]
    with pytest.raises(ValueError, match="must share the batch dimension"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    jm, js, jl, _ = _build(fluid, JUN, merge_k=3)
    jexe, jscope = fluid.Executor(fluid.XLAPlace(0)), fluid.Scope()
    jexe.run(js, scope=jscope)
    with pytest.raises(ValueError, match="not divisible by k_steps 3"):
        jexe.run(jm, feed=_feed(32), fetch_list=[jl], scope=jscope)


def test_a_mesh_on_the_merge_block_is_refused():
    """The merge block composes with one data-parallel axis: a per-rank
    mesh plan with another axis is refused with the reference's
    ``NotImplementedError`` (``paddle_tpu/parallel/grad_merge.py``), as
    is one without a data axis; the data-parallel plan is taken."""
    from paddle_tpu_torch.framework.executor import MeshPlan

    main, _startup, loss, _ = _build(T, TUN, merge_k=2)
    assert main._annotations["grad_merge"]["k"] == 2
    plan = MeshPlan(mode="shard_map", axes=(("dp", 2), ("tp", 2)),
                    data_axis="dp", ring_axes={0: "dp"})
    with pytest.raises(NotImplementedError, match=(
            r"gradient merge composes with a single data-parallel axis; "
            r"mesh plan has axes \(\('dp', 2\), \('tp', 2\)\) "
            r"data_axis=dp")):
        GradMergeBlock(main, [loss.name], mesh_plan=plan)
    with pytest.raises(NotImplementedError, match="single data-parallel"):
        GradMergeBlock(main, [loss.name], mesh_plan=MeshPlan(
            mode="shard_map", axes=(("dp", 2),), data_axis=None))
    block = GradMergeBlock(main, [loss.name], mesh_plan=MeshPlan(
        mode="gspmd", axes=(("dp", 2),), data_axis="dp",
        ring_axes={0: "dp"}))
    assert block.mode == "gspmd" and block.mean
