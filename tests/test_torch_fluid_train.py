"""Fluid training in the port against ``paddle_tpu``'s executor, on the CPU.

The same program is built in both packages (``test_torch_fluid_program``
holds them equal); the JAX startup program's persistables cross into the
port's scope by ``scope_from_numpy``; both executors train on the same
numpy feeds.

- The MLP of ``tests/test_pallas_fused.py``, 5 steps of each fused
  optimizer (SGD, Momentum, Adam, AdamW): losses within that test's 1e-6;
  parameters and accumulators within 2e-7 of their scale, looser than its
  5e-8 because the port's gradients are not XLA's to the bit (torch's
  CPU matrix products sum in another order: measured at most 8.9e-8 after
  5 steps).
- ResNet-18 at 32², batch 4, class 4, ``Momentum(0.01, 0.9, fuse=True)``,
  3 steps, each from the JAX executor's state before it: losses within
  1e-5 relative (measured at most 2.9e-6), parameters, BN statistics and
  the velocity each within 2e-4 of its scale (measured at most 8.7e-5:
  the step-1 gradients of the batch-4 BN network differ by that much from
  the convolutions' summation order). Run freely instead, the two
  trajectories part — at step 2 the losses differ by 3.3e-4 and at step
  3 by 7.3e-3 relative (lr 0.01; more at lr 0.001), as BN over 4 samples
  at 1x1 amplifies ulp-level differences — so each step starts from the
  reference's state.
- Routing: on the CPU the fused ops take the kernels' plain versions, and
  ``FLAGS_fuse_optimizer_pallas=False`` the unfused expression; both give
  the same bits.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as JUN
from paddle_tpu.models import resnet as JR
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.ops import cuda_kernels as CK

from test_torch_fluid_program import FACTORIES, build_mlp, build_resnet


def _persistables(prog):
    return [n for n, v in prog.global_block().vars.items() if v.persistable]


def _jax_start(js, jm):
    exe = fluid.Executor(fluid.XLAPlace(0))
    scope = fluid.Scope()
    exe.run(js, scope=scope)
    return exe, scope, {n: np.asarray(scope.find_var(n))
                        for n in _persistables(jm)}


def _mlp_feed():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((4, 8)).astype(np.float32),
            "y": rng.standard_normal((4, 1)).astype(np.float32)}


def _train_port(tm, loss, state, feed, steps, pallas=None):
    prev = T.get_flags("FLAGS_fuse_optimizer_pallas")
    T.set_flags({"FLAGS_fuse_optimizer_pallas": pallas})
    try:
        scope = T.scope_from_numpy(state, T.CPUPlace())
        exe = T.Executor(T.CPUPlace())
        losses = [float(exe.run(tm, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(steps)]
    finally:
        T.set_flags(prev)
    return losses, {n: scope.find_var(n).numpy() for n in state}


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam", "adamw"])
def test_mlp_trains_like_jax(opt):
    jm, js, jl = build_mlp(fluid, JUN, FACTORIES[opt])
    tm, _ts, tl = build_mlp(T, TUN, FACTORIES[opt])
    exe, scope, state = _jax_start(js, jm)
    feed = _mlp_feed()
    jlosses = [float(np.asarray(exe.run(jm, feed=feed, fetch_list=[jl],
                                        scope=scope)[0]))
               for _ in range(5)]
    CK.reset_launches()
    tlosses, tstate = _train_port(tm, tl, state, feed, 5)
    assert not any(CK.LAUNCHES.values())       # CPU: the plain versions
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=1e-6)
    for n in state:
        want = np.asarray(scope.find_var(n))
        np.testing.assert_allclose(tstate[n], want, rtol=0,
                                   atol=2e-7 * max(np.abs(want).max(), 1.0),
                                   err_msg=n)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam", "adamw"])
def test_fused_routes_agree_on_cpu(opt):
    """The kernel route (plain versions on the CPU) and
    ``FLAGS_fuse_optimizer_pallas=False`` (the unfused expression) train
    to the same bits, as their card counterparts must."""
    tm, ts, tl = build_mlp(T, TUN, FACTORIES[opt])
    exe = T.Executor(T.CPUPlace())
    scope = T.Scope()
    exe.run(ts, scope=scope)
    state = {n: scope.find_var(n).numpy() for n in _persistables(tm)}
    feed = _mlp_feed()
    a_l, a_s = _train_port(tm, tl, state, feed, 3, pallas=None)
    b_l, b_s = _train_port(tm, tl, state, feed, 3, pallas=False)
    assert a_l == b_l
    for n in state:
        np.testing.assert_array_equal(a_s[n], b_s[n], err_msg=n)


def test_resnet18_trains_like_jax():
    jm, js, jl = build_resnet(fluid, JUN, JR, 18, 32, 4, seed=3)
    tm, _ts, tl = build_resnet(T, TUN, TR, 18, 32, 4, seed=3)
    exe, scope, _ = _jax_start(js, jm)
    rng = np.random.default_rng(0)
    feed = {"img": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 4, (4, 1)).astype(np.int64)}
    names = _persistables(jm)
    texe = T.Executor(T.CPUPlace())
    CK.reset_launches()
    for step in range(3):
        tscope = T.scope_from_numpy(
            {n: np.asarray(scope.find_var(n)) for n in names}, T.CPUPlace())
        jloss = float(np.asarray(exe.run(jm, feed=feed, fetch_list=[jl],
                                         scope=scope)[0]))
        tloss = float(texe.run(tm, feed=feed, fetch_list=[tl],
                               scope=tscope)[0])
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        for n in names:     # parameters, BN statistics, the velocity
            want = np.asarray(scope.find_var(n))
            got = tscope.find_var(n).numpy()
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
            assert err <= 2e-4, (step, n, err)
    assert not any(CK.LAUNCHES.values())
