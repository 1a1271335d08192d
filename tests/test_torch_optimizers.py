"""The rest of the fluid optimizers in the port against ``paddle_tpu``'s,
on the CPU.

Each case of ``paddle_tpu_torch.testing.OPTIMIZER_CASES`` builds the same
MLP program in both packages (the same ops, in order, with the same
attrs; the same vars by name and shape), starts the port from the JAX
startup program's persistables (``scope_from_numpy``) and trains 3 steps
on the same numpy feed in both. Bands (each persistable's max |diff|
over the larger of its largest |value| and 1; losses relative):

- elementwise rules: 1e-6, ``test_torch_optim.py``'s band (measured at
  most 5.1e-7, ftrl, whose sigma divides by lr);
- rules that reduce over a whole tensor (lamb's and lars_momentum's
  norms, dpsgd's clip norm, dgc_momentum's top-k threshold): 1e-5, as
  torch sums in another order than XLA (measured at most 1.2e-7).

Then what a scope comparison alone does not show: Adamax's
``beta1_pow_acc`` schedule, Dpsgd's noise by its distribution (torch's
normal bits are not threefry's), DGCMomentum before and after its rampup
step, Lookahead at k = 2, ExponentialMovingAverage's and ModelAverage's
``apply`` / ``restore``.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as JUN
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.testing import (OPTIMIZER_CASES, WRAPPER_CASES,
                                      mlp_feed, optimizer_mlp, state_gap)

ELEMENTWISE_TOL, REDUCTION_TOL = 1e-6, 1e-5
STEPS = 3


def _same_program(jprog, tprog):
    """The same ops in order, and the same vars by name and shape. The
    step counter's dtype is left out: JAX without x64 infers int32 for
    its int64 ``increment``."""
    ja = jprog._desc_dict()["blocks"][0]
    tb = tprog._desc_dict()["blocks"][0]
    assert tb["ops"] == ja["ops"]
    assert [(v["name"], v["shape"]) for v in tb["vars"]] == \
        [(v["name"], v["shape"]) for v in ja["vars"]]


def _persistables(prog, scope):
    return [n for n, v in prog.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None]


def _train_both(build, steps=STEPS):
    """Build the case in both packages, start the port from the JAX
    startup's persistables, train ``steps`` steps on ``mlp_feed()`` in
    both. Returns the losses (``jl``, ``tl``), the persistables after
    (``jstate``, ``tstate``), the scopes, the port's program and each
    package's ``extra`` (``jx``, ``tx``)."""
    jm, js, jl, jx = build(fluid, JUN)
    tm, _ts, tl, tx = build(T, TUN)
    _same_program(jm, tm)
    feed = mlp_feed()
    exe = fluid.Executor(fluid.XLAPlace(0))
    jscope = fluid.Scope()
    exe.run(js, scope=jscope)
    names = _persistables(jm, jscope)
    tscope = T.scope_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, T.CPUPlace())
    texe = T.Executor(T.CPUPlace())
    jl_, tl_ = [], []
    for _ in range(steps):
        out = exe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        jl_.append(float(np.asarray(out[0]).reshape(-1)[0]))
        out = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        tl_.append(float(out[0].reshape(-1)[0]))
    return dict(jl=jl_, tl=tl_, jscope=jscope, tscope=tscope, tm=tm,
                jx=jx, tx=tx,
                jstate={n: np.asarray(jscope.find_var(n)) for n in names},
                tstate={n: tscope.find_var(n).numpy() for n in names})


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_trains_like_jax(case):
    factory, reduces = OPTIMIZER_CASES[case]
    tol = REDUCTION_TOL if reduces else ELEMENTWISE_TOL
    r = _train_both(lambda pk, un: optimizer_mlp(pk, un, factory))
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=tol)
    worst, name = state_gap(r["tstate"], r["jstate"])
    assert worst <= tol, (name, worst)


@pytest.mark.parametrize("case", ["lookahead", "ema", "model_average"])
def test_wrapper_trains_like_jax(case):
    r = _train_both(
        lambda pk, un: optimizer_mlp(pk, un, **WRAPPER_CASES[case]))
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=ELEMENTWISE_TOL)
    worst, name = state_gap(r["tstate"], r["jstate"])
    assert worst <= ELEMENTWISE_TOL, (name, worst)


def test_adamax_beta1_pow_schedule():
    """``beta1_pow_acc`` starts at beta1 and is scaled by beta1 once a
    run, after the updates (``_finish_update``): beta1^(steps + 1)."""
    factory = OPTIMIZER_CASES["adamax"][0]
    r = _train_both(lambda pk, un: optimizer_mlp(pk, un, factory))
    jstate, tstate = r["jstate"], r["tstate"]
    pows = [n for n in tstate if n.endswith("beta1_pow_acc_0")]
    assert len(pows) == 6                     # one a parameter
    assert [op.type for op in r["tm"].global_block().ops[-6:]] == \
        ["scale"] * 6
    for n in pows:
        np.testing.assert_allclose(tstate[n], [0.9 ** (STEPS + 1)],
                                   rtol=1e-6)
        np.testing.assert_array_equal(tstate[n], jstate[n])


def _dpsgd_step(sigma, state=None):
    """One Dpsgd step of a [8, 2048] fc (clip 1, batch 8, lr 0.1) from
    ``state`` (the startup's when None): (the weight's change, the state
    started from, the clipped gradient's scale)."""
    with TUN.guard():
        main, startup = T.Program(), T.Program()
        main.random_seed = startup.random_seed = 3
        with T.program_guard(main, startup):
            x = T.layers.data("x", [8], dtype="float32")
            loss = T.layers.reduce_mean(T.layers.fc(x, 2048))
            T.optimizer.Dpsgd(0.1, clip=1.0, batch_size=8.0,
                              sigma=sigma).minimize(loss)
    exe = T.Executor(T.CPUPlace())
    scope = T.Scope()
    exe.run(startup, scope=scope)
    if state is None:
        state = {n: scope.find_var(n).clone() for n in ("fc_0.w_0",
                                                        "fc_0.b_0")}
    for n, v in state.items():
        scope.set_var(n, v.clone())
    feed = {"x": np.random.default_rng(1).standard_normal(
        (8, 8)).astype(np.float32)}
    exe.run(main, feed=feed, scope=scope)
    return scope.find_var("fc_0.w_0") - state["fc_0.w_0"], state


def test_dpsgd_noise_by_its_distribution():
    """At sigma > 0 the update is the sigma = 0 update plus lr times
    Gaussian noise of std sigma * clip / batch_size: the difference of
    the two steps from one state, over 16384 elements, has mean 0 and
    that std (5 standard errors)."""
    sigma, clip, batch, lr = 2.0, 1.0, 8.0, 0.1
    d0, state = _dpsgd_step(0.0)
    d1, _ = _dpsgd_step(sigma, state)
    noise = (d0 - d1).double() / lr
    n, std = noise.numel(), sigma * clip / batch
    assert abs(noise.mean().item()) < 5 * std / n ** 0.5
    assert abs(noise.std().item() / std - 1) < 5 / (2 * n) ** 0.5


def test_dgc_momentum_before_and_after_rampup():
    """Step 1 (counter 1 < rampup 2) is plain momentum: ``dgc_v`` stays
    0 and ``dgc_u`` is the velocity. At step 2 the DGC branch sends the
    top half of each accumulation (k = max(1, round(numel / 2))) and
    keeps the rest as the residual; both packages agree step by step."""
    factory = OPTIMIZER_CASES["dgc_momentum"][0]
    for steps in (1, 2):
        r = _train_both(lambda pk, un: optimizer_mlp(pk, un, factory),
                        steps=steps)
        jstate, tstate = r["jstate"], r["tstate"]
        vs = [n for n in tstate if "_dgc_v_" in n]
        assert len(vs) == 6
        kept = [np.count_nonzero(tstate[n]) for n in vs]
        if steps == 1:
            assert kept == [0] * 6
            assert all(np.count_nonzero(tstate[n.replace("_dgc_v_",
                                                          "_dgc_u_")])
                       for n in vs)
        else:
            assert sum(kept) > 0
            for n, c in zip(vs, kept):
                numel = tstate[n].size
                assert c <= numel - max(1, round(numel * 0.5)), (n, c)
        worst, name = state_gap(tstate, jstate)
        assert worst <= REDUCTION_TOL, (steps, name, worst)


def test_lookahead_syncs_every_k_steps():
    """k = 2, alpha 0.5: the slow weights start at the initial ones, stay
    after step 1 and move half way at step 2, where the fast weights
    take them; the step counter reads the run."""
    r = _train_both(
        lambda pk, un: optimizer_mlp(pk, un, **WRAPPER_CASES["lookahead"]),
        steps=2)
    jstate, tstate = r["jstate"], r["tstate"]
    slow = [n for n in tstate if n.endswith("@SLOW")]
    assert len(slow) == 6
    for n in slow:
        np.testing.assert_array_equal(tstate[n], tstate[n[:-5]])
    assert int(tstate["@LR_DECAY_COUNTER@"][0]) == 2
    assert state_gap(tstate, jstate)[0] <= ELEMENTWISE_TOL


@pytest.mark.parametrize("case", ["ema", "model_average"])
def test_averages_apply_and_restore(case):
    """``apply`` swaps each trainable parameter for its average in the
    global scope, as the reference's does, and ``restore`` (leaving the
    guard) swaps back; the averages follow decay * ema + (1 - decay) * p
    from 0."""
    r = _train_both(
        lambda pk, un: optimizer_mlp(pk, un, **WRAPPER_CASES[case]))
    jstate, tstate = r["jstate"], r["tstate"]
    jscope, tscope, javg, avg = r["jscope"], r["tscope"], r["jx"], r["tx"]
    params = [p.name for p in r["tm"].global_block().all_parameters()]
    ema_of = {p: p + ".ema" for p in params}
    assert state_gap({e: tstate[e] for e in ema_of.values()},
                     {e: jstate[e] for e in ema_of.values()})[0] <= \
        ELEMENTWISE_TOL
    with fluid.scope_guard(jscope):
        with javg.apply(None):
            japplied = {p: np.asarray(jscope.find_var(p)) for p in params}
    with T.scope_guard(tscope):
        with avg.apply(None):
            applied = {p: tscope.find_var(p).numpy() for p in params}
        restored = {p: tscope.find_var(p).numpy() for p in params}
        avg.apply(None, need_restore=False)
        kept = {p: tscope.find_var(p).numpy() for p in params}
        avg.restore()
        back = {p: tscope.find_var(p).numpy() for p in params}
    for p in params:
        np.testing.assert_array_equal(applied[p], tstate[ema_of[p]])
        np.testing.assert_array_equal(japplied[p], jstate[ema_of[p]])
        np.testing.assert_array_equal(restored[p], tstate[p])
        np.testing.assert_array_equal(kept[p], tstate[ema_of[p]])
        np.testing.assert_array_equal(back[p], tstate[p])


def test_every_reference_name_is_ported_but_pipeline():
    """``paddle_tpu_torch.optimizer`` has every class and alias of the
    reference's ``__all__``, ``PipelineOptimizer`` now among them: the
    two lists are equal."""
    from paddle_tpu import optimizer as JO

    missing = [n for n in JO.__all__ if not hasattr(T.optimizer, n)]
    assert missing == []
    assert T.optimizer.__all__ == JO.__all__
    assert isinstance(T.optimizer.PipelineOptimizer, type)
