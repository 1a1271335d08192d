"""Recompute (``append_backward(checkpoints=)``, ``RecomputeOptimizer``)
in the port against ``paddle_tpu``'s, on the CPU; ported from the
reference's ``tests/test_backward.py`` recompute tests.

- The program: the same ops in order (each re-emitted segment behind its
  ``recompute_barrier``, the ``@RC`` / ``@BAR`` / ``@RCdup`` names, the
  grad ops' descs naming the recomputed values) as the reference's.
- At dropout 0, the loss and every parameter gradient of 3 SGD steps
  within 1e-6 of the reference's (absolute; measured at most 2.3e-8),
  and ``RecomputeOptimizer(Lamb)`` within 1e-5 (the trust ratio's norms).
- With dropout, recompute on and off give the port the same masks,
  losses and gradients (within 1e-6; measured equal): the re-emitted
  dropout repeats the forward's draw.
- The saving is real: the executor records no autograd graph for an op
  of a recomputed segment, only for the re-emitted ops, the tail after
  the last checkpoint and the ops whose outputs are all checkpoints
  (not re-emitted, as in the reference: their graphs hold what their
  backward saves, here tanh's output, the checkpoint itself).
- The fluid encoder with each layer's output as a checkpoint (the card
  lane's program at tiny widths): the layer norm that makes a checkpoint
  is re-emitted writing ``@RCdup``, and recompute on and off agree.
- AMP with Recompute is refused by name in both orders, where the
  reference fails with an ``AttributeError``.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as JMP
from paddle_tpu.framework import unique_name as JUN
import paddle_tpu_torch as T
from paddle_tpu_torch.contrib import mixed_precision as TMP
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.testing import (WRAPPER_CASES, mlp_feed,
                                      optimizer_mlp, state_gap)
from paddle_tpu_torch.tools import train_bench as TB

from test_torch_fluid_program import _assert_same_desc


def _net(pk, un, ckpt, dropout=0.0, opt=None, minimize=True):
    """The reference's ``_build_recompute_net``: three hidden fc layers,
    checkpoints at the first two (``ckpt``), SGD(0.1) or ``opt(pk)``;
    with ``minimize`` False the forward alone, and the hidden outputs
    returned beside it."""
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = 5
        with pk.program_guard(main, startup):
            x = pk.layers.data("x", [8], dtype="float32")
            y = pk.layers.data("y", [1], dtype="float32")
            h1 = pk.layers.fc(x, 16, act="relu")
            if dropout:
                h1 = pk.layers.dropout(h1, dropout_prob=dropout)
            h2 = pk.layers.fc(h1, 16, act="tanh")
            h3 = pk.layers.fc(h2, 16, act="relu")
            pred = pk.layers.fc(h3, 1)
            loss = pk.layers.reduce_mean(pk.layers.square(pred - y))
            if not minimize:
                return main, startup, loss, (h1, h2)
            opt = (opt or (lambda pk: pk.optimizer.SGD(0.1)))(pk)
            if ckpt:
                rec = pk.optimizer.RecomputeOptimizer(opt)
                rec._set_checkpoints([h1, h2])
                rec.minimize(loss)
            else:
                opt.minimize(loss)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(4, 8).astype("float32"),
            "y": rng.rand(4, 1).astype("float32")}


def _grad_names(prog):
    """Each parameter's gradient as its update op reads it."""
    return [op.input("Grad")[0] for op in prog.global_block().ops
            if op.type in ("sgd", "lamb")]


def _run_port(main, startup, loss, state, steps, extra=()):
    """``steps`` steps on the CPU from the startup's state, with the
    arrays of ``state`` (name -> numpy) put over it: each step's loss,
    parameter gradients and ``extra`` fetches."""
    exe = T.Executor(T.CPUPlace())
    scope = T.Scope()
    exe.run(startup, scope=scope)
    for n, v in T.scope_from_numpy(state or {}, T.CPUPlace())._vars.items():
        scope.set_var(n, v)
    out = [exe.run(main, feed=_feed(), fetch_list=[loss, *_grad_names(main),
                                                   *extra], scope=scope)
           for _ in range(steps)]
    return out, scope


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_recompute_program_matches_jax(dropout):
    jm, _, _ = _net(fluid, JUN, True, dropout)
    tm, _, _ = _net(T, TUN, True, dropout)
    _assert_same_desc(jm, tm)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("recompute_barrier") == 2
    names = list(tm.global_block().vars)
    assert any(n.endswith("@RC0") for n in names)
    assert any(n.endswith("@BAR1") for n in names)
    assert any(n.endswith("@RCdup0") for n in names) == bool(dropout)
    assert tm._annotations["recompute_checkpoints"] == \
        jm._annotations["recompute_checkpoints"]


def test_recompute_matches_jax():
    """Dropout 0, SGD: 3 steps from the reference's start state, the
    loss and each parameter's gradient a step."""
    jm, js, jl = _net(fluid, JUN, True)
    tm, ts, tl = _net(T, TUN, True)
    exe = fluid.Executor(fluid.XLAPlace(0))
    jscope = fluid.Scope()
    exe.run(js, scope=jscope)
    state = {p.name: np.asarray(jscope.find_var(p.name))
             for p in jm.global_block().all_parameters()}
    jout = [exe.run(jm, feed=_feed(), fetch_list=[jl, *_grad_names(jm)],
                    scope=jscope) for _ in range(3)]
    tout, _ = _run_port(tm, ts, tl, state, 3)
    for j, t in zip(jout, tout):
        for a, b in zip(j, t):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


def test_recompute_with_dropout_matches_no_recompute():
    """Dropout 0.3 (the same program seed): recompute on and off draw the
    same masks, so their losses and gradients agree over 3 steps; in the
    recompute run the re-emitted dropout's mask is the forward's."""
    runs = {}
    for ckpt in (False, True):
        main, startup, loss = _net(T, TUN, ckpt, dropout=0.3)
        mask = next(op.output("Mask")[0] for op in main.global_block().ops
                    if op.type == "dropout")
        extra = [mask] + ([mask + "@RC0"] if ckpt else [])
        runs[ckpt], _ = _run_port(main, startup, loss, None, 3, extra)
    for off, on in zip(runs[False], runs[True]):
        for a, b in zip(off, on[:len(off)]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(on[-1], on[-2])    # replayed mask
        assert 0 < on[-1].mean() < 1


def test_recompute_lamb_matches_jax():
    """``RecomputeOptimizer(Lamb(0.01))`` on the optimizer cases' MLP
    (dropout 0 here: threefry's masks do not port), 3 steps: losses and
    every persistable within 1e-5."""
    kw = dict(WRAPPER_CASES["recompute_lamb"], dropout=0.0)
    jm, js, jl, _ = optimizer_mlp(fluid, JUN, **kw)
    tm, _ts, tl, _ = optimizer_mlp(T, TUN, **kw)
    _assert_same_desc(jm, tm)
    exe = fluid.Executor(fluid.XLAPlace(0))
    jscope = fluid.Scope()
    exe.run(js, scope=jscope)
    names = [n for n, v in jm.global_block().vars.items() if v.persistable]
    tscope = T.scope_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, T.CPUPlace())
    texe = T.Executor(T.CPUPlace())
    feed = mlp_feed()
    for _ in range(3):
        (a,) = exe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5)
    worst, name = state_gap({n: tscope.find_var(n).numpy() for n in names},
                            {n: np.asarray(jscope.find_var(n))
                             for n in names})
    assert worst <= 1e-5, (name, worst)


def test_recomputed_segments_record_nothing():
    """The executor's plan records an autograd graph for the re-emitted
    ops, the tail after the last checkpoint and the ops that make only
    checkpoints: every other op of a recomputed segment's original
    forward runs without one, so its intermediates are dropped after
    their last forward read."""
    main, startup, loss = _net(T, TUN, True, dropout=0.3)
    _run_port(main, startup, loss, None, 1)
    ops = main.global_block().ops
    n_fwd = next(i for i, op in enumerate(ops)
                 if op.type == "fill_constant"
                 and op.output("Out")[0] == loss.name + "@GRAD")
    ckpts = set(main._annotations["recompute_checkpoints"])
    last_ckpt_op = max(i for i in range(n_fwd)
                       if ckpts & set(ops[i].output_arg_names))
    exe = T.Executor(T.CPUPlace())
    plan, _ = exe._plan(main, [loss.name])
    recorded = sorted(plan.record)
    for i in recorded:
        tail = last_ckpt_op < i < n_fwd
        reemitted = i > n_fwd and ops[i].attr("__rng_names__")
        only_ckpts = set(ops[i].output_arg_names) <= ckpts
        assert tail or reemitted or only_ckpts, (i, ops[i])
    assert sum(1 for i in recorded if i > n_fwd) >= 6
    # each segment's original intermediates die in the forward
    for i in range(last_ckpt_op + 1):
        for n in ops[i].output_arg_names:
            if n in ckpts:
                continue
            freed = [j for j, names in enumerate(plan.free_after)
                     if n in names]
            assert freed and freed[0] < n_fwd, n


def test_encoder_recompute_matches_no_recompute():
    """The card lane's program at tiny widths (2 layers, dropout 0.1,
    Lamb, float32): each layer's output is a checkpoint, its layer norm
    re-emitted writing ``@RCdup``; recompute on and off give the same
    loss and gradients over 2 steps."""
    cfg = TB.ENCODER_TINY
    feed = TB.encoder_batch(cfg, 4, 32, T.CPUPlace().torch_device())
    runs = {}
    for rc in (False, True):
        with TUN.guard():
            main, startup, loss, _lr = TB.encoder_program(
                cfg, 32, dropout=0.1, amp=False, optimizer="lamb",
                recompute=rc)
        if rc:
            ck = TB.encoder_checkpoints(main)
            assert len(ck) == cfg["num_layers"]
            assert all(main.global_block().has_var(v.name + "@RCdup" + str(i))
                       for i, v in enumerate(ck))
        exe, scope = T.Executor(T.CPUPlace()), T.Scope()
        exe.run(startup, scope=scope)
        grads = _grad_names(main)
        runs[rc] = [exe.run(main, feed=feed, fetch_list=[loss, *grads],
                            scope=scope) for _ in range(2)]
    for off, on in zip(runs[False], runs[True]):
        for a, b in zip(off, on):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_encoder_recompute_program_matches_jax():
    """The same lane's program (Lamb, recompute, 2 layers; no dropout or
    bias, which the reference's classifier does not take) built in both
    packages: the same ops and vars."""
    from paddle_tpu.models import transformer_encoder as JTE
    from paddle_tpu_torch.models import transformer_encoder as TTE

    def build(pk, un, TE):
        with un.guard():
            main, startup = pk.Program(), pk.Program()
            with pk.program_guard(main, startup):
                src = pk.layers.data("src", [16], dtype="int64")
                pos = pk.layers.data("pos", [16], dtype="int64")
                label = pk.layers.data("label", [1], dtype="int64")
                loss, _ = TE.transformer_encoder_classifier(
                    src, pos, label, **TB.ENCODER_TINY)
                rec = pk.optimizer.RecomputeOptimizer(pk.optimizer.Lamb(
                    0.01, exclude_from_weight_decay_fn=TB.encoder_no_decay))
                rec._set_checkpoints(TB.encoder_checkpoints(main))
                rec.minimize(loss)
        return main

    ja = build(fluid, JUN, JTE)._desc_dict()["blocks"][0]
    tb = build(T, TUN, TTE)._desc_dict()["blocks"][0]
    assert tb["ops"] == ja["ops"]
    # JAX without x64 infers the barriered int64 ids as int32
    for va, vb in zip(ja["vars"], tb["vars"]):
        if va["dtype"] == "int32" and va["name"].endswith("@BAR0"):
            va = dict(va, dtype="int64")
        assert vb == va


def test_amp_with_recompute_is_refused_by_name():
    """Both orders raise ``NotImplementedError`` naming the refusal in
    the port; the reference fails at ``minimize`` with the
    ``AttributeError`` of each order."""
    for pk, un, MP in ((fluid, JUN, JMP), (T, TUN, TMP)):
        for order in ("decorate_outside", "recompute_outside"):
            main, startup, loss, hidden = _net(pk, un, False,
                                               minimize=False)
            with un.guard(), pk.program_guard(main, startup):
                def make():
                    if order == "decorate_outside":
                        rec = pk.optimizer.RecomputeOptimizer(
                            pk.optimizer.Lamb(0.01))
                        rec._set_checkpoints(list(hidden))
                        return MP.decorate(rec)
                    return pk.optimizer.RecomputeOptimizer(
                        MP.decorate(pk.optimizer.Lamb(0.01)))

                if pk is T:
                    with pytest.raises(NotImplementedError,
                                       match="AMP with Recompute"):
                        make()
                    continue
                opt = make()
                if order == "recompute_outside":
                    opt._set_checkpoints(list(hidden))
                want = ("_grad_clip" if order == "decorate_outside"
                        else "'NoneType' object has no attribute 'name'")
                with pytest.raises(AttributeError, match=want):
                    opt.minimize(loss)
