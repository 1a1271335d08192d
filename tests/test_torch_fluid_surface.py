"""The rest of the fluid surface this slice ports, against
``paddle_tpu``'s, on the CPU.

- The new op lowerings, one-op programs as in ``test_torch_fluid_ops``:
  forward within 2e-6 of the output's scale and gradients within 5e-6
  (that file's bands), the comparisons and selections exactly.
- ``softmax_with_cross_entropy(vocab_chunk=)`` with a class count the
  chunk does not divide and an ``ignore_index`` row: loss and Logits
  gradient against the JAX chunked lowering within 2e-6 / 5e-6, and
  against the port's own unchunked path within the same bands.
- Adaptive ``pool2d`` (max and avg), and its refusal of sizes that do
  not divide (the reference's condition: JAX raises AssertionError, the
  port ValueError).
- ``dropout``: at test time exactly the reference's; in training by its
  distribution (a torch generator draws other bits than threefry): the
  kept share within 4 standard deviations of 1 - p, kept elements
  unchanged (or divided by 1 - p), the gradient the mask.
- The eight LR schedules over 6 runs of their programs: the same values
  within 1e-5 relative (float32 arithmetic on both sides; XLA's CPU
  backend contracts ``x * scale + bias`` into an FMA: measured at most
  2.9e-6).
- The three gradient clips and L1 / L2 decay, a per-parameter
  regularizer winning over the optimizer's, under SGD and Momentum,
  fused and per parameter: the same program desc, and 3 steps from the
  same start with losses and every persistable within 1e-6 of their
  scale.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import clip as JC
from paddle_tpu import regularizer as JREGU
from paddle_tpu.framework import unique_name as JUN
import paddle_tpu_torch as T
from paddle_tpu_torch import clip as TC
from paddle_tpu_torch import regularizer as TREGU
from paddle_tpu_torch.framework import unique_name as TUN

from test_torch_fluid_ops import _check, _randn, _run_jax, _run_port
from test_torch_fluid_program import _assert_same_desc


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op_type", ["exp", "sqrt", "cos", "floor", "sign"])
def test_unary(op_type):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.1, 3.0, (4, 5)).astype(np.float32)
    if op_type in ("floor", "sign", "cos"):
        x = (x - 1.5) * 2
    diff = [] if op_type in ("floor", "sign") else ["X"]
    _check(op_type, {"X": [x]}, {"Out": 1}, {}, ["Out"], diff)


@pytest.mark.parametrize("op_type", ["elementwise_max", "elementwise_min",
                                     "elementwise_pow"])
@pytest.mark.parametrize("yshape,axis", [((3, 4), -1), ((4,), -1),
                                         ((3,), 1), ((), -1)])
def test_elementwise(op_type, yshape, axis):
    rng = np.random.default_rng(2)
    x = rng.uniform(0.5, 2.0, (2, 3, 4)).astype(np.float32)
    y = rng.uniform(0.5, 2.0, yshape).astype(np.float32)
    _check(op_type, {"X": [x], "Y": [y]}, {"Out": 1}, {"axis": axis},
           ["Out"], ["X", "Y"])


@pytest.mark.parametrize("attrs", [
    {"dim": [1], "keep_dim": False}, {"dim": [0, 2], "keep_dim": True},
    {"reduce_all": True}])
def test_reduce_sum(attrs):
    x = _randn(np.random.default_rng(3), 3, 4, 5)
    _check("reduce_sum", {"X": [x]}, {"Out": 1}, attrs, ["Out"], ["X"])


def test_clip_and_clip_by_norm():
    rng = np.random.default_rng(4)
    x = _randn(rng, 5, 6)
    _check("clip", {"X": [x]}, {"Out": 1}, {"min": -0.5, "max": 0.7},
           ["Out"], ["X"])
    for max_norm in (0.5, 100.0):   # clipped, and left alone
        _check("clip_by_norm", {"X": [x]}, {"Out": 1},
               {"max_norm": max_norm}, ["Out"], ["X"])


@pytest.mark.parametrize("attrs,xs,ys", [
    ({}, (3, 4), (4, 5)),
    ({"transpose_X": True, "transpose_Y": True, "alpha": 0.5},
     (2, 4, 3), (2, 5, 4)),
    ({}, (4,), (4, 3)),
])
def test_matmul(attrs, xs, ys):
    rng = np.random.default_rng(5)
    _check("matmul", {"X": [_randn(rng, *xs)], "Y": [_randn(rng, *ys)]},
           {"Out": 1}, attrs, ["Out"], ["X", "Y"])


@pytest.mark.parametrize("attrs", [
    {"axes": [1], "starts": [0], "ends": [1], "decrease_axis": []},
    {"axes": [0, 2], "starts": [1, -3], "ends": [100, -1],
     "decrease_axis": []},
    {"axes": [1], "starts": [2], "ends": [3], "decrease_axis": [1]},
])
def test_slice(attrs):
    x = _randn(np.random.default_rng(6), 3, 4, 5)
    _check("slice", {"Input": [x]}, {"Out": 1}, attrs, ["Out"], ["Input"])


@pytest.mark.parametrize("shape", [[-1, 20], [0, 4, 5], [6, 0, -1]])
def test_reshape2(shape):
    x = _randn(np.random.default_rng(7), 6, 4, 5)
    _check("reshape2", {"X": [x]}, {"Out": 1}, {"shape": shape}, ["Out"],
           ["X"])


def test_where_and_less_than():
    rng = np.random.default_rng(8)
    x, y = _randn(rng, 4, 5), _randn(rng, 4, 5)
    cond = x < y
    _check("where", {"Condition": [cond], "X": [x], "Y": [y]}, {"Out": 1},
           {}, ["Out"], ["X", "Y"])
    j, _ = _run_jax("less_than", {"X": [x], "Y": [y]}, {"Out": 1}, {}, {},
                    [])
    t, _ = _run_port("less_than", {"X": [x], "Y": [y]}, {"Out": 1}, {}, {},
                     [])
    np.testing.assert_array_equal(t["Out"][0], j["Out"][0])


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax(axis):
    x = _randn(np.random.default_rng(9), 3, 4, 5) * 3
    _check("softmax", {"X": [x]}, {"Out": 1}, {"axis": axis}, ["Out"],
           ["X"])


@pytest.mark.parametrize("bna,affine", [(1, True), (2, True), (2, False)])
def test_layer_norm(bna, affine):
    rng = np.random.default_rng(10)
    x = _randn(rng, 3, 4, 6) * 2 + 1
    ins = {"X": [x]}
    diff = ["X"]
    if affine:
        n = int(np.prod(x.shape[bna:]))
        ins["Scale"] = [1 + _randn(rng, n) * 0.1]
        ins["Bias"] = [_randn(rng, n) * 0.1]
        diff += ["Scale", "Bias"]
    _check("layer_norm", ins, {"Y": 1, "Mean": 1, "Variance": 1},
           {"epsilon": 1e-5, "begin_norm_axis": bna}, ["Y"], diff)


@pytest.mark.parametrize("op_type,ids_shape,padding_idx", [
    ("lookup_table", (4, 3, 1), -1), ("lookup_table", (4, 3), 2),
    ("lookup_table_v2", (4, 3), -1), ("lookup_table_v2", (4, 3), 0)])
def test_lookup_table(op_type, ids_shape, padding_idx):
    rng = np.random.default_rng(11)
    w = _randn(rng, 7, 5)
    ids = rng.integers(0, 7, ids_shape).astype(np.int64)
    ids.flat[0] = max(padding_idx, 0)          # one padding row at least
    _check(op_type, {"Ids": [ids], "W": [w]}, {"Out": 1},
           {"padding_idx": padding_idx}, ["Out"], ["W"])


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_at_test_time(impl):
    x = _randn(np.random.default_rng(12), 4, 6)
    for attrs in ({"dropout_prob": 0.3, "is_test": True},
                  {"dropout_prob": 0.0, "is_test": False}):
        _check("dropout", {"X": [x]}, {"Out": 1, "Mask": 1},
               {**attrs, "dropout_implementation": impl}, ["Out"], ["X"])


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_in_training_by_distribution(impl):
    p = 0.3
    x = _randn(np.random.default_rng(13), 64, 64)
    cot = np.ones_like(x)
    outs, grads = _run_port("dropout", {"X": [x]}, {"Out": 1, "Mask": 1},
                            {"dropout_prob": p, "seed": 5,
                             "dropout_implementation": impl},
                            {"Out": [cot]}, ["X"])
    out, mask = outs["Out"][0], outs["Mask"][0]
    assert mask.dtype == np.uint8
    keep = mask.astype(bool)
    n = keep.size
    assert abs(keep.mean() - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    scale = 1 / (1 - p) if impl == "upscale_in_train" else 1.0
    np.testing.assert_allclose(out[keep], x[keep] * scale, rtol=1e-6)
    assert (out[~keep] == 0).all()
    np.testing.assert_allclose(grads["X"][0], keep * scale, rtol=1e-6)
    # a seeded op draws the same mask every run
    again, _ = _run_port("dropout", {"X": [x]}, {"Out": 1, "Mask": 1},
                         {"dropout_prob": p, "seed": 5,
                          "dropout_implementation": impl},
                         {"Out": [cot]}, ["X"])
    np.testing.assert_array_equal(again["Mask"][0], mask)


@pytest.mark.parametrize("ptype", ["max", "avg"])
@pytest.mark.parametrize("ksize", [[4, 3], [1, 1], [8, 6], [2, 1]])
def test_adaptive_pool2d(ptype, ksize):
    x = _randn(np.random.default_rng(14), 2, 3, 8, 6)
    _check("pool2d", {"X": [x]}, {"Out": 1},
           {"pooling_type": ptype, "ksize": ksize, "adaptive": True},
           ["Out"], ["X"])


def test_adaptive_pool2d_refuses_sizes_that_do_not_divide():
    x = _randn(np.random.default_rng(15), 2, 3, 8, 6)
    attrs = {"pooling_type": "avg", "ksize": [3, 4], "adaptive": True}
    with pytest.raises(AssertionError, match="divisible"):
        _run_jax("pool2d", {"X": [x]}, {"Out": 1}, attrs, {}, [])
    with pytest.raises(ValueError, match="divisible"):
        _run_port("pool2d", {"X": [x]}, {"Out": 1}, attrs, {}, [])


@pytest.mark.parametrize("V,chunk", [(37, 8), (37, 64), (40, 8)])
def test_chunked_softmax_with_cross_entropy(V, chunk):
    """The vocab-chunked form: V not a multiple of the chunk (padded with
    -inf columns), a row at ``ignore_index``; no Softmax output."""
    rng = np.random.default_rng(16)
    logits = _randn(rng, 6, V) * 3
    label = rng.integers(0, V, (6, 1)).astype(np.int64)
    label[2, 0] = -100
    attrs = {"vocab_chunk": chunk, "ignore_index": -100, "axis": -1,
             "soft_label": False}
    ins = {"Logits": [logits], "Label": [label]}
    _check("softmax_with_cross_entropy", ins, {"Loss": 1}, attrs, ["Loss"],
           ["Logits"])
    # against the port's unchunked path for the same inputs
    cot = {"Loss": [rng.standard_normal((6, 1)).astype(np.float32)]}
    a, ga = _run_port("softmax_with_cross_entropy", ins, {"Loss": 1}, attrs,
                      cot, ["Logits"])
    b, gb = _run_port("softmax_with_cross_entropy", ins,
                      {"Softmax": 1, "Loss": 1}, {**attrs, "vocab_chunk": 0},
                      cot, ["Logits"])
    assert a["Loss"][0][2, 0] == 0 and (ga["Logits"][0][2] == 0).all()
    np.testing.assert_allclose(a["Loss"][0], b["Loss"][0], rtol=0,
                               atol=2e-6 * np.abs(b["Loss"][0]).max())
    np.testing.assert_allclose(ga["Logits"][0], gb["Logits"][0], rtol=0,
                               atol=5e-6 * np.abs(gb["Logits"][0]).max())


def test_chunked_ce_layer_refuses_softmax_and_soft_labels():
    for pk, un in ((fluid, JUN), (T, TUN)):
        with un.guard():
            main, startup = pk.Program(), pk.Program()
            with pk.program_guard(main, startup):
                x = pk.layers.data("x", [10])
                y = pk.layers.data("y", [1], dtype="int64")
                for kw in ({"return_softmax": True}, {"soft_label": True}):
                    with pytest.raises(ValueError, match="vocab_chunk"):
                        pk.layers.softmax_with_cross_entropy(
                            x, y, vocab_chunk=4, **kw)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 3, learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 2, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 2, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 2, 0.5,
                                                 staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    "polynomial": lambda L: L.polynomial_decay(0.1, 4, 0.01, power=2.0),
    "piecewise": lambda L: L.piecewise_decay([2, 4], [0.1, 0.05, 0.01]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 5),
    "warmup_scalar": lambda L: L.linear_lr_warmup(0.1, 3, 0.0, 0.1),
    "warmup_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(0.1, 6, 0.001), 3, 0.01, 0.1),
}


def _schedule_values(pk, un, make, runs=6):
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        with pk.program_guard(main, startup):
            lr = make(pk.layers)
    if pk is fluid:
        exe, scope = fluid.Executor(fluid.XLAPlace(0)), fluid.Scope()
    else:
        exe, scope = T.Executor(T.CPUPlace()), T.Scope()
    exe.run(startup, scope=scope)
    return main, [float(np.asarray(exe.run(main, fetch_list=[lr],
                                           scope=scope)[0]).reshape(-1)[0])
                  for _ in range(runs)]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    jm, want = _schedule_values(fluid, JUN, SCHEDULES[name])
    tm, got = _schedule_values(T, TUN, SCHEDULES[name])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert len(set(got)) > 1 or name == "piecewise"
    ops = tm.global_block().ops
    assert ops[0].type == "increment"
    assert [o.type for o in ops] == [o.type for o in jm.global_block().ops]
    counter = tm.global_block().var("@LR_DECAY_COUNTER@")
    assert counter.persistable and counter.dtype == "int64"


# ---------------------------------------------------------------------------
# gradient clips and regularizers
# ---------------------------------------------------------------------------

def _clip(mod, kind):
    return {"value": lambda: mod.GradientClipByValue(0.05),
            "norm": lambda: mod.ClipGradByNorm(0.1),
            "global_norm": lambda: mod.GradientClipByGlobalNorm(0.2),
            None: lambda: None}[kind]()


def _reg(mod, kind, coeff):
    return {"l1": lambda: mod.L1Decay(coeff), "l2": lambda: mod.L2Decay(coeff),
            None: lambda: None}[kind]()


def _build(pk, un, C, R, opt, clip, reg, per_param):
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = 7
        with pk.program_guard(main, startup):
            x = pk.layers.data(name="x", shape=[8], dtype="float32")
            attr = pk.ParamAttr(regularizer=_reg(R, "l2", 0.3)) \
                if per_param else None
            h = pk.layers.fc(x, size=16, act="relu", param_attr=attr)
            y = pk.layers.fc(h, size=1)
            label = pk.layers.data(name="y", shape=[1], dtype="float32")
            loss = pk.layers.reduce_mean(pk.layers.square(y - label))
            kw = dict(regularization=_reg(R, reg, 0.05),
                      grad_clip=_clip(C, clip), fuse=opt.endswith("_fused"))
            if opt.startswith("sgd"):
                o = pk.optimizer.SGD(0.1, **kw)
            else:
                o = pk.optimizer.Momentum(0.05, 0.9, **kw)
            o.minimize(loss)
    return main, startup, loss


CASES = [(opt, clip, reg, per_param)
         for opt in ("sgd", "sgd_fused", "momentum", "momentum_fused")
         for clip, reg, per_param in (("value", None, False),
                                      ("norm", "l1", False),
                                      ("global_norm", "l2", True),
                                      (None, "l1", True))]


@pytest.mark.parametrize("opt,clip,reg,per_param", CASES)
def test_clip_and_decay_train_like_jax(opt, clip, reg, per_param):
    jm, js, jl = _build(fluid, JUN, JC, JREGU, opt, clip, reg, per_param)
    tm, ts, tl = _build(T, TUN, TC, TREGU, opt, clip, reg, per_param)
    _assert_same_desc(jm, tm)
    _assert_same_desc(js, ts)
    types = [o.type for o in tm.global_block().ops]
    assert {"value": "clip", "norm": "clip_by_norm", "global_norm": "sqrt",
            None: "scale"}[clip] in types
    if reg == "l1":
        assert "sign" in types
    jexe, jscope = fluid.Executor(fluid.XLAPlace(0)), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = [n for n, v in jm.global_block().vars.items()
             if v.persistable and jscope.find_var(n) is not None]
    tscope = T.scope_from_numpy({n: np.asarray(jscope.find_var(n))
                                 for n in names}, T.CPUPlace())
    texe = T.Executor(T.CPUPlace())
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((4, 8)).astype(np.float32),
            "y": rng.standard_normal((4, 1)).astype(np.float32)}
    for step in range(3):
        jloss = float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jl],
                                          scope=jscope)[0]))
        tloss = float(texe.run(tm, feed=feed, fetch_list=[tl],
                               scope=tscope)[0])
        assert abs(tloss - jloss) <= 1e-6 * max(abs(jloss), 1.0)
        for n in names:
            want = np.asarray(jscope.find_var(n))
            got = tscope.find_var(n).numpy()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1.0),
                err_msg=f"{n} step {step}")


def test_set_gradient_clip_and_per_param_regularizer_wins():
    clip = TC.GradientClipByGlobalNorm(1.0)
    TC.set_gradient_clip(clip)
    assert TC.get_gradient_clip() is clip
    tm, _ts, _tl = _build(T, TUN, TC, TREGU, "sgd", None, "l1", True)
    # the first fc's weight takes its own L2 (scale 0.3), the rest the
    # optimizer's L1 (sign, scale 0.05)
    scales = sorted(o.attr("scale") for o in tm.global_block().ops
                    if o.type == "scale" and o.attr("op_role") == 2)
    assert scales == [0.05, 0.05, 0.05, 0.3]
