"""The port's fluid layers and executor against ``paddle_tpu``'s, on
the CPU: program parity and routing.

Built under ``unique_name.guard()`` in both packages, the same program has
the same desc — every op's type, inputs, outputs and attrs in order
(``__fwd__`` of each grad op included), every var's shape, dtype and
flags, and the fused optimizer groups with their flat accumulators — for
the MLP of ``tests/test_pallas_fused.py`` under each fused optimizer and
for ResNet-50 at 224², class 1000 (build only: nothing runs at 224²).
Then the executor's routing: ``Executor()`` is the card and raises
without one; a run before startup raises ``RuntimeError``; names the port
lacks raise ``NotImplementedError`` naming their ROADMAP item.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as JUN
from paddle_tpu.models import resnet as JR
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.models import resnet as TR

FACTORIES = {
    "sgd": lambda pk: pk.optimizer.SGD(0.05, fuse=True),
    "momentum": lambda pk: pk.optimizer.Momentum(0.05, 0.9, fuse=True),
    "adam": lambda pk: pk.optimizer.Adam(0.01, fuse=True),
    "adamw": lambda pk: pk.optimizer.AdamW(0.01, weight_decay=0.1,
                                           fuse=True),
    "adamw_excl": lambda pk: pk.optimizer.AdamW(
        0.01, weight_decay=0.1, fuse=True,
        apply_decay_param_fun=lambda n: n.endswith(".w_0")),
    "momentum_unfused": lambda pk: pk.optimizer.Momentum(0.05, 0.9),
    "adam_unfused": lambda pk: pk.optimizer.Adam(0.01),
}


def build_mlp(pk, un, factory, seed=7):
    """The MLP of ``tests/test_pallas_fused.py::_run_fluid_mlp``."""
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = seed
        with pk.program_guard(main, startup):
            x = pk.layers.data(name="x", shape=[8], dtype="float32")
            h = pk.layers.fc(x, size=16, act="relu")
            y = pk.layers.fc(h, size=1)
            label = pk.layers.data(name="y", shape=[1], dtype="float32")
            loss = pk.layers.reduce_mean(pk.layers.square(y - label))
            factory(pk).minimize(loss)
    return main, startup, loss


def build_resnet(pk, un, R, depth, hw, classes, lr=0.01, seed=0):
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = seed
        with pk.program_guard(main, startup):
            img = pk.layers.data("img", [3, hw, hw], dtype="float32")
            label = pk.layers.data("label", [1], dtype="int64")
            logits = R.resnet(img, class_dim=classes, depth=depth)
            loss = pk.layers.reduce_mean(
                pk.layers.softmax_with_cross_entropy(logits, label))
            pk.optimizer.Momentum(lr, 0.9, fuse=True).minimize(loss)
    return main, startup, loss


def _assert_same_desc(jprog, tprog):
    a, b = jprog._desc_dict(), tprog._desc_dict()
    ja, tb = a["blocks"][0], b["blocks"][0]
    assert [o["type"] for o in tb["ops"]] == [o["type"] for o in ja["ops"]]
    for oa, ob in zip(ja["ops"], tb["ops"]):
        assert ob == oa, (oa["type"], oa, ob)
    assert tb["vars"] == ja["vars"]
    assert b == a


@pytest.mark.parametrize("opt", sorted(FACTORIES))
def test_mlp_program_matches_jax(opt):
    jm, js, _ = build_mlp(fluid, JUN, FACTORIES[opt])
    tm, ts, _ = build_mlp(T, TUN, FACTORIES[opt])
    _assert_same_desc(jm, tm)
    _assert_same_desc(js, ts)


def test_resnet50_program_matches_jax():
    """ResNet-50 at 224², class 1000, ``Momentum(0.01, 0.9, fuse=True)``:
    the same blocks, one fused_momentum op over one f32 group with one
    flat velocity of the program's parameter count; that count equals the
    JAX program's, which its own test holds within 30,000 of
    torchvision's 25,557,032."""
    jm, js, _ = build_resnet(fluid, JUN, JR, 50, 224, 1000)
    tm, ts, _ = build_resnet(T, TUN, TR, 50, 224, 1000)
    _assert_same_desc(jm, tm)
    _assert_same_desc(js, ts)

    def count(prog):
        return sum(int(np.prod(p.shape))
                   for p in prog.global_block().all_parameters()
                   if p.trainable)

    n = count(tm)
    assert n == count(jm) == 25_557_032
    fused = [op for op in tm.global_block().ops
             if op.type == "fused_momentum"]
    assert len(fused) == 1
    vel = tm.global_block().var(fused[0].input("Velocity")[0])
    assert vel.shape == (n,) and vel.persistable


def test_executor_without_place_is_the_card():
    """``Executor()`` means ``CUDAPlace(0)``: without a card it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        assert T.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Executor(T.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.scope_from_numpy({"a": np.zeros(2)})


def test_run_before_startup_raises():
    tm, _ts, loss = build_mlp(T, TUN, FACTORIES["momentum"])
    exe = T.Executor(T.CPUPlace())
    feed = {"x": np.zeros((2, 8), np.float32),
            "y": np.zeros((2, 1), np.float32)}
    with pytest.raises(RuntimeError, match="run the startup program"):
        exe.run(tm, feed=feed, fetch_list=[loss], scope=T.Scope())


def test_feeds_cast_and_fetch_checked():
    """A fed float64 array is cast to the var's float32; fetching a var
    the program never computes raises."""
    tm, ts, loss = build_mlp(T, TUN, FACTORIES["sgd"])
    exe = T.Executor(T.CPUPlace())
    scope = T.Scope()
    exe.run(ts, scope=scope)
    feed = {"x": np.ones((2, 8)), "y": np.zeros((2, 1))}
    (lv,) = exe.run(tm, feed=feed, fetch_list=[loss], scope=scope)
    assert lv.dtype == np.float32 and np.isfinite(lv)
    with pytest.raises(ValueError, match="not computed"):
        exe.run(tm, feed=feed, fetch_list=["nope"], scope=scope)


def test_not_ported_names_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        T.layers.sequence_pool
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        T.contrib.slim
    assert not hasattr(T.layers, "lstm")
    with TUN.guard():
        main, startup = T.Program(), T.Program()
        with T.program_guard(main, startup):
            x = T.layers.data("x", [4])
            with pytest.raises(NotImplementedError, match="ROADMAP A5"):
                T.optimizer.SGD(0.1, parameter_list=[x])
            loss = T.layers.reduce_mean(T.layers.fc(x, 2))
            with pytest.raises(NotImplementedError, match="ROADMAP A5"):
                main.clone(for_test=True)
        main.global_block().append_op(type="sequence_pool", inputs={},
                                      outputs={})
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        T.Executor(T.CPUPlace()).run(main, scope=T.Scope())
