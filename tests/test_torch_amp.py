"""AMP in the port against ``paddle_tpu``'s, on the CPU.

- The rewrite: ``rewrite_program`` and ``cast_model_to_fp16`` on the MLP
  of ``tests/test_amp.py``, ResNet-18 at 32² and the transformer encoder,
  under the default lists, custom white and black lists and
  ``custom_black_varnames``, give the reference's program: the same desc
  (every op's type, slots and attrs in order; every var's shape, dtype
  and flags), so each op's inputs and outputs carry the reference's
  dtypes. The decorated MLP's whole training program (scaled loss,
  backward, ``check_finite_and_unscale``, ``update_loss_scaling``, the
  fused or per-parameter update) has the reference's desc too.
- The ops: ``check_finite_and_unscale`` and ``update_loss_scaling``
  equal the JAX lowerings exactly over seeded found-inf sequences.
- Training: the bf16 MLP under ``decorate(SGD)`` tracks the JAX
  executor within 1e-5 (each step from the JAX state before it);
  ResNet-18 under ``decorate(Momentum(fuse=True))`` within bands set
  against JAX's own bf16-to-float32 distance (its test says why).
  Parameters stay float32. The fp16 dynamic loss-scaling run of
  ``tests/test_amp.py`` gives the reference's scale sequence and
  overflow verdicts exactly.
- ``registry.compute_dtypes`` counts the dtypes the product lowerings
  were given, not the vars' labels: in the decorated encoder a ``mul``
  whose every input is labelled bfloat16 computes in float32 (a bf16
  product plus a float32 bias is float32), and the census says so, while
  decorated ResNet-18 computes every ``conv2d`` and ``mul`` in bf16 and
  the undecorated one in float32 (the gate of the card's phase 10a).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as JMP
from paddle_tpu.framework import registry as JREG
from paddle_tpu.framework import unique_name as JUN
from paddle_tpu.models import resnet as JR
from paddle_tpu.models import transformer_encoder as JTE
import jax.numpy as jnp
import torch

import paddle_tpu_torch as T
from paddle_tpu_torch.contrib import mixed_precision as TMP
from paddle_tpu_torch.framework import registry as TREG
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import transformer_encoder as TTE
from paddle_tpu_torch.ops import cuda_kernels as CK

PK = {"jax": (fluid, JUN, JMP, JR, JTE), "torch": (T, TUN, TMP, TR, TTE)}


def _forward(pk_name, model):
    """(main, startup, loss) of a forward-only program in one package."""
    pk, un, _mp, R, TE = PK[pk_name]
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = 7
        with pk.program_guard(main, startup):
            if model == "mlp":
                img = pk.layers.data("img", [16], dtype="float32")
                label = pk.layers.data("label", [1], dtype="int64")
                h = pk.layers.fc(img, 32, act="relu")
                logits = pk.layers.fc(h, 4)
                loss = pk.layers.reduce_mean(
                    pk.layers.softmax_with_cross_entropy(logits, label))
            elif model == "resnet18":
                img = pk.layers.data("img", [3, 32, 32], dtype="float32")
                label = pk.layers.data("label", [1], dtype="int64")
                logits = R.resnet(img, class_dim=4, depth=18)
                loss = pk.layers.reduce_mean(
                    pk.layers.softmax_with_cross_entropy(logits, label))
            else:
                src = pk.layers.data("src", [8], dtype="int64")
                pos = pk.layers.data("pos", [8], dtype="int64")
                label = pk.layers.data("label", [1], dtype="int64")
                loss, _ = TE.transformer_encoder_classifier(
                    src, pos, label, vocab_size=30, max_pos=8,
                    num_layers=2, num_heads=4, d_model=32, d_ff=64)
    return main, startup, loss


def _first_output(prog, op_type):
    return next(op for op in prog.global_block().ops
                if op.type == op_type).output_arg_names[0]


# (name, lists factory (mp module, program) -> AutoMixedPrecisionLists)
LISTS = {
    "default": lambda mp, prog: mp.AutoMixedPrecisionLists(),
    "white": lambda mp, prog: mp.AutoMixedPrecisionLists(
        custom_white_list=["multihead_matmul", "elementwise_add",
                           "softmax_with_cross_entropy"]),
    "black": lambda mp, prog: mp.AutoMixedPrecisionLists(
        custom_black_list=["relu", "pool2d", "mul"]),
    "varnames": lambda mp, prog: mp.AutoMixedPrecisionLists(
        custom_black_varnames=[_first_output(prog, "elementwise_add")]),
}


def _assert_same_desc(jprog, tprog):
    a, b = jprog._desc_dict(), tprog._desc_dict()
    ja, tb = a["blocks"][0], b["blocks"][0]
    assert [o["type"] for o in tb["ops"]] == [o["type"] for o in ja["ops"]]
    for oa, ob in zip(ja["ops"], tb["ops"]):
        assert ob == oa, (oa["type"], oa, ob)
    assert tb["vars"] == ja["vars"]
    assert b == a


@pytest.mark.parametrize("lists", sorted(LISTS))
@pytest.mark.parametrize("model", ["mlp", "resnet18", "encoder"])
@pytest.mark.parametrize("how", ["rewrite", "cast_model"])
def test_rewrite_matches_jax(model, lists, how):
    progs = {}
    for name in ("jax", "torch"):
        mp = PK[name][2]
        main, _s, _l = _forward(name, model)
        amp_lists = LISTS[lists](mp, main)
        if how == "rewrite":
            mp.rewrite_program(main, amp_lists, "bfloat16")
        else:
            mp.cast_model_to_fp16(main, amp_lists, "float16")
        progs[name] = main
    _assert_same_desc(progs["jax"], progs["torch"])
    if lists == "default":
        # every matrix product now consumes low-precision inputs
        block = progs["torch"].global_block()
        low = "bfloat16" if how == "rewrite" else "float16"
        prods = [op for op in block.ops
                 if op.type in ("mul", "conv2d", "matmul")]
        assert prods
        for op in prods:
            for n in op.input_arg_names:
                assert block.var(n).dtype == low, (op, n)


def test_rewrite_duplicate_input_var():
    """A white op consuming the same float32 var twice must not skip
    rewriting the ops that follow (the cast cache against the insert
    count: ``i += len(cache)``)."""
    prog, startup = T.Program(), T.Program()
    with T.program_guard(prog, startup):
        a = T.layers.data("a", [4, 4], dtype="float32")
        sq = T.layers.matmul(a, a)          # duplicate input
        T.layers.exp(sq)                    # black op right after
    TMP.rewrite_program(prog, TMP.AutoMixedPrecisionLists(), "bfloat16")
    block = prog.global_block()
    assert [op.type for op in block.ops] == ["cast", "matmul", "cast", "exp"]
    exp_ops = [op for op in block.ops if op.type == "exp"]
    for n in exp_ops[0].input_arg_names:
        assert str(block.var(n).dtype) == "float32"


def test_both_custom_lists_refused():
    for mp in (JMP, TMP):
        with pytest.raises(ValueError, match="both custom white and black"):
            mp.AutoMixedPrecisionLists(custom_white_list=["relu"],
                                       custom_black_list=["relu"])
    lists = TMP.AutoMixedPrecisionLists(custom_white_list=["gelu"])
    assert "gelu" in lists.white_list and "gelu" not in lists.gray_list


def test_insert_op_replans_a_program_already_run():
    """``_insert_op`` / ``_remove_op`` bump the program's version, so the
    executor drops the plan built for the old op list."""
    main, startup, loss = _forward("torch", "mlp")
    exe = T.Executor(T.CPUPlace())
    scope = T.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    feed = {"img": rng.standard_normal((8, 16)).astype(np.float32),
            "label": rng.integers(0, 4, (8, 1))}
    (f32,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    v0 = main._version_token()
    TMP.rewrite_program(main, TMP.AutoMixedPrecisionLists(), "bfloat16")
    assert main._version_token() != v0
    (bf16,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert bf16 != f32 and abs(bf16 - f32) < 2e-2 * abs(f32)
    block = main.global_block()
    n = len(block.ops)
    assert block.ops[-1].type == "reduce_mean"
    block._remove_op(n - 1)
    assert len(block.ops) == n - 1
    with pytest.raises(ValueError, match="not computed"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def test_compute_dtypes_counts_values_not_labels():
    from paddle_tpu_torch.tools import train_bench as TB

    cfg, seq, dev = TB.ENCODER_TINY, 16, torch.device("cpu")
    main, startup, loss, _lr = TB.encoder_program(cfg, seq)
    exe = T.Executor(T.CPUPlace())
    scope = T.Scope()
    exe.run(startup, scope=scope)
    feed = TB.encoder_batch(cfg, 2, seq, dev)
    block = main.global_block()
    muls = [op for op in block.ops if op.type == "mul"]
    labelled_low = [op for op in muls
                    if all(block.var(n).dtype == "bfloat16"
                           for n in op.input_arg_names)]
    with TREG.compute_dtypes({"mul": ("X", "Y")}) as seen:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    # every mul runs once; the FFN's second product of each layer has
    # bf16 labels on both inputs and a float32 value in X
    assert sum(seen.values()) == len(muls)
    assert seen[("mul", "float32")] >= cfg["num_layers"]
    assert seen[("mul", "bfloat16")] < len(labelled_low)
    # the census restores the lowerings when it ends
    assert TREG.get_op_spec("mul").lower.__name__ != "observed"
    for amp, want in ((True, "bfloat16"), (False, "float32")):
        rec = TB.run_resnet(device="cpu", tiny=True, steps=1, amp=amp)
        pd = rec["product_dtypes"]
        assert pd["ops"] == {"conv2d": 20, "mul": 1}
        assert pd["calls"] == {f"conv2d:{want}": 20, f"mul:{want}": 1}


# ---------------------------------------------------------------------------
# the ops, exactly
# ---------------------------------------------------------------------------


class _Op:
    def __init__(self, attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _jax_lower(op_type, ins, attrs):
    spec = JREG.get_op_spec(op_type)
    fake = JREG._FakeOp(op_type, {}, {}, dict(attrs), None)
    outs = spec.lower(JREG.LowerCtx(None, None, {}), fake,
                      {s: [jnp.asarray(a) for a in v] for s, v in ins.items()})
    return {s: ([np.asarray(x) for x in v] if isinstance(v, (list, tuple))
                else np.asarray(v)) for s, v in outs.items()}


def _port_lower(op_type, ins, attrs):
    spec = TREG.get_op_spec(op_type)
    outs = spec.lower(TREG.LowerCtx(torch.device("cpu")), _Op(attrs),
                      {s: [torch.from_numpy(np.array(a)) for a in v]
                       for s, v in ins.items()})
    return {s: ([x.numpy() for x in v] if isinstance(v, (list, tuple))
                else v.numpy()) for s, v in outs.items()}


@settings(max_examples=25, deadline=None)
@given(seq=st.lists(st.booleans(), min_size=1, max_size=14),
       incr_every=st.integers(1, 5), decr_every=st.integers(1, 3),
       incr_ratio=st.sampled_from([2.0, 1.5]),
       decr_ratio=st.sampled_from([0.5, 0.8]),
       scale0=st.sampled_from([1.0, 2.0 ** 15, 3.0]))
def test_update_loss_scaling_matches_jax(seq, incr_every, decr_every,
                                         incr_ratio, decr_ratio, scale0):
    attrs = {"incr_every_n_steps": incr_every,
             "decr_every_n_nan_or_inf": decr_every,
             "incr_ratio": incr_ratio, "decr_ratio": decr_ratio}
    rng = np.random.default_rng(len(seq))
    grads = [rng.standard_normal((3, 2)).astype(np.float32),
             rng.standard_normal((5,)).astype(np.float32)]
    state = {"PrevLossScaling": np.array([scale0], np.float32),
             "InGoodSteps": np.array([0], np.int32),
             "InBadSteps": np.array([0], np.int32)}
    for found in seq:
        ins = {"X": grads, "FoundInfinite": [np.array([found])],
               **{k: [v] for k, v in state.items()}}
        j = _jax_lower("update_loss_scaling", ins, attrs)
        t = _port_lower("update_loss_scaling", ins, attrs)
        for slot in ("LossScaling", "OutGoodSteps", "OutBadSteps"):
            assert t[slot].dtype == j[slot].dtype, slot
            np.testing.assert_array_equal(t[slot], j[slot], err_msg=slot)
        for a, b in zip(t["Out"], j["Out"]):
            np.testing.assert_array_equal(a, b)
        state = {"PrevLossScaling": t["LossScaling"],
                 "InGoodSteps": t["OutGoodSteps"],
                 "InBadSteps": t["OutBadSteps"]}


@settings(max_examples=25, deadline=None)
@given(poison=st.lists(st.sampled_from(["none", "inf", "-inf", "nan"]),
                       min_size=1, max_size=3),
       scale=st.sampled_from([1.0, 1024.0, 3.0]),
       seed=st.integers(0, 2 ** 16))
def test_check_finite_and_unscale_matches_jax(poison, scale, seed):
    rng = np.random.default_rng(seed)
    xs = []
    for kind in poison:
        x = (rng.standard_normal((4, 3)) * 100).astype(np.float32)
        if kind != "none":
            x.flat[rng.integers(0, x.size)] = float(kind)
        xs.append(x)
    ins = {"X": xs, "Scale": [np.array([scale], np.float32)]}
    for op_type in ("check_finite_and_unscale",
                    "amp_check_finite_and_scale"):
        j = _jax_lower(op_type, ins, {})
        t = _port_lower(op_type, ins, {})
        np.testing.assert_array_equal(t["FoundInfinite"], j["FoundInfinite"])
        assert t["FoundInfinite"].shape == (1,)
        assert bool(t["FoundInfinite"][0]) == (set(poison) != {"none"})
        for a, b in zip(t["Out"], j["Out"]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# decorated programs and training
# ---------------------------------------------------------------------------

OPTS = {
    "sgd": lambda pk: pk.optimizer.SGD(0.1),
    "sgd_fused": lambda pk: pk.optimizer.SGD(0.1, fuse=True),
    "momentum_fused": lambda pk: pk.optimizer.Momentum(0.05, 0.9, fuse=True),
    "adamw_fused": lambda pk: pk.optimizer.AdamW(0.01, weight_decay=0.01,
                                                 fuse=True),
}


def _decorated(pk_name, model, opt, **dec_kw):
    """(main, startup, loss, decorated optimizer) of ``model`` under
    ``decorate(OPTS[opt])``."""
    pk, un, mp, R, _TE = PK[pk_name]
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = 3
        with pk.program_guard(main, startup):
            if model == "mlp":
                img = pk.layers.data("img", [16], dtype="float32")
                label = pk.layers.data("label", [1], dtype="int64")
                h = pk.layers.fc(img, 32, act="relu")
                logits = pk.layers.fc(h, 4)
            else:
                img = pk.layers.data("img", [3, 64, 64], dtype="float32")
                label = pk.layers.data("label", [1], dtype="int64")
                logits = R.resnet(img, class_dim=4, depth=18)
            loss = pk.layers.reduce_mean(
                pk.layers.softmax_with_cross_entropy(logits, label))
            dec = mp.decorate(OPTS[opt](pk), **dec_kw)
            dec.minimize(loss)
    return main, startup, loss, dec


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp16"])
def test_decorated_program_matches_jax(opt, bf16):
    """The whole AMP training program: the rewrite, ``loss_scaling_0``
    (and ``good_steps_0`` / ``bad_steps_0`` under fp16's dynamic
    scaling), the scaled loss, the backward, ``check_finite_and_unscale``
    into the persistable ``find_infinite_scale_0``,
    ``update_loss_scaling``, and the update, fused or not."""
    jm, js, _, jdec = _decorated("jax", "mlp", opt, use_bf16=bf16)
    tm, ts, _, tdec = _decorated("torch", "mlp", opt, use_bf16=bf16)
    _assert_same_desc(jm, tm)
    _assert_same_desc(js, ts)
    assert tdec.get_loss_scaling().name == "loss_scaling_0"
    assert tdec.type == OPTS[opt](T).type            # __getattr__
    names = {n for n, v in tm.global_block().vars.items() if v.persistable}
    want = {"loss_scaling_0", "find_infinite_scale_0"}
    if not bf16:
        want |= {"good_steps_0", "bad_steps_0"}
    assert want <= names
    for v in tm.global_block().all_parameters():
        assert v.dtype == "float32"


def _persistables(prog):
    return [n for n, v in prog.global_block().vars.items() if v.persistable]


def _feed(model, seed=0):
    rng = np.random.default_rng(seed)
    if model == "mlp":
        x = rng.standard_normal((64, 16)).astype(np.float32)
        return {"img": x, "label": x[:, :4].argmax(1).reshape(-1, 1)}
    return {"img": rng.standard_normal((16, 3, 64, 64)).astype(np.float32),
            "label": rng.integers(0, 4, (16, 1))}


def _jax_state(scope, names):
    return {n: np.array(scope.find_var(n)) for n in names}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("opt", ["sgd", "sgd_fused"])
def test_bf16_mlp_tracks_jax(opt):
    """The bf16 MLP under ``decorate(SGD)``, 5 steps, each from the JAX
    state before it: loss and every persistable within 1e-5 of their
    scale (measured at most 1.8e-7); master weights stay float32, the
    scale 1.0, no overflow."""
    jm, js, jl, _ = _decorated("jax", "mlp", opt)
    tm, _ts, tl, _ = _decorated("torch", "mlp", opt)
    jexe, jscope = fluid.Executor(fluid.XLAPlace(0)), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = [n for n in _persistables(jm) if jscope.find_var(n) is not None]
    texe = T.Executor(T.CPUPlace())
    feed = _feed("mlp")
    CK.reset_launches()
    for step in range(5):
        tscope = T.scope_from_numpy(_jax_state(jscope, names), T.CPUPlace())
        jloss = float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jl],
                                          scope=jscope)[0]))
        tloss = float(texe.run(tm, feed=feed, fetch_list=[tl],
                               scope=tscope)[0])
        assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (step, tloss, jloss)
        for n in names:
            got = tscope.find_var(n)
            if got.is_floating_point():
                assert got.dtype == torch.float32, n
            assert _rel(got.numpy(), jscope.find_var(n)) <= 1e-5, (step, n)
        assert not bool(tscope.find_var("find_infinite_scale_0")[0])
        assert float(tscope.find_var("loss_scaling_0")[0]) == 1.0
    assert not any(CK.LAUNCHES.values())       # CPU: the plain versions


def test_bf16_resnet18_tracks_jax():
    """ResNet-18 under ``decorate(Momentum(0.01, 0.9, fuse=True))`` at
    64², batch 16, 3 steps, each from the JAX state before it, held
    against the JAX bf16 run with the JAX float32 run from the same state
    as the yardstick: bf16 gradients through 20 BN layers sit far from
    float32 in both packages (the step's update, every persistable's
    change in the 2-norm, is 28.6% off the float32 update in JAX and 32.4%
    in the port at the first step), and XLA may keep fused intermediates
    above bf16 (``xla_allow_excess_precision``), where the port rounds
    every op's bf16 output. Bands: the port's update no further from
    float32's than 1.5x JAX's bf16 update is, in the 2-norm over all
    persistables (measured at most 1.19x); the loss within 3e-2 relative
    of JAX's bf16 loss (measured at most 1.1e-2); BN's running
    statistics within 3e-2 of their scale (measured 9.6e-3). At 32², batch 4,
    BN at res5 normalises 4 values a channel and one bf16 ulp moves the
    step-1 loss by up to 14% in either package, so no band there says
    anything. Master weights, statistics and the velocity stay float32."""
    jm, js, jl, _ = _decorated("jax", "resnet18", "momentum_fused")
    tm, _ts, tl, _ = _decorated("torch", "resnet18", "momentum_fused")
    with JUN.guard():
        fm, fs = fluid.Program(), fluid.Program()
        fm.random_seed = fs.random_seed = 3
        with fluid.program_guard(fm, fs):
            img = fluid.layers.data("img", [3, 64, 64], dtype="float32")
            label = fluid.layers.data("label", [1], dtype="int64")
            fl = fluid.layers.reduce_mean(
                fluid.layers.softmax_with_cross_entropy(
                    JR.resnet(img, class_dim=4, depth=18), label))
            fluid.optimizer.Momentum(0.01, 0.9, fuse=True).minimize(fl)
    jexe, jscope = fluid.Executor(fluid.XLAPlace(0)), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = [n for n in _persistables(jm) if jscope.find_var(n) is not None]
    shared = [n for n in names if fm.global_block().has_var(n)]
    stats = [n for n in shared if n.endswith(("_mean", "_variance"))]
    assert stats and len(shared) >= len(names) - 1
    texe = T.Executor(T.CPUPlace())
    feed = _feed("resnet18")
    for step in range(3):
        before = _jax_state(jscope, names)
        tscope = T.scope_from_numpy(before, T.CPUPlace())
        fscope = fluid.Scope()
        for n in shared:
            fscope.set_var(n, jnp.asarray(before[n]))
        jloss = float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jl],
                                          scope=jscope)[0]))
        jexe.run(fm, feed=feed, fetch_list=[fl], scope=fscope)
        tloss = float(texe.run(tm, feed=feed, fetch_list=[tl],
                               scope=tscope)[0])
        assert abs(tloss - jloss) <= 3e-2 * abs(jloss), (step, tloss, jloss)
        d = {k: [] for k in ("t", "j", "f")}
        for n in shared:
            got = tscope.find_var(n)
            assert got.dtype == torch.float32, n
            d["t"].append(got.numpy().ravel() - before[n].ravel())
            d["j"].append(np.array(jscope.find_var(n)).ravel()
                          - before[n].ravel())
            d["f"].append(np.array(fscope.find_var(n)).ravel()
                          - before[n].ravel())
        t, j, f = (np.concatenate(d[k]).astype(np.float64) for k in "tjf")
        rt = np.linalg.norm(t - f) / np.linalg.norm(f)
        rj = np.linalg.norm(j - f) / np.linalg.norm(f)
        assert rt <= 1.5 * rj, (step, rt, rj)
        for n in stats:
            err = _rel(tscope.find_var(n).numpy(), jscope.find_var(n))
            assert err <= 3e-2, (step, n, err)
        assert not bool(tscope.find_var("find_infinite_scale_0")[0])


def test_fp16_dynamic_loss_scaling_matches_jax():
    """``tests/test_amp.py``'s fp16 run: scale 2^10, one bad step
    decreases, four good ones increase; one poisoned step. Scale sequence
    and overflow verdicts equal the reference's; the weights stay
    finite."""
    kw = dict(use_bf16=False, init_loss_scaling=2.0 ** 10,
              decr_every_n_nan_or_inf=1, incr_every_n_steps=4)
    runs = {}
    for name in ("jax", "torch"):
        pk = PK[name][0]
        main, startup, loss, dec = _decorated(name, "mlp", "sgd", **kw)
        scaling = dec.get_loss_scaling()
        if name == "jax":
            exe, scope = fluid.Executor(fluid.XLAPlace(0)), fluid.Scope()
        else:
            exe, scope = T.Executor(T.CPUPlace()), T.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(1)
        x = rng.randn(32, 16).astype(np.float32)
        y = rng.randint(0, 4, (32, 1)).astype(np.int64)
        scales, found = [], []
        for step in range(10):
            feed_x = x.copy()
            if step == 2:
                feed_x[0, 0] = np.inf
            _, s, f = exe.run(main, feed={"img": feed_x, "label": y},
                              fetch_list=[loss, scaling,
                                          "find_infinite_scale_0"],
                              scope=scope)
            scales.append(float(np.asarray(s)[0]))
            found.append(bool(np.asarray(f)[0]))
        runs[name] = (scales, found)
        if name == "torch":
            for n in _persistables(main):
                v = scope.find_var(n)
                if v.is_floating_point():
                    assert torch.isfinite(v).all(), n
        del pk
    assert runs["torch"] == runs["jax"]
    scales, found = runs["torch"]
    assert found[2] and not any(found[:2] + found[3:])
    assert scales[2] < scales[1] and scales[-1] > scales[2]
