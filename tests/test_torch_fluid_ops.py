"""The port's fluid op lowerings against ``paddle_tpu``'s, on the CPU.

Each case builds a one-op program in the port — the forward op and the
grad op ``append_backward`` would append for it (``<type>_grad`` with the
forward's desc in ``__fwd__``), the cotangents fed as data — and runs it
through ``Executor(CPUPlace())``: the forward outputs against the JAX
lowering's, and the grad op's outputs (the port's default grad, the
forward op's recorded autograd graph) against ``jax.vjp`` of the JAX
lowering, for the same numpy inputs and cotangents.

Tolerances: float32 forward outputs within 2e-6 of their scale, gradients
within 5e-6 (measured here: at most 4.0e-7 and 5.2e-7; torch's CPU
convolution, matrix products and reductions sum in another order than
XLA's).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.framework import registry as JR
import paddle_tpu_torch as T
from paddle_tpu_torch.framework.backward import _fwd_desc

FWD_TOL, GRAD_TOL = 2e-6, 5e-6


def _run_port(op_type, inputs, out_slots, attrs, cots, diff_slots):
    """inputs: slot -> [np arrays]; out_slots: slot -> count; cots: out
    slot -> [np arrays] (cotangents); diff_slots: input slots to
    differentiate. Returns (outputs slot -> [np], grads slot -> [np])."""
    prog = T.Program()
    blk = prog.global_block()
    feed, in_names, out_names = {}, {}, {}
    for slot, arrs in inputs.items():
        in_names[slot] = []
        for k, a in enumerate(arrs):
            n = f"{slot}_{k}"
            blk.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                           is_data=True)
            feed[n] = a
            in_names[slot].append(n)
    for slot, count in out_slots.items():
        out_names[slot] = [f"out_{slot}_{k}" for k in range(count)]
        for n in out_names[slot]:
            blk.create_var(name=n)
    op = blk.append_op(type=op_type, inputs=in_names, outputs=out_names,
                       attrs=dict(attrs))
    g_in = {**in_names, **out_names}
    for slot, arrs in cots.items():
        g_in[slot + "@GRAD"] = []
        for k, a in enumerate(arrs):
            n = f"cot_{slot}_{k}"
            blk.create_var(name=n, shape=a.shape, dtype=str(a.dtype))
            feed[n] = a
            g_in[slot + "@GRAD"].append(n)
    g_out = {s + "@GRAD": [f"grad_{s}_{k}" for k in range(len(inputs[s]))]
             for s in diff_slots}
    for names in g_out.values():
        for n in names:
            blk.create_var(name=n)
    blk.append_op(type=op_type + "_grad", inputs=g_in, outputs=g_out,
                  attrs={**attrs, "__fwd__": _fwd_desc(op)})
    fetch = [n for s in out_slots for n in out_names[s]] + \
        [n for s in diff_slots for n in g_out[s + "@GRAD"]]
    vals = T.Executor(T.CPUPlace()).run(prog, feed=feed, fetch_list=fetch)
    outs, i = {}, 0
    for s in out_slots:
        outs[s] = vals[i:i + out_slots[s]]
        i += out_slots[s]
    grads = {}
    for s in diff_slots:
        grads[s] = vals[i:i + len(inputs[s])]
        i += len(inputs[s])
    return outs, grads


def _run_jax(op_type, inputs, out_slots, attrs, cots, diff_slots):
    spec = JR.get_op_spec(op_type)
    fake = JR._FakeOp(
        op_type, {s: [f"{s}_{k}" for k in range(len(a))]
                  for s, a in inputs.items()},
        {s: [f"out_{s}_{k}" for k in range(c)] for s, c in out_slots.items()},
        dict(attrs), None)
    const = {s: [jnp.asarray(a) for a in arrs] for s, arrs in inputs.items()
             if s not in diff_slots}
    diff = {s: [jnp.asarray(a) for a in inputs[s]] for s in diff_slots}

    def fwd(d):
        outs = spec.lower(JR.LowerCtx(None, None, {}), fake, {**const, **d})
        return {s: [outs[s]] if not isinstance(outs[s], (list, tuple))
                else list(outs[s]) for s in out_slots}

    outs, vjp = jax.vjp(fwd, diff)
    ct = {s: [jnp.asarray(cots[s][k]) if s in cots
              else jnp.zeros_like(o) for k, o in enumerate(vals)]
          for s, vals in outs.items()}
    (grads,) = vjp(ct)
    return ({s: [np.asarray(v) for v in vals] for s, vals in outs.items()},
            {s: [np.asarray(v) for v in vals] for s, vals in grads.items()})


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max diff {err:.3g} of scale {scale:.3g}"


def _check(op_type, inputs, out_slots, attrs, cot_slots, diff_slots, seed=0,
           fwd_tol=FWD_TOL, grad_tol=GRAD_TOL):
    """Forward outputs and the grads of ``diff_slots`` for random
    cotangents on ``cot_slots``, port against JAX."""
    j_outs, _ = _run_jax(op_type, inputs, out_slots, attrs, {}, [])
    rng = np.random.default_rng(seed + 100)
    cots = {s: [rng.standard_normal(o.shape).astype(o.dtype)
                for o in j_outs[s]] for s in cot_slots}
    j_outs, j_grads = _run_jax(op_type, inputs, out_slots, attrs, cots,
                               diff_slots)
    t_outs, t_grads = _run_port(op_type, inputs, out_slots, attrs, cots,
                                diff_slots)
    for s in out_slots:
        for k, (a, b) in enumerate(zip(t_outs[s], j_outs[s])):
            _close(a, b, fwd_tol, f"{op_type} {s}[{k}]")
    for s in diff_slots:
        for k, (a, b) in enumerate(zip(t_grads[s], j_grads[s])):
            _close(a, b, grad_tol, f"{op_type} {s}@GRAD[{k}]")


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("attrs,cin,groups,k", [
    ({"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 1}, 4, 1, 3),
    ({"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
      "groups": 2}, 4, 2, 3),
    ({"strides": [1, 1], "paddings": [2, 2], "dilations": [2, 2],
      "groups": 1}, 3, 1, 3),
    ({"strides": [2, 2], "paddings": [3, 3], "dilations": [1, 1],
      "groups": 1}, 3, 1, 7),
    ({"strides": [1, 2], "paddings": [0, 1, 1, 2], "dilations": [1, 1],
      "groups": 1}, 3, 1, 3),
], ids=["s2p1", "groups2", "dilation2", "stem7x7", "asym_pad"])
def test_conv2d(attrs, cin, groups, k):
    rng = np.random.default_rng(1)
    inputs = {"Input": [_randn(rng, 2, cin, 9, 10)],
              "Filter": [_randn(rng, 6, cin // groups, k, k)]}
    _check("conv2d", inputs, {"Output": 1},
           {**attrs, "data_format": "NCHW"}, ["Output"],
           ["Input", "Filter"])


@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
     "paddings": [0, 0], "ceil_mode": True},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "exclusive": True},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "exclusive": False},
    {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
     "paddings": [0, 0], "ceil_mode": True},
    {"pooling_type": "avg", "global_pooling": True},
    {"pooling_type": "max", "global_pooling": True},
], ids=["max3s2p1", "max_ceil", "avg_exclusive", "avg_inclusive",
        "avg_ceil", "global_avg", "global_max"])
def test_pool2d(attrs):
    rng = np.random.default_rng(2)
    _check("pool2d", {"X": [_randn(rng, 2, 3, 9, 11)]}, {"Out": 1},
           {"global_pooling": False, "ceil_mode": False, "exclusive": True,
            "data_format": "NCHW", **attrs}, ["Out"], ["X"])


_BN_OUTS = {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
            "SavedVariance": 1}


@pytest.mark.parametrize("is_test,shape", [
    (False, (4, 5, 6, 7)), (True, (4, 5, 6, 7)), (False, (1, 5, 1, 1))],
    ids=["train", "is_test", "train_one_value"])
def test_batch_norm(is_test, shape):
    """Y and every statistics output (MeanOut / VarianceOut move by the
    biased batch variance; SavedVariance is rsqrt(var + eps)); grads of X,
    Scale and Bias for a cotangent on Y. One value per channel (ResNet's
    last stage at batch 1 and 32²) runs too (``F.batch_norm`` would
    refuse it): the reference's (x - mean) is exactly 0 there, so Y is the
    bias, while torch's kernel folds the normalization into
    x·(scale·inv) + (bias - mean·scale·inv) with inv = 1/sqrt(eps) = 316,
    whose cancellation leaves an ulp of 316·|x·scale| — held within 2e-4
    of Y's scale in that case (measured 6.7e-5)."""
    rng = np.random.default_rng(3)
    c = shape[1]
    inputs = {"X": [_randn(rng, *shape) * 2 + 0.5],
              "Scale": [_randn(rng, c)], "Bias": [_randn(rng, c)],
              "Mean": [_randn(rng, c) * 0.1],
              "Variance": [np.abs(_randn(rng, c)) + 0.5]}
    _check("batch_norm", inputs, _BN_OUTS,
           {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
            "data_layout": "NCHW", "use_global_stats": False},
           ["Y"], ["X", "Scale", "Bias"],
           fwd_tol=2e-4 if shape[0] * shape[2] * shape[3] == 1 else FWD_TOL)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_softmax_with_cross_entropy(soft):
    rng = np.random.default_rng(4)
    logits = _randn(rng, 6, 10) * 3
    if soft:
        label = np.abs(_randn(rng, 6, 10))
        label /= label.sum(-1, keepdims=True)
    else:
        label = rng.integers(0, 10, (6, 1)).astype(np.int64)
        label[2, 0] = -100          # ignore_index
    _check("softmax_with_cross_entropy", {"Logits": [logits],
                                          "Label": [label]},
           {"Softmax": 1, "Loss": 1},
           {"soft_label": soft, "ignore_index": -100, "axis": -1,
            "vocab_chunk": 0}, ["Loss"], ["Logits"])


def test_mul():
    rng = np.random.default_rng(5)
    _check("mul", {"X": [_randn(rng, 3, 4, 2, 5)], "Y": [_randn(rng, 10, 7)]},
           {"Out": 1}, {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["Out"],
           ["X", "Y"])


def test_sum():
    rng = np.random.default_rng(6)
    _check("sum", {"X": [_randn(rng, 3, 4) for _ in range(3)]}, {"Out": 1},
           {}, ["Out"], ["X"])


@pytest.mark.parametrize("axis,yshape", [(1, (4,)), (-1, (5,)),
                                         (1, (4, 5))],
                         ids=["bias_axis1", "trailing", "axis1_2d"])
def test_elementwise_add(axis, yshape):
    rng = np.random.default_rng(7)
    _check("elementwise_add", {"X": [_randn(rng, 3, 4, 5)],
                               "Y": [_randn(rng, *yshape)]},
           {"Out": 1}, {"axis": axis}, ["Out"], ["X", "Y"])


def test_relu():
    rng = np.random.default_rng(8)
    _check("relu", {"X": [_randn(rng, 4, 6)]}, {"Out": 1}, {}, ["Out"], ["X"])


@pytest.mark.parametrize("attrs", [
    {"dim": [], "keep_dim": False, "reduce_all": True},
    {"dim": [1], "keep_dim": True, "reduce_all": False},
    {"dim": [-1, 0], "keep_dim": False, "reduce_all": False},
], ids=["all", "dim1_keep", "dims"])
def test_reduce_mean(attrs):
    rng = np.random.default_rng(9)
    _check("reduce_mean", {"X": [_randn(rng, 3, 4, 5)]}, {"Out": 1}, attrs,
           ["Out"], ["X"])


def test_square_and_elementwise_sub():
    rng = np.random.default_rng(10)
    _check("square", {"X": [_randn(rng, 4, 3)]}, {"Out": 1}, {}, ["Out"],
           ["X"])
    _check("elementwise_sub", {"X": [_randn(rng, 4, 3)],
                               "Y": [_randn(rng, 4, 3)]},
           {"Out": 1}, {"axis": -1}, ["Out"], ["X", "Y"])
