"""Helpers shared by the parity tests and ``chip_smoke.py``: measures
of how far one run's state is from another's, for the bands those
checks hold, and the fluid optimizer cases both hold the port to.

Each case function takes the package (``paddle_tpu_torch`` or the JAX
package, which the parity tests pass in) and its ``unique_name`` module,
so that the two packages build the same program."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["adam_state_gap", "state_gap", "OPTIMIZER_CASES",
           "WRAPPER_CASES", "optimizer_mlp", "mlp_feed", "mesh_program",
           "mesh_feed", "MESH_ENCODER"]

# name -> (the optimizer of a package, whether its rule reduces over a
# whole tensor: lamb's and lars_momentum's norms, dpsgd's clip norm,
# dgc_momentum's top-k threshold, which sum in another order than XLA's)
OPTIMIZER_CASES: Dict[str, Tuple[Callable[[Any], Any], bool]] = {
    "lars_momentum": (lambda pk: pk.optimizer.LarsMomentum(0.1, 0.9), True),
    "adagrad": (lambda pk: pk.optimizer.Adagrad(
        0.01, initial_accumulator_value=0.1), False),
    "decayed_adagrad": (lambda pk: pk.optimizer.DecayedAdagrad(0.01),
                        False),
    "adadelta": (lambda pk: pk.optimizer.Adadelta(1.0), False),
    "adamax": (lambda pk: pk.optimizer.Adamax(0.01), False),
    "dpsgd": (lambda pk: pk.optimizer.Dpsgd(0.1, clip=1.0, batch_size=8.0,
                                            sigma=0.0), True),
    "rmsprop": (lambda pk: pk.optimizer.RMSProp(0.01, momentum=0.5), False),
    "rmsprop_centered": (lambda pk: pk.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True), False),
    "ftrl": (lambda pk: pk.optimizer.Ftrl(0.1, l1=0.01, l2=0.01), False),
    "lamb": (lambda pk: pk.optimizer.Lamb(0.01), True),
    "lamb_exclude": (lambda pk: pk.optimizer.Lamb(
        0.01, exclude_from_weight_decay_fn=lambda p: p.name.endswith(".b_0")),
        True),
    # the step counter reads 1 in the first run: plain momentum then,
    # the DGC branch from the second step on
    "dgc_momentum": (lambda pk: pk.optimizer.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=2, sparsity=[0.5]), True),
}

# the wrappers' cases: name -> the keyword arguments of optimizer_mlp
WRAPPER_CASES: Dict[str, Dict[str, Any]] = {
    "lookahead": dict(wrap="lookahead"),
    "ema": dict(wrap="ema"),
    "model_average": dict(wrap="model_average"),
    "recompute_lamb": dict(wrap="recompute", dropout=0.1),
    "gradmerge_momentum_bn": dict(wrap="gradmerge", bn=True),
}


def optimizer_mlp(pk, un, factory=None, wrap=None, dropout=0.0, bn=False,
                  seed=7):
    """(main, startup, loss, extra) of the fluid MLP the optimizer cases
    train: x [8] -> fc 16 relu (-> dropout) -> fc 16 relu (batch norm
    before the relu with ``bn``) -> fc 1, the mean square error against
    y, built under ``un.guard()`` in package ``pk``. ``factory(pk)`` is
    the optimizer; ``wrap``: "lookahead" (``LookaheadOptimizer(SGD(0.1),
    0.5, k=2)``), "ema" (``SGD(0.1)`` then ``ExponentialMovingAverage(0.9)
    .update()``), "model_average" (``ModelAverage(0.15)``), "recompute"
    (``RecomputeOptimizer(Lamb(0.01))`` with the two hidden outputs as
    checkpoints), "gradmerge" (``GradientMergeOptimizer(Momentum(0.1,
    0.9, fuse=True), k_steps=2)``). ``extra``: the averager (ema,
    model_average), the hidden outputs (recompute), else None."""
    extra = None
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = seed
        with pk.program_guard(main, startup):
            x = pk.layers.data(name="x", shape=[8], dtype="float32")
            label = pk.layers.data(name="y", shape=[1], dtype="float32")
            h1 = pk.layers.fc(x, size=16, act="relu")
            if dropout:
                h1 = pk.layers.dropout(h1, dropout_prob=dropout)
            h2 = pk.layers.fc(h1, size=16)
            if bn:
                h2 = pk.layers.batch_norm(h2)
            h2 = pk.layers.relu(h2)
            y = pk.layers.fc(h2, size=1)
            loss = pk.layers.reduce_mean(pk.layers.square(y - label))
            opt = pk.optimizer
            if wrap is None:
                factory(pk).minimize(loss)
            elif wrap == "lookahead":
                opt.LookaheadOptimizer(opt.SGD(0.1), alpha=0.5,
                                       k=2).minimize(loss)
            elif wrap in ("ema", "model_average"):
                opt.SGD(0.1).minimize(loss)
                extra = (opt.ExponentialMovingAverage(0.9) if wrap == "ema"
                         else opt.ModelAverage(0.15))
                extra.update()
            elif wrap == "recompute":
                rec = opt.RecomputeOptimizer(opt.Lamb(0.01))
                rec._set_checkpoints([h1, h2])
                rec.minimize(loss)
                extra = (h1, h2)
            elif wrap == "gradmerge":
                opt.GradientMergeOptimizer(opt.Momentum(0.1, 0.9, fuse=True),
                                           k_steps=2).minimize(loss)
            else:
                raise ValueError(f"unknown wrapper {wrap!r}")
    return main, startup, loss, extra


def mlp_feed(rows: int = 8, seed: int = 0) -> Dict[str, np.ndarray]:
    """The optimizer cases' feed: x [rows, 8] and y [rows, 1], standard
    normal from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((rows, 8)).astype(np.float32),
            "y": rng.standard_normal((rows, 1)).astype(np.float32)}


def state_gap(got: Dict[str, Any], want: Dict[str, Any]) -> Tuple[float, str]:
    """(the worst max |got - want| over a persistable's scale, the larger
    of its largest |want| and 1; its name), over ``want``'s names."""
    worst, worst_name = 0.0, ""
    for n, ref in want.items():
        ref = np.asarray(ref, np.float64)
        diff = np.abs(np.asarray(got[n], np.float64) - ref).max(initial=0.0)
        ratio = diff / max(np.abs(ref).max(initial=0.0), 1.0)
        if ratio > worst or not worst_name:
            worst, worst_name = float(ratio), n
    return worst, worst_name


def adam_state_gap(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor], prog, lr: float,
                   noise_floor: float = 1e-4
                   ) -> Tuple[float, str, float, int]:
    """How far the persistables ``got`` (name -> tensor) are from
    ``want`` after Adam steps of ``prog``: (the worst max |diff| over a
    persistable's scale — the larger of its largest |value| and ``lr``,
    which a bias that starts at 0 moves by —, its name, the worst |diff|
    at a parameter element whose gradient sits at its noise floor, the
    count of such elements). A noise-floor element is one whose first
    Adam moment (its own accumulator or its slice of a fused group's) is
    at most ``noise_floor`` of its tensor's largest: Adam divides each
    gradient element by its own root mean square, so there the step
    follows the rounding of the gradient, up to lr a step, and such
    elements are left out of the worst ratio."""
    block = prog.global_block()
    m1_of = {}
    for op in block.ops:
        if op.type in ("adam", "adamw"):
            m1_of[op.input("Param")[0]] = (op.input("Moment1")[0], None)
        elif op.type in ("fused_adam", "fused_adamw"):
            off = 0
            for p in op.input("Param"):
                n = int(np.prod(block.var(p).shape))
                m1_of[p] = (op.input("Moment1")[0], (off, off + n))
                off += n
    worst, worst_name, floor_worst, n_floor = 0.0, "", 0.0, 0
    for n, ref in want.items():
        ref = ref.double()
        diff = (got[n].double() - ref).abs()
        scale = max(ref.abs().max().item(), lr)
        if n in m1_of:
            m1_name, span = m1_of[n]
            m1 = want[m1_name].double().abs()
            if span is not None:
                m1 = m1[span[0]:span[1]]
            m1 = m1.reshape(diff.shape)
            floor = m1 <= noise_floor * m1.max()
            n_floor += int(floor.sum())
            if floor.any():
                floor_worst = max(floor_worst, diff[floor].max().item())
            diff = torch.where(floor, 0.0, diff)
        ratio = diff.max().item() / scale
        if ratio > worst:
            worst, worst_name = ratio, n
    return worst, worst_name, floor_worst, n_floor


# ---------------------------------------------------------------------------
# the fluid mesh's cases (data parallel, per-rank, pipeline)
# ---------------------------------------------------------------------------

MESH_ENCODER = dict(vocab_size=50, max_pos=16, num_layers=2, num_heads=2,
                    d_model=16, d_ff=32, num_classes=2)


def _mesh_optimizer(pk, opt: str, lr: float):
    o = pk.optimizer
    if opt == "sgd":
        return o.SGD(lr)
    if opt == "momentum":
        return o.Momentum(lr, 0.9, fuse=True)
    if opt == "adam":
        return o.Adam(lr)
    if opt == "adamw_clip":
        return o.AdamW(lr, weight_decay=0.01,
                       grad_clip=pk.clip.GradientClipByGlobalNorm(1.0))
    if opt == "dgc_keep":
        return o.DGCMomentumOptimizer(lr, 0.9, rampup_begin_step=0,
                                      sparsity=[0.0])
    if opt == "dgc_sparse":
        return o.DGCMomentumOptimizer(lr, 0.9, rampup_begin_step=0,
                                      sparsity=[0.5])
    raise ValueError(f"unknown optimizer {opt!r}")


def mesh_program(pk, un, net: str = "mlp", opt: str = "sgd",
                 lr: float = 0.05, wrap=None, seed: int = 7,
                 stages: int = 2, microbatches: int = 2, cut: bool = False,
                 k: int = 2, amp: bool = False, loss_op: str = "mean",
                 sync_grads: bool = False, remat=None):
    """(main, startup, loss) of a fluid mesh case built under
    ``un.guard()`` in package ``pk``. ``net``: "mlp" (x [8] -> fc 16 relu
    -> fc 16 relu -> fc 1, the mean square error: the reference's
    pipeline and compose tests' net, params w1..b3), "int_cut" (an int32
    mask made in stage 0 gates stage 1), "bn_mlp" (batch norm after the
    first fc), "conv_bn" (img [3, 8, 8] -> conv 4
    3x3 -> batch norm -> relu -> fc 4, softmax CE), "classifier" (x [8]
    -> fc 16 relu -> fc 4, softmax CE: the DGC tests' net), "encoder"
    (``transformer_encoder_classifier`` at MESH_ENCODER over src / pos
    [8] and label), "bn_square" (fc 12 -> batch norm -> relu -> fc 1,
    the sync-BN test's net). ``loss_op`` ("mean", "reduce_sum", "scale":
    twice the mean, "batch_sum": a reduce_sum over the batch feeding the
    mean, "in_batch": the mean of the rows' similarities err·errᵀ,
    "batch_softmax": the mean of a softmax over the batch) makes the
    MLP's loss. ``opt`` (see ``_mesh_optimizer``) at
    ``lr``; ``wrap``: "pipeline" (``PipelineOptimizer``: ``stages``
    even, or the cut after the first hidden layer with ``cut``,
    ``microbatches``, each stage under the ``remat`` policy), "merge"
    (``GradientMergeOptimizer(k_steps=k)``);
    ``amp``: ``decorate(use_bf16=True)`` around the optimizer;
    ``sync_grads``: a ``c_allreduce_avg`` of each gradient before the
    update (as a collective transpile inserts it)."""
    import importlib

    L = pk.layers
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = seed
        cuts = None
        with pk.program_guard(main, startup):
            if net in ("mlp", "int_cut", "bn_mlp"):
                x = L.data("x", [8], dtype="float32")
                y = L.data("y", [1], dtype="float32")
                h1 = L.fc(x, 16, act="relu",
                          param_attr=pk.ParamAttr("w1"),
                          bias_attr=pk.ParamAttr("b1"))
                cuts = [[h1]]
                h = h1
                if net == "bn_mlp":
                    h = L.batch_norm(h1, momentum=0.8,
                                     moving_mean_name="bn_mean",
                                     moving_variance_name="bn_variance")
                h2 = L.fc(h, 16, act="relu", param_attr=pk.ParamAttr("w2"),
                          bias_attr=pk.ParamAttr("b2"))
                if net == "int_cut":
                    mask = L.cast(L.greater_than(
                        h1, L.fill_constant([1], "float32", 0.5)), "int32")
                    h2 = L.elementwise_mul(h2, L.cast(mask, "float32"))
                    cuts = [[h1, mask]]
                pred = L.fc(h2, 1, param_attr=pk.ParamAttr("w3"),
                            bias_attr=pk.ParamAttr("b3"))
                err = L.square_error_cost(pred, y)
                if loss_op == "reduce_sum":
                    loss = L.reduce_sum(err)
                elif loss_op == "scale":
                    loss = L.scale(L.mean(err), 2.0)
                elif loss_op == "batch_sum":
                    loss = L.mean(L.reduce_sum(err, dim=[0]))
                elif loss_op == "in_batch":
                    loss = L.mean(L.matmul(err, err, transpose_y=True))
                elif loss_op == "batch_softmax":
                    loss = L.mean(L.softmax(err, axis=0))
                else:
                    loss = L.mean(err)
            elif net == "bn_square":
                x = L.data("x", [6], dtype="float32")
                y = L.data("y", [1], dtype="float32")
                h = L.relu(L.batch_norm(L.fc(x, 12), momentum=0.8))
                loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
            elif net == "conv_bn":
                img = L.data("img", [3, 8, 8], dtype="float32")
                label = L.data("label", [1], dtype="int64")
                h = L.conv2d(img, 4, 3, padding=1)
                h = L.relu(L.batch_norm(h))
                loss = L.reduce_mean(L.softmax_with_cross_entropy(
                    L.fc(h, 4), label))
            elif net == "classifier":
                x = L.data("x", [8], dtype="float32")
                y = L.data("y", [1], dtype="int64")
                h = L.fc(x, 16, act="relu")
                loss = L.reduce_mean(L.softmax_with_cross_entropy(
                    L.fc(h, 4), y))
            elif net == "encoder":
                te = importlib.import_module(
                    pk.__name__ + ".models.transformer_encoder")
                seq = MESH_ENCODER["max_pos"] // 2
                src = L.data("src", [seq], dtype="int64")
                pos = L.data("pos", [seq], dtype="int64")
                label = L.data("label", [1], dtype="int64")
                loss, _ = te.transformer_encoder_classifier(
                    src, pos, label, **MESH_ENCODER)
            else:
                raise ValueError(f"unknown net {net!r}")
            inner = _mesh_optimizer(pk, opt, lr)
            if amp:
                mp = importlib.import_module(
                    pk.__name__ + ".contrib.mixed_precision")
                inner = mp.decorate(inner, use_bf16=True)
            if wrap == "pipeline":
                pk.optimizer.PipelineOptimizer(
                    inner, cut_list=cuts if cut else None,
                    num_stages=None if cut else stages,
                    num_microbatches=microbatches,
                    remat_policy=remat).minimize(loss)
            elif wrap == "merge":
                pk.optimizer.GradientMergeOptimizer(
                    inner, k_steps=k).minimize(loss)
            elif sync_grads:
                _, pgs = inner.minimize(loss)
                block = main.global_block()
                at = next(i for i, op in enumerate(block.ops)
                          if int(op.attr("op_role", 0) or 0) == 2)
                for _p, g in sorted(pgs, key=lambda pg: pg[0].name):
                    block._insert_op(at, type="c_allreduce_avg",
                                     inputs={"X": [g]},
                                     outputs={"Out": [g]},
                                     attrs={"ring_id": 0})
            else:
                inner.minimize(loss)
    return main, startup, loss


def mesh_feed(net: str = "mlp", rows: int = 16, seed: int = 0
              ) -> Dict[str, np.ndarray]:
    """A global batch of ``rows`` for ``mesh_program``'s ``net``, from
    numpy seed ``seed``."""
    rng = np.random.RandomState(seed)
    if net in ("mlp", "int_cut", "bn_mlp"):
        x = rng.randn(rows, 8).astype(np.float32)
        return {"x": x, "y": (x.sum(1, keepdims=True) > 0).astype(
            np.float32)}
    if net == "bn_square":
        x = rng.randn(rows, 6).astype(np.float32)
        x[: rows // 2] *= 3.0
        return {"x": x, "y": (0.1 * x.sum(1, keepdims=True)).astype(
            np.float32)}
    if net == "conv_bn":
        return {"img": rng.randn(rows, 3, 8, 8).astype(np.float32),
                "label": rng.randint(0, 4, (rows, 1)).astype(np.int64)}
    if net == "classifier":
        x = rng.rand(rows, 8).astype(np.float32)
        return {"x": x, "y": x[:, :4].argmax(1).astype(np.int64)
                .reshape(rows, 1)}
    if net == "encoder":
        seq = MESH_ENCODER["max_pos"] // 2
        return {"src": rng.randint(0, MESH_ENCODER["vocab_size"],
                                   (rows, seq)).astype(np.int64),
                "pos": np.tile(np.arange(seq), (rows, 1)).astype(np.int64),
                "label": rng.randint(0, 2, (rows, 1)).astype(np.int64)}
    raise ValueError(f"unknown net {net!r}")
