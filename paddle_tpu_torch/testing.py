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
           "WRAPPER_CASES", "optimizer_mlp", "mlp_feed"]

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
