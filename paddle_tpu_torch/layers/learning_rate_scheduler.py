"""LR schedulers — the port of ``paddle_tpu/layers/learning_rate_scheduler.py``
(the reference's fluid/layers/learning_rate_scheduler.py: noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup).

Each returns a Variable computed from the global step counter
(``@LR_DECAY_COUNTER@``, an int64 persistable that an ``increment``
prepended to block 0 advances once a run), so the schedule runs inside the
program, on the device, with no host read."""
from __future__ import annotations

import math

from ..framework.layer_helper import LayerHelper
from . import tensor as tl


def _global_step():
    from ..optimizer import _get_or_create_global_step

    step = _get_or_create_global_step()
    return tl.cast(step, "float32")


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _global_step()
    a = tl.elementwise_pow(step, tl.fill_constant([1], "float32", -0.5))
    b = step * (warmup_steps ** -1.5)
    lr = (d_model ** -0.5) * tl.elementwise_min(a, b)
    return lr * learning_rate if learning_rate != 1.0 else lr


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    div = step / float(decay_steps)
    if staircase:
        helper = LayerHelper("floor")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="floor", inputs={"X": [div]}, outputs={"Out": [out]})
        div = out
    return tl.elementwise_mul(
        tl.fill_constant([1], "float32", learning_rate),
        tl.elementwise_pow(tl.fill_constant([1], "float32", decay_rate), div),
    )


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    div = step / float(decay_steps)
    if staircase:
        helper = LayerHelper("floor")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="floor", inputs={"X": [div]}, outputs={"Out": [out]})
        div = out
    exponent = tl.scale(div, scale=-decay_rate)
    return tl.scale(tl.exp(exponent), scale=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    div = step / float(decay_steps)
    if staircase:
        helper = LayerHelper("floor")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="floor", inputs={"X": [div]}, outputs={"Out": [out]})
        div = out
    denom = tl.scale(div, scale=decay_rate, bias=1.0)
    return tl.elementwise_div(tl.fill_constant([1], "float32", learning_rate), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _global_step()
    ds = tl.fill_constant([1], "float32", float(decay_steps))
    capped = tl.elementwise_min(step, ds)
    frac = tl.elementwise_div(capped, ds)
    one_minus = tl.scale(frac, scale=-1.0, bias=1.0)
    poly = tl.elementwise_pow(one_minus, tl.fill_constant([1], "float32", power))
    return tl.scale(poly, scale=learning_rate - end_learning_rate,
                    bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """Implemented with nested where-selects over the step counter."""
    step = _global_step()
    lr = tl.fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        below = tl.less_than(step, tl.fill_constant([1], "float32", float(b)))
        lr = tl.where(below, tl.fill_constant([1], "float32", v), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step()
    epoch_f = tl.scale(step, scale=1.0 / step_each_epoch)
    helper = LayerHelper("floor")
    epoch = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="floor", inputs={"X": [epoch_f]}, outputs={"Out": [epoch]})
    inner = tl.scale(epoch, scale=math.pi / epochs)
    helper2 = LayerHelper("cos")
    cosv = helper2.create_variable_for_type_inference("float32")
    helper2.append_op(type="cos", inputs={"X": [inner]}, outputs={"Out": [cosv]})
    return tl.scale(cosv, scale=0.5 * learning_rate, bias=0.0) + tl.fill_constant(
        [1], "float32", 0.5 * learning_rate
    )


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step()
    if not hasattr(learning_rate, "name"):  # scalar
        learning_rate = tl.fill_constant([1], "float32", float(learning_rate))
    warm = tl.scale(step, scale=(end_lr - start_lr) / float(warmup_steps), bias=start_lr)
    in_warmup = tl.less_than(step, tl.fill_constant([1], "float32", float(warmup_steps)))
    return tl.where(in_warmup, warm, learning_rate)
