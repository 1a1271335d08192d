"""Weight-decay regularizers — the port of ``paddle_tpu/regularizer.py``
(the reference's python/paddle/fluid/regularizer.py): L2 adds
``coeff * param`` to the grad, L1 ``coeff * sign(param)``, each as ops
the optimizer's ``apply_gradients`` appends after the clip."""
from __future__ import annotations


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from .framework.layer_helper import LayerHelper

        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(grad.dtype)
        block.append_op(
            type="scale", inputs={"X": [param]}, outputs={"Out": [decay]},
            attrs={"scale": self._coeff},
        )
        out = helper.create_variable_for_type_inference(grad.dtype)
        block.append_op(
            type="sum", inputs={"X": [grad, decay]}, outputs={"Out": [out]}
        )
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from .framework.layer_helper import LayerHelper

        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(grad.dtype)
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = helper.create_variable_for_type_inference(grad.dtype)
        block.append_op(type="scale", inputs={"X": [sign]}, outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        out = helper.create_variable_for_type_inference(grad.dtype)
        block.append_op(type="sum", inputs={"X": [grad, decay]}, outputs={"Out": [out]})
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """Add weight-decay terms onto grads (per-param regularizer wins over the
    optimizer-level default) — parity with regularizer.py append_regularization_ops."""
    out = []
    for p, g in params_grads:
        if g is None:
            out.append((p, g))
            continue
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None:
            out.append((p, g))
            continue
        new_g = reg(p, g, g.block)
        out.append((p, new_g))
    return out
