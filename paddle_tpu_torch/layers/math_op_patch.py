"""Operator overloads for static-graph Variables — the port of
``paddle_tpu/layers/math_op_patch.py``."""
from __future__ import annotations

import numpy as np


def binary_op(self, other, op_type, reverse=False):
    from ..framework.layer_helper import LayerHelper
    from ..framework.program import Variable
    from . import tensor as tl

    if not isinstance(other, Variable):
        # scalar fast-paths via scale op
        if np.isscalar(other):
            if op_type == "elementwise_add":
                return tl.scale(self, scale=1.0, bias=float(other))
            if op_type == "elementwise_sub":
                if reverse:
                    return tl.scale(self, scale=-1.0, bias=float(other))
                return tl.scale(self, scale=1.0, bias=-float(other))
            if op_type == "elementwise_mul":
                return tl.scale(self, scale=float(other))
            if op_type == "elementwise_div" and not reverse:
                return tl.scale(self, scale=1.0 / float(other))
        other = tl.fill_constant(
            shape=list(self.shape) if all(d != -1 for d in self.shape) else [1],
            dtype=self.dtype,
            value=float(other),
        )
    x, y = (other, self) if reverse else (self, other)
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out
