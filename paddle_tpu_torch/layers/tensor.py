"""Tensor layer functions — the slice of ``paddle_tpu/layers/tensor.py``
the fluid training path uses (ResNet, the MLPs, the gradient clips, the
LR schedules and the transformer encoder). The rest of the reference's
layers are still to be ported (ROADMAP A5)."""
from __future__ import annotations

from ..framework.layer_helper import LayerHelper

__all__ = ["uniform_random", "randint", "create_global_var", "cast",
           "fill_constant", "sums", "reshape", "slice", "where",
           "reduce_sum", "reduce_mean", "scale", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow",
           "less_than", "greater_than", "clip", "sqrt", "square", "exp",
           "sign"]


def _random_layer(op_type, shape, dtype, attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type=op_type, inputs={}, outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype, **attrs})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    return _random_layer("uniform_random", shape, dtype,
                         {"min": float(min), "max": float(max),
                          "seed": int(seed)})


def randint(low, high=None, shape=(1,), dtype="int64", seed=0):
    if high is None:
        low, high = 0, low
    return _random_layer("randint", shape, dtype,
                         {"low": int(low), "high": int(high),
                          "seed": int(seed)})


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    from ..framework.initializer import ConstantInitializer
    from ..framework.program import default_startup_program

    helper = LayerHelper("global_var", name=name)
    var = helper.main_program.global_block().create_var(
        name=name or helper.name, shape=shape, dtype=dtype, persistable=persistable
    )
    startup = default_startup_program().global_block()
    sv = startup.create_var(name=var.name, shape=shape, dtype=dtype, persistable=persistable)
    ConstantInitializer(value)(sv, startup)
    return var


def cast(x, dtype):
    from ..framework.core import convert_dtype

    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype, "in_dtype": x.dtype})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    out.stop_gradient = True
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(
        type="reshape2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts),
               "ends": list(ends), "decrease_axis": []},
    )
    return out


def where(condition, x, y):
    """Elementwise select (paddle.where semantics)."""
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="where",
        inputs={"Condition": [condition], "X": [x], "Y": [y]},
        outputs={"Out": [out]},
    )
    return out


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is not None and not isinstance(dim, (list, tuple)):
            dim = [dim]
        helper.append_op(
            type=op_type,
            inputs={"X": [input]},
            outputs={"Out": [out]},
            attrs={"dim": dim if dim is not None else [],
                   "keep_dim": keep_dim,
                   "reduce_all": dim is None},
        )
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def _binary_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out_dtype = "bool" if op_type in ("less_than", "greater_than") \
            else x.dtype
        out = helper.create_variable_for_type_inference(out_dtype)
        attrs = {"axis": axis} if op_type.startswith("elementwise") else {}
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs=attrs)
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _binary_layer("elementwise_add")
elementwise_sub = _binary_layer("elementwise_sub")
elementwise_mul = _binary_layer("elementwise_mul")
elementwise_div = _binary_layer("elementwise_div")
elementwise_max = _binary_layer("elementwise_max")
elementwise_min = _binary_layer("elementwise_min")
elementwise_pow = _binary_layer("elementwise_pow")
less_than = _binary_layer("less_than")
greater_than = _binary_layer("greater_than")


def clip(x, min, max, name=None):
    from .nn import clip as _clip

    return _clip(x, min, max, name)


def _unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


sqrt = _unary("sqrt")
square = _unary("square")
exp = _unary("exp")
sign = _unary("sign")
