"""Tensor layer functions — the slice of ``paddle_tpu/layers/tensor.py``
the fluid training path uses. The rest of the reference's layers are
still to be ported (ROADMAP A5)."""
from __future__ import annotations

from ..framework.layer_helper import LayerHelper

__all__ = ["uniform_random", "randint", "create_global_var", "cast",
           "fill_constant", "reduce_mean", "scale", "elementwise_add",
           "square"]


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


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_mean", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type="reduce_mean",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"dim": dim if dim is not None else [],
               "keep_dim": keep_dim,
               "reduce_all": dim is None},
    )
    return out


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


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="elementwise_add", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def square(x, name=None):
    helper = LayerHelper("square", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="square", inputs={"X": [x]}, outputs={"Out": [out]})
    return out
