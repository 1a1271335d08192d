"""Layer functions building IR ops — the slice of ``paddle_tpu/layers/nn.py``
the fluid training path uses (the reference's python/paddle/fluid/
layers/nn.py). Each appends ops through ``LayerHelper``; nothing computes
here. The rest of the reference's layers are still to be ported (ROADMAP
A5)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..framework.core import not_ported
from ..framework.initializer import ConstantInitializer, NormalInitializer
from ..framework.layer_helper import LayerHelper
from ..framework.param_attr import ParamAttr

__all__ = ["data", "fc", "conv2d", "pool2d", "batch_norm", "relu",
           "softmax_with_cross_entropy"]


def data(
    name: str,
    shape: Sequence[int],
    dtype: str = "float32",
    append_batch_size: bool = True,
    lod_level: int = 0,
    stop_gradient: bool = True,
):
    """Declare a feed slot; a leading batch dim of -1 is prepended when
    ``append_batch_size``."""
    helper = LayerHelper("data")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.main_program.global_block().create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        is_data=True,
        stop_gradient=stop_gradient,
        need_check_feed=True,
    )


def fc(
    input,
    size: int,
    num_flatten_dims: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
):
    """Fully connected: mul + sum + bias + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        input_shape = inp.shape
        in_features = int(np.prod(input_shape[num_flatten_dims:]))
        w = helper.create_parameter(
            param_attr, shape=[in_features, size], dtype=inp.dtype
        )
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op(type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def conv2d(
    input,
    num_filters: int,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups: int = 1,
    param_attr=None,
    bias_attr=None,
    use_cudnn: bool = True,  # accepted, ignored
    act: Optional[str] = None,
    name: Optional[str] = None,
    data_format: str = "NCHW",
):
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    channel_axis = 1 if data_format == "NCHW" else 3
    num_channels = input.shape[channel_axis]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
    filter_shape = [num_filters, num_channels // groups] + list(fsize)

    # MSRA normal, the reference's default for conv filters
    fan_in = (num_channels // groups) * int(np.prod(fsize))
    default_init = NormalInitializer(0.0, math.sqrt(2.0 / fan_in))
    w = helper.create_parameter(
        param_attr, shape=filter_shape, dtype=input.dtype,
        default_initializer=default_init,
    )
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={
            "strides": list(stride) if isinstance(stride, (list, tuple)) else [stride] * 2,
            "paddings": list(padding) if isinstance(padding, (list, tuple)) else [padding] * 2,
            "dilations": list(dilation) if isinstance(dilation, (list, tuple)) else [dilation] * 2,
            "groups": groups,
            "data_format": data_format,
        },
    )
    if bias_attr is not False:
        pre_act = helper.append_bias_op(out, dim_start=channel_axis, dim_end=channel_axis + 1)
    else:
        pre_act = out
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None,
           exclusive=True, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(pool_size) if isinstance(pool_size, (list, tuple)) else [pool_size] * 2,
            "strides": list(pool_stride) if isinstance(pool_stride, (list, tuple)) else [pool_stride] * 2,
            "paddings": list(pool_padding) if isinstance(pool_padding, (list, tuple)) else [pool_padding] * 2,
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
            "data_format": data_format,
        },
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW", in_place=False,
               name=None, moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True, use_global_stats=False):
    helper = LayerHelper("batch_norm", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = "float32"  # stats and scale in f32 even for bf16 activations
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype, is_bias=True)

    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False),
        shape=[c], dtype=dtype, default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False),
        shape=[c], dtype=dtype, default_initializer=ConstantInitializer(1.0))

    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout, "use_global_stats": use_global_stats},
    )
    return helper.append_activation(out)


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1,
                               vocab_chunk=0):
    if vocab_chunk:
        not_ported("layers", "softmax_with_cross_entropy(vocab_chunk>0)")
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis,
               "vocab_chunk": int(vocab_chunk)},
    )
    if return_softmax:
        return loss, softmax_out
    return loss
