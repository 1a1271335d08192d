"""Layer functions building IR ops — the slice of ``paddle_tpu/layers/nn.py``
the fluid training path uses (the reference's python/paddle/fluid/
layers/nn.py), with ``create_parameter`` of its ``layers/extras.py``.
Each appends ops through ``LayerHelper``; nothing computes here. The rest
of the reference's layers are still to be ported (ROADMAP A5)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..framework.initializer import ConstantInitializer, NormalInitializer
from ..framework.layer_helper import LayerHelper
from ..framework.param_attr import ParamAttr

__all__ = ["data", "fc", "create_parameter", "embedding", "conv2d",
           "pool2d", "adaptive_pool2d", "batch_norm", "layer_norm",
           "dropout", "relu", "softmax", "softmax_with_cross_entropy",
           "matmul", "clip", "clip_by_norm", "mean", "square_error_cost"]


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


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """fluid.layers.create_parameter (the reference's
    ``layers/extras.py``)."""
    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape=list(shape), dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def embedding(
    input,
    size,
    is_sparse: bool = False,
    is_distributed: bool = False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
):
    """The reference's embedding: one ``lookup_table`` op. ``is_sparse``
    and ``is_distributed`` are kept as attrs; the table's gradient is
    dense."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    w.is_distributed = is_distributed
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = (
        -1 if padding_idx is None
        else padding_idx if padding_idx >= 0
        else size[0] + padding_idx
    )
    helper.append_op(
        type="lookup_table",
        inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [out]},
        attrs={"padding_idx": padding_idx, "is_sparse": is_sparse,
               "is_distributed": is_distributed},
    )
    return out


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


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    helper = LayerHelper("adaptive_pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(pool_size) if isinstance(pool_size, (list, tuple)) else [pool_size] * 2,
            "adaptive": True,
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


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(param_attr, shape=norm_shape, dtype="float32",
                                    default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape, dtype="float32",
                                    is_bias=True)
        inputs["Bias"] = [b]
    mean = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    var = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "dropout_implementation": dropout_implementation,
               "seed": seed if seed is not None else 0},
    )
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1,
                               vocab_chunk=0):
    """``vocab_chunk > 0`` selects the chunked lowering: the loss and its
    backward blocked over the class axis, so the float32 softmax
    intermediates never materialise at full width; the Softmax output is
    not produced in that mode."""
    if vocab_chunk and (return_softmax or soft_label):
        raise ValueError(
            "vocab_chunk CE does not materialize the softmax; "
            "return_softmax/soft_label need vocab_chunk=0")
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


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": alpha},
    )
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"max_norm": max_norm})
    return out


def mean(x, name=None):
    """The mean of every element of ``x`` (the ``mean`` op)."""
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def square_error_cost(input, label):
    """(input - label)² element by element (the ``mse_loss`` op)."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="mse_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out
