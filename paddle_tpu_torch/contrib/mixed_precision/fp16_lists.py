"""Op classification for AMP — the port of
``paddle_tpu/contrib/mixed_precision/fp16_lists.py`` (the reference's
contrib/mixed_precision/fp16_lists.py white/black/gray lists), its sets
copied verbatim. The same lists govern the bf16 and fp16 rewrites.
"""
from __future__ import annotations

import copy

__all__ = ["AutoMixedPrecisionLists"]

# ops that benefit and are numerically safe in low precision (matrix products)
white_list = {
    "conv2d", "conv3d", "depthwise_conv2d", "conv2d_transpose",
    "matmul", "matmul_v2", "mul", "bmm",
}

# numerically dangerous in low precision — always compute in fp32
black_list = {
    "exp", "log", "square", "sqrt", "rsqrt", "pow", "logsumexp",
    "mean", "reduce_mean", "reduce_sum", "sum",
    "softmax_with_cross_entropy", "cross_entropy", "bce_loss",
    "sigmoid_cross_entropy_with_logits", "smooth_l1_loss", "huber_loss",
    "kldiv_loss", "mse_loss",
    "layer_norm", "group_norm", "instance_norm",
    "l2_normalize", "cumsum", "update_loss_scaling",
}

# follow their inputs: low precision if inputs already are
gray_list = {
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min",
    "relu", "relu6", "leaky_relu", "gelu", "sigmoid", "tanh", "elu", "silu",
    "swish", "hard_swish", "hard_sigmoid", "prelu", "softplus", "softsign",
    "batch_norm", "pool2d", "dropout",
    "reshape", "reshape2", "transpose", "transpose2", "squeeze", "squeeze2",
    "unsqueeze", "unsqueeze2", "flatten", "flatten2",
    "flatten_contiguous_range", "concat", "split", "stack", "slice",
    "strided_slice", "gather", "scatter", "expand", "expand_v2", "tile",
    "pad", "pad2d", "scale", "clip", "softmax", "top_k", "top_k_v2",
    "lookup_table", "lookup_table_v2",
}

# ops AMP must never touch (bookkeeping, feed/fetch, control flow, AMP's own)
_unsupported = {
    "fill_constant", "assign", "cast", "while", "conditional_block",
    "increment", "check_finite_and_unscale", "amp_check_finite_and_scale",
}


class AutoMixedPrecisionLists:
    """Merge the default lists with user overrides
    (custom_white_list / custom_black_list / custom_black_varnames)."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = copy.copy(white_list)
        self.black_list = copy.copy(black_list)
        self.gray_list = copy.copy(gray_list)
        self.unsupported_list = copy.copy(_unsupported)
        self.black_varnames = set(custom_black_varnames or [])
        for op in custom_white_list or []:
            if op in (custom_black_list or []):
                raise ValueError(f"op {op} in both custom white and black lists")
            self.white_list.add(op)
            self.black_list.discard(op)
            self.gray_list.discard(op)
        for op in custom_black_list or []:
            self.black_list.add(op)
            self.white_list.discard(op)
            self.gray_list.discard(op)
