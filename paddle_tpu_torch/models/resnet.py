"""ResNet family — static-graph model functions in the fluid layer style, the
port of ``paddle_tpu/models/resnet.py``: ResNet-18/34/50/101/152 with the
reference's parameter names, built through ``layers`` (conv2d + batch_norm
+ relu blocks, max and global-average pooling, an fc head). Convs run
through cuDNN on the card (``ops/nn.py``).
"""
from __future__ import annotations

from typing import Optional

from .. import layers
from ..framework.param_attr import ParamAttr

__all__ = ["resnet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _conv_bn(x, num_filters, filter_size, stride=1, groups=1, act=None,
             is_test=False, name: str = ""):
    x = layers.conv2d(
        x, num_filters, filter_size, stride=stride,
        padding=(filter_size - 1) // 2, groups=groups,
        param_attr=ParamAttr(name=name + "_weights"), bias_attr=False,
        name=name + ".conv")
    return layers.batch_norm(
        x, act=act, is_test=is_test,
        param_attr=ParamAttr(name=name + "_bn_scale"),
        bias_attr=ParamAttr(name=name + "_bn_offset"),
        moving_mean_name=name + "_bn_mean",
        moving_variance_name=name + "_bn_variance")


def _shortcut(x, out_ch, stride, is_test, name):
    in_ch = x.shape[1]
    if in_ch != out_ch or stride != 1:
        return _conv_bn(x, out_ch, 1, stride=stride, is_test=is_test,
                        name=name)
    return x


def _basic_block(x, num_filters, stride, is_test, name):
    y = _conv_bn(x, num_filters, 3, stride=stride, act="relu",
                 is_test=is_test, name=name + "_branch2a")
    y = _conv_bn(y, num_filters, 3, is_test=is_test, name=name + "_branch2b")
    short = _shortcut(x, num_filters, stride, is_test, name + "_branch1")
    return layers.relu(layers.elementwise_add(short, y))


def _bottleneck_block(x, num_filters, stride, is_test, name):
    y = _conv_bn(x, num_filters, 1, act="relu", is_test=is_test,
                 name=name + "_branch2a")
    y = _conv_bn(y, num_filters, 3, stride=stride, act="relu",
                 is_test=is_test, name=name + "_branch2b")
    y = _conv_bn(y, num_filters * 4, 1, is_test=is_test,
                 name=name + "_branch2c")
    short = _shortcut(x, num_filters * 4, stride, is_test, name + "_branch1")
    return layers.relu(layers.elementwise_add(short, y))


def resnet(input, class_dim: int = 1000, depth: int = 50,
           is_test: bool = False, prefix: str = "res"):
    """Build a ResNet classifier head over ``input`` (NCHW float tensor).

    Returns pre-softmax logits [N, class_dim].
    """
    if depth not in _DEPTH_CFG:
        raise ValueError(f"depth must be one of {sorted(_DEPTH_CFG)}")
    kind, counts = _DEPTH_CFG[depth]
    block = _basic_block if kind == "basic" else _bottleneck_block

    x = _conv_bn(input, 64, 7, stride=2, act="relu", is_test=is_test,
                 name=prefix + "_conv1")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    num_filters = [64, 128, 256, 512]
    for stage, count in enumerate(counts):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            x = block(x, num_filters[stage], stride, is_test,
                      f"{prefix}{stage + 2}{chr(ord('a') + i)}")
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(x, class_dim,
                     param_attr=ParamAttr(name=prefix + "_fc_weights"),
                     bias_attr=ParamAttr(name=prefix + "_fc_offset"))


class ResNet:
    """Class-style wrapper matching PaddleClas-era usage:
    ``ResNet(layers=50).net(input, class_dim=1000)``."""

    def __init__(self, layers: int = 50, prefix: str = "res"):
        self.depth = layers
        self.prefix = prefix

    def net(self, input, class_dim: int = 1000, is_test: bool = False):
        return resnet(input, class_dim=class_dim, depth=self.depth,
                      is_test=is_test, prefix=self.prefix)


def resnet18(input, class_dim=1000, **kw):
    return resnet(input, class_dim, depth=18, **kw)


def resnet34(input, class_dim=1000, **kw):
    return resnet(input, class_dim, depth=34, **kw)


def resnet50(input, class_dim=1000, **kw):
    return resnet(input, class_dim, depth=50, **kw)


def resnet101(input, class_dim=1000, **kw):
    return resnet(input, class_dim, depth=101, **kw)


def resnet152(input, class_dim=1000, **kw):
    return resnet(input, class_dim, depth=152, **kw)
