"""Layer-function API — the slice of ``paddle_tpu/layers`` the fluid
training path uses, with the eight LR schedules; every other name of the
reference's ``layers`` raises ``NotImplementedError`` naming ROADMAP
A5."""
from . import collective  # noqa: F401
from . import math_op_patch  # noqa: F401
from . import nn  # noqa: F401
from . import tensor  # noqa: F401
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from . import learning_rate_scheduler  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    cosine_decay,
    exponential_decay,
    inverse_time_decay,
    linear_lr_warmup,
    natural_exp_decay,
    noam_decay,
    piecewise_decay,
    polynomial_decay,
)
from ..framework.core import not_ported


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    not_ported("layers", name)
