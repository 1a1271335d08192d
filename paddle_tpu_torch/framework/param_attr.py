"""ParamAttr — the port of paddle_tpu/framework/param_attr.py (the
reference's python/paddle/fluid/param_attr.py)."""
from __future__ import annotations

from typing import Optional


class ParamAttr:
    def __init__(
        self,
        name: Optional[str] = None,
        initializer=None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        do_model_average: bool = False,
        gradient_clip=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.gradient_clip = gradient_clip

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr(trainable=arg) if arg else ParamAttr(trainable=False)
        # an Initializer instance
        return ParamAttr(initializer=arg)

    def _to_kwargs(self, with_initializer=False):
        kw = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "do_model_average": self.do_model_average,
        }
        if with_initializer:
            kw["initializer"] = self.initializer
        return kw

