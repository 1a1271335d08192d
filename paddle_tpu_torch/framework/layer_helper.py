"""LayerHelper — the port of ``paddle_tpu/framework/layer_helper.py`` (the
reference's python/paddle/fluid/layer_helper.py).

Bridges layer functions and the IR: creates parameters (with their init ops in
the default startup program), temp variables, and appends ops to the default
main program.
"""
from __future__ import annotations

from . import unique_name
from .core import dtype_is_floating
from .initializer import (
    ConstantInitializer,
    _global_bias_initializer,
    _global_weight_initializer,
)
from .param_attr import ParamAttr
from .program import default_main_program, default_startup_program


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    def create_parameter(
        self,
        attr,
        shape,
        dtype,
        is_bias: bool = False,
        default_initializer=None,
    ):
        attr = ParamAttr._to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w" if not is_bias else "b"]))
        init = attr.initializer or default_initializer
        if init is None:
            if is_bias:
                init = _global_bias_initializer()
            elif dtype_is_floating(dtype):
                init = _global_weight_initializer()
            else:
                init = ConstantInitializer(0.0)
        # main-program parameter
        param = self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs()
        )
        # startup-program twin + init op
        startup_block = self.startup_program.global_block()
        startup_param = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs()
        )
        init(startup_param, startup_block)
        return param

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        if any(d == -1 for d in size):
            raise ValueError(f"cannot infer bias shape from {input_var.shape}")
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(
            type=act_type, inputs={"X": [input_var]}, outputs={"Out": [tmp]}, attrs=act
        )
        return tmp
