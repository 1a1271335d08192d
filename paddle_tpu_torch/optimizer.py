"""Optimizer classes — the slice of ``paddle_tpu/optimizer.py`` the fluid
training path uses: ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``.

``minimize`` = ``append_backward`` + the gradient clip (``grad_clip=``,
``clip.py``) + the regularizers (``regularization=`` and each
parameter's own, ``regularizer.py``) + one update op per parameter, or,
with ``fuse=True`` (or ``FLAGS_fuse_optimizer``), one fused flat-buffer
update op per (dtype, lr-multiplier) group whose moments are flat [numel]
accumulators; each fused op runs its group through the optimizer kernel
(``ops/optimizer_ops.py``). A ``learning_rate`` Variable (an LR schedule,
``layers/learning_rate_scheduler.py``) feeds the update ops as it is.
Dygraph mode (``parameter_list``) and the other optimizers are still to
be ported (ROADMAP A5).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .framework import unique_name
from .framework.backward import append_backward
from .framework.core import get_flag, not_ported
from .framework.initializer import ConstantInitializer
from .framework.program import (
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
)

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer", "AdamW"]


class Optimizer:
    # the fused op type this optimizer lowers to when fusion is on
    _fused_op_type: Optional[str] = None

    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None, parameter_list=None):
        if parameter_list is not None:
            not_ported("Optimizer", "parameter_list (dygraph)")
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None
        self.type = "optimizer"
        self._fuse = False

    # -- learning rate ------------------------------------------------------
    def _create_lr_var(self, program: Program) -> Variable:
        if isinstance(self._learning_rate, Variable):
            return self._learning_rate
        if self._lr_var is not None and self._lr_var.block.program is program:
            return self._lr_var
        from .layers.tensor import create_global_var

        name = unique_name.generate("learning_rate")
        self._lr_var = create_global_var(
            shape=[1], value=float(self._learning_rate), dtype="float32",
            persistable=True, name=name,
        )
        return self._lr_var

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter, fill_value=0.0,
                         shape=None, dtype="float32") -> Variable:
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        acc_name = unique_name.generate(f"{param.name}_{name}")
        shape = list(shape if shape is not None else param.shape)
        main_block = default_main_program().global_block()
        var = main_block.create_var(
            name=acc_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True,
        )
        startup_block = default_startup_program().global_block()
        sv = startup_block.create_var(
            name=acc_name, shape=shape, dtype=dtype, persistable=True
        )
        ConstantInitializer(fill_value)(sv, startup_block)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    # -- main entry ---------------------------------------------------------
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_optimize(loss, startup_program, params_grads)
        return optimize_ops, params_grads

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        program = default_main_program()
        # every op appended here is the optimize slice
        with program.op_role_guard(program.OP_ROLE_OPTIMIZE):
            # the grad clip first, then the regularization (weight decay
            # added onto the grads), as the reference's clip.py and
            # regularizer.py append them
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            params_grads = self._append_regularization_ops(params_grads)
            lr = self._create_lr_var(program)
            if (self._fused_op_type is not None
                    and (self._fuse or get_flag("FLAGS_fuse_optimizer"))):
                return self._apply_fused_gradients(program, params_grads, lr)
            ops = []
            for p, g in params_grads:
                if g is None:
                    continue
                ops.append(self._append_optimize_op(
                    program.global_block(), (p, g), lr))
        return ops

    # -- fused flat-buffer sweep -------------------------------------------
    def _fused_hparam_key(self, param: Parameter) -> Tuple:
        """Params sharing a key share one fused update op and one flat
        accumulator layout: the same storage dtype and the same
        ParamAttr.learning_rate multiplier (AdamW adds its decay bit)."""
        mult = (getattr(param, "optimize_attr", None) or {}) \
            .get("learning_rate", 1.0)
        return (str(param.dtype), float(mult))

    def _apply_fused_gradients(self, program, params_grads, lr_var):
        """One fused update op per group instead of one op per parameter;
        the group's moments are persistable [numel] buffers."""
        block = program.global_block()
        groups: Dict[Tuple, List[Tuple[Parameter, Variable]]] = {}
        for p, g in params_grads:
            if g is None:
                continue
            groups.setdefault(self._fused_hparam_key(p), []).append((p, g))
        return [self._append_fused_optimize_op(block, groups[key], lr_var, key)
                for key in sorted(groups, key=repr)]

    def _add_group_accumulator(self, name: str, key, numel: int,
                               fill_value=0.0, shape=None,
                               dtype="float32") -> Variable:
        """Flat accumulator for one fused group (names are deterministic
        given build order)."""
        tag = f"{name}@{key!r}"
        if name in self._accumulators and tag in self._accumulators[name]:
            return self._accumulators[name][tag]
        acc_name = unique_name.generate(f"fused_{self.type}_{name}")
        shape = list(shape if shape is not None else [numel])
        main_block = default_main_program().global_block()
        var = main_block.create_var(
            name=acc_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True,
        )
        startup_block = default_startup_program().global_block()
        sv = startup_block.create_var(
            name=acc_name, shape=shape, dtype=dtype, persistable=True
        )
        ConstantInitializer(fill_value)(sv, startup_block)
        self._accumulators.setdefault(name, {})[tag] = var
        return var

    def _append_regularization_ops(self, params_grads):
        from .regularizer import append_regularization_ops

        return append_regularization_ops(params_grads, self.regularization)

    def _append_fused_optimize_op(self, block, pgs, lr_var, key):
        raise NotImplementedError

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        raise NotImplementedError

    def _param_lr(self, param: Parameter, lr_var):
        """Per-param learning-rate multiplier (ParamAttr.learning_rate)."""
        opt_attr = getattr(param, "optimize_attr", None)
        mult = (opt_attr or {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return lr_var
        from .layers.tensor import scale as scale_layer

        return scale_layer(lr_var, scale=float(mult))


class SGDOptimizer(Optimizer):
    _fused_op_type = "fused_sgd"

    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None, parameter_list=None, fuse=False):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "sgd"
        self._fuse = bool(fuse)

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p]},
        )

    def _append_fused_optimize_op(self, block, pgs, lr_var, key):
        params = [p for p, _ in pgs]
        return block.append_op(
            type="fused_sgd",
            inputs={"Param": params, "Grad": [g for _, g in pgs],
                    "LearningRate": [lr_var]},
            outputs={"ParamOut": params},
            attrs={"lr_mult": key[1]},
        )


class MomentumOptimizer(Optimizer):
    _fused_op_type = "fused_momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, grad_clip=None, name=None,
                 parameter_list=None, fuse=False):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._fuse = bool(fuse)

    def _append_fused_optimize_op(self, block, pgs, lr_var, key):
        params = [p for p, _ in pgs]
        numel = sum(int(np.prod(p.shape)) for p in params)
        velocity = self._add_group_accumulator("velocity", key, numel)
        return block.append_op(
            type="fused_momentum",
            inputs={"Param": params, "Grad": [g for _, g in pgs],
                    "Velocity": [velocity], "LearningRate": [lr_var]},
            outputs={"ParamOut": params, "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "lr_mult": key[1]},
        )

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        velocity = self._add_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [velocity],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdamOptimizer(Optimizer):
    _fused_op_type = "fused_adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, grad_clip=None, name=None,
                 lazy_mode=False, parameter_list=None, fuse=False):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._fuse = bool(fuse)

    def _append_fused_optimize_op(self, block, pgs, lr_var, key):
        params = [p for p, _ in pgs]
        numel = sum(int(np.prod(p.shape)) for p in params)
        m1 = self._add_group_accumulator("moment1", key, numel)
        m2 = self._add_group_accumulator("moment2", key, numel)
        b1p = self._add_group_accumulator("beta1_pow", key, 1, fill_value=1.0)
        b2p = self._add_group_accumulator("beta2_pow", key, 1, fill_value=1.0)
        attrs = dict(self._op_attrs())
        attrs["lr_mult"] = key[1]
        if len(key) > 2 and not key[2]:    # AdamW group excluded from decay
            attrs.pop("coeff", None)
        return block.append_op(
            type="fused_adamw" if "coeff" in attrs else "fused_adam",
            inputs={"Param": params, "Grad": [g for _, g in pgs],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [lr_var]},
            outputs={"ParamOut": params, "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs=attrs,
        )

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, fill_value=1.0, shape=[1])
        b2p = self._add_accumulator("beta2_pow_acc", p, fill_value=1.0, shape=[1])
        return block.append_op(
            type=self.type,
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs=self._op_attrs(),
        )

    def _op_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon}


class AdamW(AdamOptimizer):
    """Adam with decoupled weight decay; ``apply_decay_param_fun(name)``
    False keeps a parameter out of the decay."""

    _fused_op_type = "fused_adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, regularization=None,
                 grad_clip=None, name=None, apply_decay_param_fun=None,
                 parameter_list=None, fuse=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, regularization,
                         grad_clip, name, parameter_list=parameter_list,
                         fuse=fuse)
        self.type = "adamw"
        self._coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _fused_hparam_key(self, param):
        with_decay = (self._apply_decay_param_fun is None
                      or bool(self._apply_decay_param_fun(param.name)))
        return super()._fused_hparam_key(param) + (with_decay,)

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(p.name)):
            saved, self.type = self.type, "adam"
            try:
                return super()._append_optimize_op(block, param_and_grad, lr_var)
            finally:
                self.type = saved
        return super()._append_optimize_op(block, param_and_grad, lr_var)

    def _op_attrs(self):
        attrs = super()._op_attrs()
        if self.type == "adamw":
            attrs["coeff"] = self._coeff
        return attrs


def _get_or_create_global_step() -> Variable:
    """The persistable int64 step counter ``@LR_DECAY_COUNTER@`` (started
    at 0 by the startup program) and its ``increment`` op, prepended to
    block 0 so each run advances it once before anything reads it."""
    main = default_main_program()
    block = main.global_block()
    name = "@LR_DECAY_COUNTER@"
    if block.has_var(name):
        return block.var(name)
    var = block.create_var(name=name, shape=[1], dtype="int64", persistable=True,
                           stop_gradient=True)
    startup = default_startup_program().global_block()
    sv = startup.create_var(name=name, shape=[1], dtype="int64", persistable=True)
    ConstantInitializer(0.0)(sv, startup)
    block._prepend_op(
        type="increment", inputs={"X": [var]}, outputs={"Out": [var]},
        attrs={"step": 1.0},
    )
    return var


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    not_ported("optimizer", name)
