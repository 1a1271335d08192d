"""Optimizer classes — the port of ``paddle_tpu/optimizer.py``: ``SGD``,
``Momentum``, ``LarsMomentum``, ``Adagrad``, ``DecayedAdagrad``,
``Adadelta``, ``Adam``, ``AdamW``, ``Adamax``, ``Dpsgd``, ``RMSProp``,
``Ftrl``, ``Lamb`` and ``DGCMomentumOptimizer``; the averaging wrappers
``ExponentialMovingAverage``, ``ModelAverage`` and
``LookaheadOptimizer``; the program rewriters ``RecomputeOptimizer``
(``append_backward(checkpoints=)``), ``GradientMergeOptimizer``
(``parallel/grad_merge.py``) and ``PipelineOptimizer``
(``parallel/pipeline_program.py``).

``minimize`` = ``append_backward`` + the gradient clip (``grad_clip=``,
``clip.py``) + the regularizers (``regularization=`` and each
parameter's own, ``regularizer.py``) + one update op per parameter (then each optimizer's ``_finish_update``,
Adamax's ``beta1_pow_acc`` scale), or,
with ``fuse=True`` (or ``FLAGS_fuse_optimizer``), one fused flat-buffer
update op per (dtype, lr-multiplier) group whose moments are flat [numel]
accumulators; each fused op runs its group through the optimizer kernel
(``ops/optimizer_ops.py``). A ``learning_rate`` Variable (an LR schedule,
``layers/learning_rate_scheduler.py``) feeds the update ops as it is.
Dygraph mode (``parameter_list``) is still to be ported (ROADMAP A5). AMP
composed with Recompute or with the pipeline, and an LR schedule under
the pipeline, the reference cannot run either: ``decorate`` refuses
``RecomputeOptimizer`` and ``PipelineOptimizer`` by name, and each of
them refuses it (and ``PipelineOptimizer`` a ``learning_rate``
Variable).
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

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "LarsMomentum", "LarsMomentumOptimizer", "Adagrad", "AdagradOptimizer",
    "DecayedAdagrad", "DecayedAdagradOptimizer", "Adadelta",
    "AdadeltaOptimizer", "Adam", "AdamOptimizer", "AdamW", "Adamax",
    "AdamaxOptimizer", "Dpsgd", "DpsgdOptimizer", "RMSProp",
    "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb", "LambOptimizer",
    "DGCMomentumOptimizer", "ExponentialMovingAverage", "ModelAverage",
    "RecomputeOptimizer", "LookaheadOptimizer", "PipelineOptimizer",
    "GradientMergeOptimizer",
]


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
        self._name = name
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
            self._finish_update(program.global_block(), params_grads)
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
        ops = [self._append_fused_optimize_op(block, groups[key], lr_var, key)
               for key in sorted(groups, key=repr)]
        self._finish_update(block, params_grads)
        return ops

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

    def _finish_update(self, block, params_grads):
        """Ops after every parameter's update (Adamax's bias power)."""

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


class DGCMomentumOptimizer(Optimizer):
    """Momentum with Deep Gradient Compression (the ``dgc_momentum`` op):
    plain momentum before ``rampup_begin_step`` (by the step counter),
    top-k sparsified accumulation from it on. The sparsity schedule's
    last value is the steady state, as in the reference."""

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 num_trainers=None, regularization=None, grad_clip=None,
                 name=None, parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "dgc_momentum"
        self._momentum = momentum
        self._rampup_begin_step = float(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        self._sparsity = list(sparsity)
        self._use_nesterov = use_nesterov

    def _cur_sparsity(self):
        return float(self._sparsity[-1])

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        u = self._add_accumulator("dgc_u", p)
        v = self._add_accumulator("dgc_v", p)
        step = _get_or_create_global_step()
        return block.append_op(
            type="dgc_momentum",
            inputs={"Param": [p], "Grad": [g], "U": [u], "V": [v],
                    "CurrentStep": [step],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p], "UOut": [u], "VOut": [v]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov,
                   "sparsity": self._cur_sparsity(),
                   "rampup_begin_step": self._rampup_begin_step,
                   "ring_id": 0},
        )


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, grad_clip=None,
                 name=None, epsilon=0.0, parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        velocity = self._add_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [velocity],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   "epsilon": self._epsilon},
        )


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 grad_clip=None, name=None, initial_accumulator_value=0.0,
                 parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "adagrad"
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        moment = self._add_accumulator("moment", p, fill_value=self._initial)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [moment],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon},
        )


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, grad_clip=None, name=None,
                 parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        moment = self._add_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [moment],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, grad_clip=None, name=None,
                 parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        g_acc = self._add_accumulator("_avg_squared_grad", p)
        u_acc = self._add_accumulator("_avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [g_acc],
                    "AvgSquaredUpdate": [u_acc]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [g_acc],
                     "AvgSquaredUpdateOut": [u_acc]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, grad_clip=None, name=None,
                 parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        moment = self._add_accumulator("moment", p)
        inf_norm = self._add_accumulator("inf_norm", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                    shape=[1])
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g], "Moment": [moment],
                    "InfNorm": [inf_norm], "Beta1Pow": [b1p],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def _finish_update(self, block, params_grads):
        """``beta1_pow_acc *= beta1`` after the updates (a ``scale`` op a
        parameter)."""
        for p, g in params_grads:
            if g is None:
                continue
            b1p = self._accumulators["beta1_pow_acc"][p.name]
            block.append_op(type="scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1})


class DpsgdOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, regularization=None, grad_clip=None, name=None,
                 parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "dpsgd"
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma},
        )


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, grad_clip=None,
                 name=None, parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        ms = self._add_accumulator("mean_square", p)
        mom = self._add_accumulator("momentum", p)
        inputs = {"Param": [p], "Grad": [g], "MeanSquare": [ms],
                  "Moment": [mom],
                  "LearningRate": [self._param_lr(p, lr_var)]}
        outputs = {"ParamOut": [p], "MeanSquareOut": [ms], "MomentOut": [mom]}
        if self._centered:
            mg = self._add_accumulator("mean_grad", p)
            inputs["MeanGrad"] = [mg]
            outputs["MeanGradOut"] = [mg]
        return block.append_op(
            type="rmsprop", inputs=inputs, outputs=outputs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered},
        )


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, grad_clip=None, name=None,
                 parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, g = param_and_grad
        sq = self._add_accumulator("squared", p)
        lin = self._add_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._param_lr(p, lr_var)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class LambOptimizer(AdamOptimizer):
    """LAMB (You et al., 2019): Adam's accumulators and a layer-wise
    trust ratio; ``exclude_from_weight_decay_fn(param)`` True gives that
    parameter weight decay 0."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None, name=None,
                 parameter_list=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, regularization,
                         grad_clip, name, parameter_list=parameter_list)
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _op_attrs(self):
        attrs = super()._op_attrs()
        attrs["weight_decay"] = self._weight_decay
        return attrs

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        p, _g = param_and_grad
        if self._exclude_fn is not None and self._exclude_fn(p):
            saved, self._weight_decay = self._weight_decay, 0.0
            try:
                return super()._append_optimize_op(block, param_and_grad,
                                                   lr_var)
            finally:
                self._weight_decay = saved
        return super()._append_optimize_op(block, param_and_grad, lr_var)


class ExponentialMovingAverage:
    """Shadow copies ``<name><param>.ema`` of the trainable parameters,
    updated by an ``ema_update`` op each run (``update()`` appends them);
    ``apply(executor)`` swaps them into the global scope for evaluation
    and ``restore()`` (or leaving the returned guard) swaps back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._ema_vars: Dict[str, Variable] = {}
        self._params: List[Parameter] = []

    def update(self):
        block = default_main_program().global_block()
        startup = default_startup_program().global_block()
        for p in block.all_parameters():
            if not p.trainable:
                continue
            ema_name = self._name + p.name + ".ema"
            ema = block.create_var(name=ema_name, shape=p.shape, dtype=p.dtype,
                                   persistable=True, stop_gradient=True)
            sv = startup.create_var(name=ema_name, shape=p.shape,
                                    dtype=p.dtype, persistable=True)
            ConstantInitializer(0.0)(sv, startup)
            self._ema_vars[p.name] = ema
            self._params.append(p)
            block.append_op(
                type="ema_update",
                inputs={"Param": [p], "Ema": [ema]},
                outputs={"EmaOut": [ema]},
                attrs={"decay": self._decay},
            )

    def apply(self, executor, need_restore=True):
        from .framework.executor import global_scope

        scope = global_scope()
        self._backup = {}
        for p in self._params:
            self._backup[p.name] = scope.find_var(p.name)
            ema = scope.find_var(self._ema_vars[p.name].name)
            if ema is not None:
                scope.set_var(p.name, ema)
        return _EMAGuard(self, executor, need_restore)

    def restore(self, executor=None):
        from .framework.executor import global_scope

        scope = global_scope()
        for name, val in getattr(self, "_backup", {}).items():
            scope.set_var(name, val)


class _EMAGuard:
    def __init__(self, ema, executor, need_restore):
        self._ema, self._executor = ema, executor
        self._need_restore = need_restore

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._need_restore:
            self._ema.restore(self._executor)


class ModelAverage(Optimizer):
    """Parameter averaging over a window, as the reference gives it: an
    exponential moving average of decay ``1 - average_window_rate``."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, None, name)
        self._ema = ExponentialMovingAverage(decay=1.0 - average_window_rate)

    def update(self):
        self._ema.update()

    def apply(self, executor, need_restore=True):
        return self._ema.apply(executor, need_restore)

    def restore(self, executor=None):
        self._ema.restore(executor)


def _refuse_amp_recompute():
    raise NotImplementedError(
        "AMP with Recompute (decorate and RecomputeOptimizer, in either "
        "order) is not supported: the reference cannot run it either "
        "(ROADMAP A5, configurations the port refuses by name)")


class RecomputeOptimizer(Optimizer):
    """Wraps an optimizer; ``_set_checkpoints`` marks the recompute
    segments ``append_backward(checkpoints=)`` re-emits into the backward
    (``framework/backward.py``): activations between checkpoints are
    recomputed instead of kept."""

    def __init__(self, optimizer: Optimizer):
        from .contrib.mixed_precision.decorator import (
            OptimizerWithMixedPrecision)

        if isinstance(optimizer, OptimizerWithMixedPrecision):
            _refuse_amp_recompute()
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks,
                               checkpoints=self._checkpoints)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return (self.apply_optimize(loss, startup_program, params_grads),
                params_grads)


def _refuse_amp_pipeline():
    raise NotImplementedError(
        "AMP with PipelineOptimizer (decorate and PipelineOptimizer, in "
        "either order) is not supported: the reference cannot run it "
        "either (its first run raises KeyError: 'mean_0.tmp_0', the "
        "stage-0 loss var missing from the tail) (ROADMAP A5, "
        "configurations the port refuses by name)")


def _refuse_lr_schedule_pipeline():
    raise NotImplementedError(
        "an LR schedule (a learning_rate Variable) under PipelineOptimizer "
        "is not supported: the reference cannot run it either (its first "
        "run raises KeyError: 'LearningRate': the schedule's ops sit in "
        "stage 0, so the optimizer tail never gets the rate) (ROADMAP A5, "
        "configurations the port refuses by name)")


class PipelineOptimizer:
    """GPipe over ranks (``parallel/pipeline_program.py``): ``minimize``
    records the stage split on the program — at ``cut_list``'s vars (a
    list of lists of Variables), or ``num_stages`` even parts of the
    forward — and ``Executor.run`` runs stage s on the rank at pp index s,
    ``num_microbatches`` microbatches a step, the wrapped optimizer's
    tail once on the gradients. ``place_list``, ``concurrency_list``,
    ``queue_size``, ``sync_steps`` and ``start_cpu_core_id`` are accepted
    and change nothing, as in the reference; ``remat_policy`` recomputes
    each stage's activations in its backward. AMP and an LR schedule are
    refused by name: the reference fails on both."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=None, num_stages=None,
                 remat_policy=None):
        from .contrib.mixed_precision.decorator import (
            OptimizerWithMixedPrecision)
        from .parallel import remat as _remat

        if isinstance(optimizer, OptimizerWithMixedPrecision):
            _refuse_amp_pipeline()
        if isinstance(getattr(optimizer, "_learning_rate", None), Variable):
            _refuse_lr_schedule_pipeline()
        self._optimizer = optimizer
        self._cut_list = cut_list
        if num_stages is None:
            num_stages = (len(cut_list) + 1) if cut_list else 2
        self._num_stages = int(num_stages)
        self._num_microbatches = int(num_microbatches
                                     or max(1, self._num_stages))
        self._remat_policy = _remat.resolve(remat_policy).name \
            if remat_policy is not None else "none"

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .parallel.pipeline_program import annotate_pipeline

        block = loss.block
        program = block.program
        n_fwd = len(block.ops)
        params_grads = self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set)
        bwd_end = len(block.ops)
        opt_ops = self._optimizer.apply_optimize(
            loss, startup_program, params_grads)
        annotate_pipeline(
            program, loss, n_fwd=n_fwd, bwd_end=bwd_end,
            num_stages=self._num_stages,
            num_microbatches=self._num_microbatches,
            cut_list=self._cut_list,
            trainable_params=[p.name for p, g in params_grads
                              if g is not None],
            remat_policy=self._remat_policy,
            grad_names={p.name: g.name for p, g in params_grads
                        if g is not None})
        return opt_ops, params_grads


class GradientMergeOptimizer:
    """Batch-merge: ``Executor.run`` runs the forward and backward once a
    microbatch, ``k_steps`` slices of the fed batch, and the wrapped
    optimizer once on the gradients' mean (``avg``) or sum, accumulated
    in ``acc_dtype`` (``parallel/grad_merge.py``). With a mean loss that
    is the step of the whole batch; the activations are a microbatch's."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True,
                 remat_policy=None, acc_dtype="float32"):
        from .parallel import remat as _remat

        self._optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = bool(avg)
        if acc_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(
                f"acc_dtype {acc_dtype!r}: expected float32/bfloat16/float16")
        self.acc_dtype = acc_dtype
        self._remat_policy = _remat.resolve(remat_policy).name \
            if remat_policy is not None else "none"

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .parallel.grad_merge import annotate_grad_merge

        program = loss.block.program
        params_grads = self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set)
        bwd_end = len(loss.block.ops)
        opt_ops = self._optimizer.apply_optimize(
            loss, startup_program, params_grads)
        annotate_grad_merge(
            program, loss, bwd_end, self.k_steps,
            [g.name for p, g in params_grads if g is not None],
            avg=self.avg, remat_policy=self._remat_policy,
            acc_dtype=str(self.acc_dtype))
        return opt_ops, params_grads


class LookaheadOptimizer:
    """Lookahead (Zhang et al., 2019): the inner optimizer moves the fast
    weights; every ``k`` runs (by the step counter) the slow copies
    ``<param>@SLOW``, started at the initial weights, move ``alpha`` of
    the way to them and the fast weights take their value."""

    def __init__(self, inner_optimizer: Optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        ops, params_grads = self.inner_optimizer.minimize(loss, startup_program)
        block = default_main_program().global_block()
        startup = default_startup_program().global_block()
        step = _get_or_create_global_step()
        for p, _g in params_grads:
            slow_name = p.name + "@SLOW"
            slow = block.create_var(name=slow_name, shape=p.shape,
                                    dtype=p.dtype, persistable=True,
                                    stop_gradient=True)
            startup.create_var(name=slow_name, shape=p.shape, dtype=p.dtype,
                               persistable=True)
            startup.append_op(type="assign", inputs={"X": [p.name]},
                              outputs={"Out": [slow_name]})
            block.append_op(
                type="lookahead_update",
                inputs={"Param": [p], "Slow": [slow], "Step": [step]},
                outputs={"ParamOut": [p], "SlowOut": [slow]},
                attrs={"alpha": self.alpha, "k": self.k},
            )
        return ops, params_grads


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
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Dpsgd = DpsgdOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    not_ported("optimizer", name)
