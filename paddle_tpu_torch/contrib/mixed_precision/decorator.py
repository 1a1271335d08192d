"""OptimizerWithMixedPrecision — the port of
``paddle_tpu/contrib/mixed_precision/decorator.py`` (the reference's
contrib/mixed_precision/decorator.py:27, decorate at :218).

Wraps an optimizer: rewrites the forward program to low precision (bf16
by default), scales the loss, unscales and checks the grads with
``check_finite_and_unscale``, runs the ``update_loss_scaling`` state
machine (which zeroes the grads on overflow, so the wrapped optimizer's
step moves nothing), then applies the wrapped optimizer, fused or per
parameter. With bf16 the loss scale stays at 1.0 (bf16 has float32's
exponent range); dynamic scaling is the fp16 default.
"""
from __future__ import annotations

from typing import Optional

from ...framework.initializer import ConstantInitializer
from ...framework.program import default_main_program, default_startup_program
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists: Optional[AutoMixedPrecisionLists],
                 init_loss_scaling: float, use_dynamic_loss_scaling: bool,
                 incr_every_n_steps: int, decr_every_n_nan_or_inf: int,
                 incr_ratio: float, decr_ratio: float, dest_dtype: str):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def _create_scaling_vars(self, block, startup):
        def persist(name, dtype, value):
            v = block.create_var(name=name, shape=[1], dtype=dtype,
                                 persistable=True, stop_gradient=True)
            sv = startup.create_var(name=name, shape=[1], dtype=dtype,
                                    persistable=True)
            ConstantInitializer(value)(sv, startup)
            return v

        self._loss_scaling = persist("loss_scaling_0", "float32",
                                     self._init_loss_scaling)
        if self._use_dynamic_loss_scaling:
            self._good_steps = persist("good_steps_0", "int32", 0)
            self._bad_steps = persist("bad_steps_0", "int32", 0)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        main = loss.block.program
        startup = startup_program or default_startup_program()
        rewrite_program(main, self._amp_lists, self._dest_dtype)
        self._create_scaling_vars(main.global_block(),
                                  startup.global_block())
        # scaled_loss = loss * loss_scaling (loss is fp32: loss ops are black)
        block = main.global_block()
        scaled = block.create_var(name=loss.name + ".scaled",
                                  shape=loss.shape, dtype=loss.dtype)
        block.append_op(
            type="elementwise_mul",
            inputs={"X": [loss.name], "Y": [self._loss_scaling.name]},
            outputs={"Out": [scaled.name]}, attrs={"axis": -1})
        params_grads = self._optimizer.backward(
            scaled, startup_program, parameter_list, no_grad_set, callbacks)
        return params_grads

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        grads = [g for _, g in params_grads if g is not None]
        # cast any low-precision grads up to fp32 before the update (master
        # weights are fp32; reference fp16_utils update path does the same)
        for g in grads:
            if str(g.dtype) == self._dest_dtype:
                g.dtype = "float32"  # grads of casted params arrive via cast-grad, already f32; belt & braces
        # persistable: each step's overflow verdict lands in the scope (the
        # reference's train_from_dataset monitor reads it from there)
        found_inf = block.create_var(name="find_infinite_scale_0",
                                     shape=[1], dtype="bool",
                                     persistable=True)
        grad_names = [g.name for g in grads]
        block.append_op(
            type="check_finite_and_unscale",
            inputs={"X": grad_names, "Scale": [self._loss_scaling.name]},
            outputs={"Out": grad_names, "FoundInfinite": [found_inf.name]})
        if self._use_dynamic_loss_scaling:
            block.append_op(
                type="update_loss_scaling",
                inputs={"X": grad_names,
                        "FoundInfinite": [found_inf.name],
                        "PrevLossScaling": [self._loss_scaling.name],
                        "InGoodSteps": [self._good_steps.name],
                        "InBadSteps": [self._bad_steps.name]},
                outputs={"Out": grad_names,
                         "LossScaling": [self._loss_scaling.name],
                         "OutGoodSteps": [self._good_steps.name],
                         "OutBadSteps": [self._bad_steps.name]},
                attrs={"incr_every_n_steps": self._incr_every_n_steps,
                       "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio})
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        ops = self.apply_gradients(params_grads)
        return ops, params_grads

    def __getattr__(self, item):  # delegate the rest to the wrapped optimizer
        return getattr(self._optimizer, item)


_UNSET = object()


def decorate(optimizer, amp_lists=None, init_loss_scaling=_UNSET,
             incr_every_n_steps: int = 1000, decr_every_n_nan_or_inf: int = 2,
             incr_ratio: float = 2.0, decr_ratio: float = 0.8,
             use_dynamic_loss_scaling=_UNSET,
             use_bf16: bool = True):
    """contrib.mixed_precision.decorate (decorator.py:218).

    The default is bf16 with the loss scale pinned at 1.0 (bf16 shares
    float32's exponent range, so nothing overflows); ``use_bf16=False``
    gives the reference's fp16 with dynamic loss scaling from 2^15. A
    ``RecomputeOptimizer`` and ``PipelineOptimizer`` are refused by name
    (the reference fails on both).  Explicitly passed
    ``init_loss_scaling`` / ``use_dynamic_loss_scaling`` are honored even
    under bf16 (reference code ported verbatim keeps its configuration).
    """
    from ...optimizer import (PipelineOptimizer, RecomputeOptimizer,
                              _refuse_amp_pipeline, _refuse_amp_recompute)

    if isinstance(optimizer, RecomputeOptimizer):
        _refuse_amp_recompute()
    if isinstance(optimizer, PipelineOptimizer):
        _refuse_amp_pipeline()
    dest = "bfloat16" if use_bf16 else "float16"
    if init_loss_scaling is _UNSET:
        init_loss_scaling = 1.0 if use_bf16 else 2. ** 15
    if use_dynamic_loss_scaling is _UNSET:
        use_dynamic_loss_scaling = not use_bf16
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, float(init_loss_scaling),
        bool(use_dynamic_loss_scaling),
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest)
