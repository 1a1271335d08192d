"""Static-graph Program IR — the port of ``paddle_tpu/framework/program.py``.

Pure Python, as in the reference (``Variable``, ``Parameter``,
``Operator``, ``Block``, ``Program`` and the default-program stack of
the reference's python/paddle/fluid/framework.py). The one difference is
what runs it: ``executor.py`` runs a block op by op on a torch device
instead of compiling it whole. ``_desc_dict`` gives the same desc as the
reference's, so a test can hold the two packages' programs equal.
"""
from __future__ import annotations

import contextlib
import copy
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from . import unique_name
from .core import VarType, convert_dtype, not_ported

GRAD_SUFFIX = "@GRAD"


class Variable:
    """A named tensor slot in a Block. ``shape`` may hold -1 (unknown,
    the batch dim); real shapes come from the feeds at run time."""

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape=None,
        dtype="float32",
        type: VarType = VarType.LOD_TENSOR,
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        need_check_feed: bool = False,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else ()
        self.dtype = convert_dtype(dtype)
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.need_check_feed = need_check_feed

    @property
    def grad_name(self) -> str:
        return self.name + GRAD_SUFFIX

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def astype(self, dtype):
        from ..layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)

    def _desc_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "type": int(self.type),
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
        }

    def __repr__(self):
        return (
            f"Var({self.name}: shape={list(self.shape)}, dtype={self.dtype}, "
            f"{'persistable, ' if self.persistable else ''}"
            f"stop_gradient={self.stop_gradient})"
        )

    # operator sugar: `a - b` builds elementwise_sub (layers/math_op_patch)
    def _binary(self, other, fn_name, reverse=False):
        from ..layers import math_op_patch

        return math_op_patch.binary_op(self, other, fn_name, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __radd__(self, other):
        return self._binary(other, "elementwise_add", reverse=True)

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __rmul__(self, other):
        return self._binary(other, "elementwise_mul", reverse=True)

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __neg__(self):
        from ..layers import tensor as tensor_layers

        return tensor_layers.scale(self, scale=-1.0)

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.is_distributed = kwargs.pop("is_distributed", False)
        kwargs["persistable"] = True
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.stop_gradient = not self.trainable

    def __repr__(self):
        return f"Param({self.name}: shape={list(self.shape)}, dtype={self.dtype})"


class Operator:
    """One op node: inputs/outputs map slot -> list of var names; attrs are
    plain Python values."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = _normalize_io(inputs)
        self.outputs: Dict[str, List[str]] = _normalize_io(outputs)
        self.attrs: Dict[str, Any] = dict(attrs or {})
        role = getattr(getattr(block, "program", None),
                       "_current_op_role", 0)
        if role and "op_role" not in self.attrs:
            self.attrs["op_role"] = role

    def input(self, slot) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self) -> List[str]:
        return [n for names in self.inputs.values() for n in names]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for names in self.outputs.values() for n in names]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def _set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def has_attr(self, name) -> bool:
        return name in self.attrs

    def _desc_dict(self):
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": copy.deepcopy(self.attrs),
        }

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{{self.type}: ({ins}) -> ({outs})}}"


def _normalize_io(io: Optional[Dict[str, Any]]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = OrderedDict()
    if not io:
        return out
    for slot, vals in io.items():
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        names = []
        for v in vals:
            if isinstance(v, Variable):
                names.append(v.name)
            elif isinstance(v, str):
                names.append(v)
            else:
                raise TypeError(f"bad i/o entry for slot {slot}: {v!r}")
        out[slot] = names
    return out


class Block:
    """A straight-line list of ops and a var table."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1
        self.vars: "OrderedDict[str, Variable]" = OrderedDict()
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype", "float32")
        global_block = self.program.global_block()
        param = Parameter(global_block, shape=shape, dtype=dtype, **kwargs)
        global_block.vars[param.name] = param
        return param

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"Variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def _var_recursive(self, name: str) -> Variable:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise ValueError(f"Variable {name!r} not found in block hierarchy")

    def _has_var_recursive(self, name: str) -> bool:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return True
            blk = blk.parent_block
        return False

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        self.program._bump_version()
        self._infer_shape(op)
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        """Insert an op at ``index`` (the AMP rewrite's casts, the LR
        counter's increment); shapes inferred as ``append_op`` does."""
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        self._infer_shape(op)
        return op

    def _prepend_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        return self._insert_op(0, type, inputs=inputs, outputs=outputs, attrs=attrs)

    def _remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def _infer_shape(self, op: Operator):
        from .registry import infer_shape_for_op

        infer_shape_for_op(self, op)

    def _desc_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v._desc_dict() for v in self.vars.values()],
            "params": [v.name for v in self.vars.values() if isinstance(v, Parameter)],
            "ops": [op._desc_dict() for op in self.ops],
        }

    def __repr__(self):
        lines = [f"Block {self.idx} (parent {self.parent_idx}):"]
        lines += [f"  {op}" for op in self.ops]
        return "\n".join(lines)


class Program:
    """A whole program: a tree of Blocks."""

    # OpRole values (the reference's op_proto_maker.h)
    OP_ROLE_FORWARD = 0
    OP_ROLE_BACKWARD = 1
    OP_ROLE_OPTIMIZE = 2
    OP_ROLE_RPC = 4
    OP_ROLE_DIST = 8
    OP_ROLE_LRSCHED = 16
    OP_ROLE_LOSS = 0x100
    OP_ROLE_NOT_SPECIFIED = 0x1000

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._is_start_up_program = False
        self._current_op_role = Program.OP_ROLE_FORWARD
        self._mutation_counter = 0
        # program-level annotations the executor reads (``grad_merge``)
        # and introspection metadata (``recompute_checkpoints``)
        self._annotations: Dict[str, Any] = {}

    @contextlib.contextmanager
    def op_role_guard(self, role: int):
        """Ops appended inside the guard carry attrs['op_role'] = role."""
        prev = self._current_op_role
        self._current_op_role = role
        try:
            yield
        finally:
            self._current_op_role = prev

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def all_parameters(self) -> List:
        return self.global_block().all_parameters()

    def clone(self, for_test: bool = False) -> "Program":
        not_ported("Program", "clone")

    def _bump_version(self):
        self._mutation_counter += 1

    def _version_token(self):
        """Mutation token: the executor re-plans a program that changed."""
        return (self._mutation_counter,
                tuple((len(b.ops), len(b.vars)) for b in self.blocks))

    def _desc_dict(self):
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b._desc_dict() for b in self.blocks],
        }

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


# ---------------------------------------------------------------------------
# Default program stack
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()
_startup_program_._is_start_up_program = True


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


_name_scope_stack: List[str] = []


@contextlib.contextmanager
def name_scope(prefix: str):
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()
