"""The fluid framework of the port: Program IR (``program``), the op
registry (``registry``), ``backward``, the ``executor``, initializers,
``unique_name``, ``param_attr``, ``compiler`` (``CompiledProgram``)
and the core types and flags (``core``) — the port of
``paddle_tpu/framework``."""
from . import core, unique_name  # noqa: F401
from .backward import append_backward  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .core import CPUPlace, CUDAPlace, get_flags, set_flags  # noqa: F401
from .executor import (Executor, Scope, global_scope,  # noqa: F401
                       scope_from_numpy, scope_guard)
from .param_attr import ParamAttr  # noqa: F401
from .program import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
)
