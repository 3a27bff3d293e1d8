from . import unique_name  # noqa: F401
from .backward import append_backward, calc_gradient, gradients  # noqa: F401
from .executor import Executor, as_numpy  # noqa: F401
from .places import CPUPlace, CUDAPlace, TPUPlace, resolve_device  # noqa: F401
from .program import (  # noqa: F401
    Block, Operator, Parameter, Program, Variable,
    default_main_program, default_startup_program, program_guard,
    switch_main_program, switch_startup_program,
)
from .scope import (  # noqa: F401
    Scope, global_scope, load_numpy_state, scope_guard,
)
