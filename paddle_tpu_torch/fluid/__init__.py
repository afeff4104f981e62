"""paddle.fluid, the 1.x-era namespace (counterpart of paddle_tpu/fluid;
reference: python/paddle/fluid/, the import path most reference-era user
code uses).

A re-export over the 2.0-style modules: ``fluid.layers`` is
``static.nn`` plus the functional and tensor ops, ``fluid.dygraph`` the
eager Layer runtime, ``fluid.io`` the static save/load. Its symbols keep
their 2.0 semantics, which the reference's fluid symbols share.
"""
import torch as _torch

from .. import nn as _nn
from .. import optimizer as _optimizer
from ..core.place import CPUPlace, CUDAPlace  # noqa: F401
from ..core.tensor import Tensor as Variable  # noqa: F401
from ..framework.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from ..static import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy, Executor,
    ParallelExecutor, Program, append_backward, data, default_main_program,
    default_startup_program, global_scope, program_guard, scope_guard,
)
from ..static.compat import (  # noqa: F401
    create_global_var, load_program_state, set_program_state,
)
from ..framework import in_dygraph_mode  # noqa: F401
from ..jit import enable_static as _enable_static  # noqa: F401

initializer = _nn.initializer
optimizer = _optimizer
from .. import regularizer  # noqa: F401,E402

from . import layers  # noqa: E402,F401
from . import dygraph  # noqa: E402,F401
from . import io  # noqa: E402,F401


class core:
    """fluid.core's place types and probes (the reference's is its pybind
    C++ module): the card's CUDA runtime here."""

    CPUPlace = CPUPlace
    CUDAPlace = CUDAPlace

    @staticmethod
    def is_compiled_with_cuda():
        return _torch.cuda.is_available()

    @staticmethod
    def get_cuda_device_count():
        return _torch.cuda.device_count()
