"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It imports torch and numpy, never jax and nothing of paddle_tpu. Usage
mirrors paddle (``import paddle_tpu_torch as paddle``): dygraph on the
card by default, ``paddle.set_device("cpu")`` for the CPU. The packages
the port has not reached yet (analysis) are absent rather than stubbed.
"""

__version__ = "0.1.0"

from .core import dispatch as _dispatch
from .core import errors  # noqa: F401
from .core import tape as _tape
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401

# dtypes
from .core.dtype import (  # noqa: F401
    bool, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128, get_default_dtype, set_default_dtype,
)

# places / device
from .core.place import (  # noqa: F401
    CPUPlace, CUDAPlace, CUDAPinnedPlace, set_device, get_device, is_compiled_with_cuda,
    is_compiled_with_xpu, is_compiled_with_tpu, device_count,
)

# flags
from .core.flags import set_flags, get_flags  # noqa: F401

# rng
from .core.random import seed  # noqa: F401

# autograd context
from .core.dispatch import (  # noqa: F401
    no_grad, enable_grad, is_grad_enabled, set_grad_enabled,
)
grad = _tape.grad

# the tensor-op namespace (paddle.add, paddle.matmul, ...)
from .tensor import *  # noqa: F401,F403,E402
from .tensor import einsum  # noqa: F401,E402
from . import tensor  # noqa: F401,E402

from . import amp  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import framework  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from . import distributed  # noqa: F401,E402
from .distributed.parallel import DataParallel  # noqa: F401,E402
from . import hapi  # noqa: F401,E402
from . import incubate  # noqa: F401,E402
from . import text  # noqa: F401,E402
from . import dataset  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import serialize  # noqa: F401,E402
from . import static  # noqa: F401,E402
from . import fluid  # noqa: F401,E402
from . import onnx  # noqa: F401,E402
from . import quantization  # noqa: F401,E402
from . import regularizer  # noqa: F401,E402
from . import obs  # noqa: F401,E402
from . import resilience  # noqa: F401,E402
from . import utils  # noqa: F401,E402
from . import distribution  # noqa: F401,E402
from . import hub  # noqa: F401,E402
from .hapi import Model, callbacks, flops, summary  # noqa: F401,E402
from .framework import ParamAttr, in_dygraph_mode, load, save  # noqa: F401,E402
from .nn.layer import Layer  # noqa: F401,E402


def get_rng_state():
    """The key stream's state (its current key) and the state of the
    initializers' generator: one Generator feeds both in the reference."""
    from .core import random as _random

    return [_random._KEY_GENERATOR.get_state(), _random._GLOBAL_GENERATOR.get_state()]


def set_rng_state(state_list):
    from .core import random as _random

    _random._KEY_GENERATOR.set_state(state_list[0])
    if len(state_list) > 1:
        _random._GLOBAL_GENERATOR.set_state(state_list[1])


def batch(reader, batch_size, drop_last=False):
    """Wrap a sample reader into a batch reader (the reference's
    paddle.batch)."""

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


# ------------------------------------------------- top-level API parity
from .core.tensor import Tensor as VarBase  # noqa: F401,E402 (legacy alias)
import torch as _torch  # noqa: E402

dtype = _torch.dtype  # paddle.dtype: the type of Tensor.dtype values


from .jit import disable_static, enable_static, in_dynamic_mode  # noqa: F401,E402


def enable_dygraph(place=None):
    """Legacy alias (reference: fluid/dygraph/base.py enable_dygraph)."""
    disable_static()


def disable_dygraph():
    enable_static()


def get_cudnn_version():
    return _torch.backends.cudnn.version() if is_compiled_with_cuda() else None


def is_compiled_with_npu():
    return False


def get_cuda_rng_state():
    """The generators' state (the reference's alias of get_rng_state)."""
    return get_rng_state()


def set_cuda_rng_state(state_list):
    set_rng_state(state_list)
