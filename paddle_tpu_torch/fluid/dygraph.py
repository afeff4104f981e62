"""fluid.dygraph (counterpart of paddle_tpu/fluid/dygraph.py; reference:
python/paddle/fluid/dygraph/)."""
import contextlib
import functools

import numpy as np

from ..core.tensor import to_tensor
from ..distributed.parallel import DataParallel  # noqa: F401
from ..jit import TracedLayer  # noqa: F401
from ..nn.layer import Layer  # noqa: F401
from ..nn.layers.common import Embedding, Linear  # noqa: F401
from ..nn.layers.container import LayerList, Sequential  # noqa: F401


@contextlib.contextmanager
def guard(place=None):
    """reference: dygraph/base.py guard — static mode is off inside the
    block."""
    from .. import jit

    was_static = not jit.in_dynamic_mode()
    jit.disable_static()
    try:
        yield
    finally:
        if was_static:
            jit.enable_static()


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """reference: dygraph/base.py to_variable."""
    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(dtype)
    t = to_tensor(arr)
    t.name = name
    return t


def no_grad(func=None):
    from ..core.dispatch import no_grad as _no_grad

    if func is None:
        return _no_grad()

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with _no_grad():
            return func(*args, **kwargs)

    return wrapper
