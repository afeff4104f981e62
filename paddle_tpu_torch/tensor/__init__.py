"""The ``paddle.tensor`` namespace (counterpart of paddle_tpu/tensor/
__init__.py): every op module, and Paddle's method and operator surface
on ``Tensor`` — indexing, ``__setitem__``, the dunders, each op as a
method, the in-place variants.

``__setitem__`` writes into the tensor, as torch does, where the
reference rebinds it to ``x.at[idx].set(v)``: on a tensor of the graph the
write is recorded, so gradients reach both the earlier value's inputs and
``v``; on a leaf that requires grad it raises (torch has no rebinding of a
leaf). In-place variants that change a shape or dtype work off the graph
only.
"""
import builtins

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.tensor import Parameter, Tensor, plain, to_tensor  # noqa: F401

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .attribute import shape, rank, is_floating_point, is_integer, is_complex  # noqa: F401
from .to_string import set_printoptions  # noqa: F401

from . import (  # noqa: F401
    attribute, creation, linalg, logic, manipulation, math, random, search, stat,
)
from .math import _inplace

_base = torch.Tensor

# --------------------------------------------------------------- indexing


def _index_part(it, device):
    if isinstance(it, torch.Tensor):
        t = plain(it)
        return t if t.dtype == torch.bool else t.long()
    if isinstance(it, builtins.slice):
        def _c(v):
            return int(v.item()) if isinstance(v, torch.Tensor) else v
        return builtins.slice(_c(it.start), _c(it.stop), _c(it.step))
    if isinstance(it, (list, np.ndarray)):
        arr = np.asarray(it)
        return torch.from_numpy(arr if arr.dtype == np.bool_ else arr.astype(np.int64)).to(device)
    if isinstance(it, (bool, np.bool_)):
        return None if it else 0
    if isinstance(it, np.integer):
        return int(it)
    return it


def _norm_index(item, device):
    if not isinstance(item, tuple):
        item = (item,)
    return tuple(_index_part(it, device) for it in item)


def _tensor_getitem(self, item):
    idx = _norm_index(item, self.device)
    return apply("getitem", lambda x: x[idx], self)


def _tensor_setitem(self, item, value):
    idx = _norm_index(item, self.device)
    if isinstance(value, torch.Tensor):
        value = plain(value).to(self.dtype)
    elif not isinstance(value, (bool, int, float)):
        value = torch.as_tensor(np.asarray(value), device=self.device).to(self.dtype)
    if self.is_leaf and self.requires_grad and torch.is_grad_enabled():
        from ..core import errors

        raise errors.InvalidArgumentError(
            "__setitem__ on a leaf Tensor that requires grad is not supported: "
            "build the value out of place")
    _base.__setitem__(self, idx, value)


# --------------------------------------------------------------- dunders

Tensor.__getitem__ = _tensor_getitem
Tensor.__setitem__ = _tensor_setitem
Tensor.__add__ = lambda s, o: math.add(s, o)
Tensor.__radd__ = lambda s, o: math.add(o, s)
Tensor.__sub__ = lambda s, o: math.subtract(s, o)
Tensor.__rsub__ = lambda s, o: math.subtract(o, s)
Tensor.__mul__ = lambda s, o: math.multiply(s, o)
Tensor.__rmul__ = lambda s, o: math.multiply(o, s)
Tensor.__truediv__ = lambda s, o: math.divide(s, o)
Tensor.__rtruediv__ = lambda s, o: math.divide(o, s)
Tensor.__floordiv__ = lambda s, o: math.floor_divide(s, o)
Tensor.__mod__ = lambda s, o: math.mod(s, o)
Tensor.__pow__ = lambda s, o: math.pow(s, o)
Tensor.__rpow__ = lambda s, o: math.pow(o, s)
Tensor.__matmul__ = lambda s, o: math.matmul(s, o)
Tensor.__neg__ = lambda s: math.scale(s, -1.0)
Tensor.__abs__ = lambda s: math.abs(s)
Tensor.__invert__ = lambda s: logic.logical_not(s)
Tensor.__eq__ = lambda s, o: logic.equal(s, o)
Tensor.__ne__ = lambda s, o: logic.not_equal(s, o)
Tensor.__lt__ = lambda s, o: logic.less_than(s, o)
Tensor.__le__ = lambda s, o: logic.less_equal(s, o)
Tensor.__gt__ = lambda s, o: logic.greater_than(s, o)
Tensor.__ge__ = lambda s, o: logic.greater_equal(s, o)
Tensor.__hash__ = lambda s: id(s)

# --------------------------------------------------------------- methods

_NO_METHOD = {
    "shape", "rank", "to_tensor", "is_tensor", "broadcast_shape", "meshgrid",
    "full", "zeros", "ones", "empty", "arange", "linspace", "eye", "full_like",
    "zeros_like", "ones_like", "empty_like", "tril_indices", "triu_indices",
    "uniform", "rand", "randn", "randint", "randperm", "normal", "gaussian",
    "standard_normal", "create_parameter", "assign", "multi_dot", "einsum",
    "scatter_nd", "broadcast_tensors",
}

_INPLACE = {
    "add": "add_", "subtract": "subtract_", "multiply": "multiply_",
    "clip": "clip_", "scale": "scale_", "ceil": "ceil_", "floor": "floor_",
    "exp": "exp_", "sqrt": "sqrt_", "reshape": "reshape_", "squeeze": "squeeze_",
    "unsqueeze": "unsqueeze_", "flatten": "flatten_", "tanh": "tanh_",
    "cast": "cast_", "round": "round_", "scatter": "scatter_",
}


def _attach_methods():
    own = set(Tensor.__dict__)
    for mod in (math, manipulation, logic, search, linalg, stat, attribute, creation):
        for name in dir(mod):
            if name.startswith("_") or name in _NO_METHOD or name in own:
                continue
            fn = getattr(mod, name)
            if not callable(fn) or isinstance(fn, type):
                continue
            if getattr(fn, "__module__", "").startswith(__name__):
                setattr(Tensor, name, fn)
    for base, iname in _INPLACE.items():
        fn = getattr(math, base, None) or getattr(manipulation, base)

        def make_inplace(f):
            def method(self, *a, **kw):
                return _inplace(self, f(self, *a, **kw))

            return method

        setattr(Tensor, iname, make_inplace(fn))
    Tensor.fill_ = lambda self, v: _inplace(self, creation.full_like(self, v))
    Tensor.zero_ = lambda self: self.fill_(0)
    Tensor.uniform_ = _uniform_
    Tensor.normal_ = _normal_


def _uniform_(self, min=-1.0, max=1.0, seed=0):
    return _inplace(self, random.uniform(tuple(self.shape), self.dtype, min, max))


def _normal_(self, mean=0.0, std=1.0):
    return _inplace(self, random.normal(mean, std, tuple(self.shape)))


_attach_methods()


def _module_inplace(iname):
    """Top-level ``paddle.reshape_(x, ...)`` (the reference exports the
    in-place variants at package level), the Tensor method's."""
    def fn(x, *args, **kwargs):
        return getattr(x, iname)(*args, **kwargs)

    fn.__name__ = iname
    fn.__doc__ = f"In-place variant of paddle.{iname[:-1]}."
    return fn


reshape_ = _module_inplace("reshape_")
scatter_ = _module_inplace("scatter_")
squeeze_ = _module_inplace("squeeze_")
unsqueeze_ = _module_inplace("unsqueeze_")
tanh_ = _module_inplace("tanh_")
