"""paddle.nn.functional (counterpart of paddle_tpu/nn/functional.py), in
sections as the reference's file runs: activation.py, common.py (linear,
embedding, dropout, resampling, the rest), conv.py, pooling.py, norm.py
and loss.py. Each op is written on torch tensors and casts its inputs as
the active auto_cast does for the reference op of the same name. Called
with a ``Tensor`` among its arguments an op runs on the plain tensors and
returns ``Tensor``s, 64-bit integer results in their 32-bit forms (the
reference's dtypes); called with torch tensors, as the port's layers call
it, it is the plain function."""
import functools as _functools

from ...core.dispatch import _canon
from ...core.tensor import has_tensor as _has_tensor
from ...core.tensor import plain_all as _plain_all
from ...core.tensor import wrap as _wrap
from . import activation as _activation
from . import common as _common
from . import conv as _conv
from . import loss as _loss
from . import norm as _norm
from . import pooling as _pooling


def _wrap_out(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap_out(o) for o in out)
    return _wrap(_canon(out))


def _api(fn):
    @_functools.wraps(fn)
    def run(*args, **kwargs):
        if _has_tensor(args, kwargs):
            return _wrap_out(fn(*_plain_all(args), **_plain_all(kwargs)))
        return fn(*args, **kwargs)

    return run


for _mod in (_activation, _common, _conv, _pooling, _norm, _loss):
    for _name in dir(_mod):
        _fn = getattr(_mod, _name)
        if (not _name.startswith("_") and callable(_fn) and not isinstance(_fn, type)
                and getattr(_fn, "__module__", "") == _mod.__name__):
            globals()[_name] = _api(_fn)
del _mod, _name, _fn
