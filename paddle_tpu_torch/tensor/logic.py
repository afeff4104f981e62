"""Comparison and logical ops (counterpart of paddle_tpu/tensor/logic.py)."""
import torch

from ..core.dispatch import apply, finish
from ..core.tensor import Tensor  # noqa: F401
from .math import _pair

_base = torch.Tensor


def _binary(op_name, fn):
    def api(x, y, name=None):
        return apply(op_name, lambda x, y: fn(*_pair(x, y)), x, y)

    api.__name__ = op_name
    return api


equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
_logical_and = _binary("logical_and", torch.logical_and)
_logical_or = _binary("logical_or", torch.logical_or)
_logical_xor = _binary("logical_xor", torch.logical_xor)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)


def _with_out(result, out):
    if out is not None:
        with torch.no_grad():
            _base.set_(out.as_subclass(_base), _base.detach(result).clone())
        return out
    return result


def logical_and(x, y, out=None, name=None):
    return _with_out(_logical_and(x, y), out)


def logical_or(x, y, out=None, name=None):
    return _with_out(_logical_or(x, y), out)


def logical_xor(x, y, out=None, name=None):
    return _with_out(_logical_xor(x, y), out)


def logical_not(x, out=None, name=None):
    return _with_out(apply("logical_not", torch.logical_not, x), out)


def bitwise_not(x, name=None):
    return apply("bitwise_not", torch.bitwise_not, x)


def equal_all(x, y, name=None):
    return apply("equal_all", lambda x, y: torch.tensor(
        tuple(x.shape) == tuple(y.shape) and bool(torch.equal(x, y.to(x.dtype))),
        device=x.device), x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("allclose", lambda x, y: torch.tensor(
        bool(torch.allclose(x, y, float(rtol), float(atol), bool(equal_nan))),
        device=x.device), x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("isclose", lambda x, y: torch.isclose(x, y, float(rtol), float(atol),
                                                       bool(equal_nan)), x, y)


def is_empty(x, name=None):
    return finish("is_empty", torch.tensor(x.numel() == 0, device=x.device))


def is_tensor(x):
    return isinstance(x, torch.Tensor)

