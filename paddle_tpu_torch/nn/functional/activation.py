"""Activations, softmax and their in-place forms (paddle_tpu/nn/
functional.py:22-157 and :1366-1389). Each casts its inputs as the active
auto_cast does for the reference op of the same name."""
import math

import torch

from ...amp.auto_cast import cast_inputs
from ...core import random as random_core


def _unary(op_name, fn):
    def api(x, name=None):
        (x,) = cast_inputs(op_name, x)
        return fn(x)

    api.__name__ = op_name
    return api


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
silu = _unary("silu", lambda x: x * torch.sigmoid(x))
swish = silu
tanhshrink = _unary("tanhshrink", lambda x: x - torch.tanh(x))
softsign = _unary("softsign", lambda x: x / (torch.abs(x) + 1))
log_sigmoid = _unary("log_sigmoid", lambda x: -_softplus(-x))


def mish(x, threshold=20.0, name=None):
    """x * tanh(softplus(x)), the softplus the identity above
    ``threshold``."""
    (x,) = cast_inputs("mish", x)
    sp = torch.where(x > threshold, x, _softplus(x))
    return x * torch.tanh(sp)


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU, or jax's tanh approximation."""
    (x,) = cast_inputs("gelu", x)
    if approximate:
        c = math.sqrt(2.0 / math.pi)
        return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("celu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def hardshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("hardshrink", x)
    return torch.where(torch.abs(x) > threshold, x, 0.0)


def softshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    (x,) = cast_inputs("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    (x,) = cast_inputs("hardswish", x)
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = cast_inputs("hardtanh", x)
    return torch.clamp(x, float(min), float(max))


def prelu(x, weight, data_format="NCHW", name=None):
    """A slope per channel (axis 1, or the last under channels-last), or
    one slope."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format.startswith("NC") else x.dim() - 1] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def softplus(x, beta=1, threshold=20, name=None):
    (x,) = cast_inputs("softplus", x)
    return torch.where(beta * x > threshold, x, torch.log1p(torch.exp(beta * x)) / beta)


def maxout(x, groups, axis=1, name=None):
    (x,) = cast_inputs("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + tuple(x.shape[ax + 1:])
    return torch.amax(x.reshape(shape), dim=ax + 1)


def thresholded_relu(x, threshold=1.0, name=None):
    (x,) = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, 0.0).to(x.dtype)


def glu(x, axis=-1, name=None):
    (x,) = cast_inputs("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def softmax(x, axis=-1, dtype=None, name=None):
    """``dtype`` is accepted and unused, as in the reference."""
    (x,) = cast_inputs("softmax", x)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast_inputs("log_softmax", x)
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g jax.random.gumbel's draw under
    one key of the key stream; ``hard``: the one-hot of its argmax forward,
    the soft gradient back (straight-through)."""
    key = random_core.next_key()
    (x,) = cast_inputs("gumbel_softmax", x)
    g = random_core.gumbel(key, tuple(x.shape), x.device).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        oh = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        return oh + y - y.detach()
    return y


def _inplace_unary(fn):
    def inner(x, *args, **kwargs):
        from ...tensor.math import _inplace

        return _inplace(x, fn(x, *args, **kwargs))

    inner.__name__ = fn.__name__ + "_"
    inner.__doc__ = f"In-place variant of F.{fn.__name__}."
    return inner


relu_ = _inplace_unary(relu)
elu_ = _inplace_unary(elu)
tanh_ = _inplace_unary(tanh)
softmax_ = _inplace_unary(softmax)
