"""Math ops (counterpart of paddle_tpu/tensor/math.py), each on torch
tensors through the op funnel (core/dispatch.py): the reference's op name
for the auto_cast lists, its dtypes (integers stay 32-bit; an integer
mean or division is float32) and its reduction conventions (``axis=None``
reduces everything; a bool sum is int32)."""
import builtins
import functools

import numpy as np
import torch

from ..core import errors
from ..core.dispatch import apply
from ..core.tensor import Tensor  # noqa: F401

_base = torch.Tensor


def _axis_norm(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        a = np.asarray(axis.detach().cpu()).reshape(-1)
        return tuple(int(v) for v in a) if a.size > 1 else int(a[0])
    if isinstance(axis, (list, tuple)):
        if len(axis) == 0:
            return None
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """torch's ``dim`` for the reference's ``axis`` (None: every axis)."""
    if axis is None:
        return tuple(range(x.dim()))
    return axis


def _pair(x, y):
    """Both operands as tensors: a Python scalar becomes a 0-d tensor on the
    other's device (0-d operands take the other's dtype where the kinds
    agree, as jax's weak scalars do)."""
    if not isinstance(x, _base):
        x = torch.as_tensor(x, device=y.device)
    if not isinstance(y, _base):
        y = torch.as_tensor(y, device=x.device)
    return x, y


def _binary(op_name, fn):
    def api(x, y, name=None):
        return apply(op_name, lambda x, y: fn(*_pair(x, y)), x, y)

    api.__name__ = op_name
    return api


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
mod = _binary("mod", torch.remainder)
remainder = mod
floor_mod = mod
floor_divide = _binary("floor_divide", torch.floor_divide)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
logaddexp = _binary("logaddexp", torch.logaddexp)
inner = _binary("inner", torch.inner)
outer = _binary("outer", lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)))
kron = _binary("kron", torch.kron)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
heaviside = _binary("heaviside", torch.heaviside)
nextafter = _binary("nextafter", torch.nextafter)
copysign = _binary("copysign", torch.copysign)
atan2 = _binary("atan2", lambda x, y: torch.atan2(_f(x), _f(y)))


def _f(x):
    """Integers and bools as float32 (jax's promotion for float-valued ops)."""
    return x if x.is_floating_point() or x.is_complex() else x.to(torch.float32)


def divide(x, y, name=None):
    return apply("divide", lambda x, y: torch.true_divide(*_pair(_f(x) if isinstance(x, _base)
                                                                 else x,
                                                                 _f(y) if isinstance(y, _base)
                                                                 else y)), x, y)


def pow(x, y, name=None):
    return apply("pow", lambda x, y: torch.pow(*_pair(x, y)) if isinstance(x, _base)
                 else torch.pow(x, y), x, y)


def multiplex(inputs, index, name=None):
    def _mux(index, *xs):
        stacked = torch.stack(xs, 0)
        idx = index.reshape(-1).long()
        return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]

    return apply("multiplex", _mux, index, *inputs)


# ----------------------------------------------------------------- unary


def _unary(op_name, fn, floating=False):
    if floating:
        def api(x, name=None):
            return apply(op_name, lambda x: fn(_f(x)), x)
    else:
        def api(x, name=None):
            return apply(op_name, fn, x)

    api.__name__ = op_name
    return api


abs = _unary("abs", torch.abs)
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda x: x - torch.trunc(x))
exp = _unary("exp", torch.exp, True)
expm1 = _unary("expm1", torch.expm1, True)
log = _unary("log", torch.log, True)
log2 = _unary("log2", torch.log2, True)
log10 = _unary("log10", torch.log10, True)
log1p = _unary("log1p", torch.log1p, True)
sqrt = _unary("sqrt", torch.sqrt, True)
rsqrt = _unary("rsqrt", torch.rsqrt, True)
square = _unary("square", torch.square)
sign = _unary("sign", torch.sign)
sin = _unary("sin", torch.sin, True)
cos = _unary("cos", torch.cos, True)
tan = _unary("tan", torch.tan, True)
asin = _unary("asin", torch.asin, True)
acos = _unary("acos", torch.acos, True)
atan = _unary("atan", torch.atan, True)
sinh = _unary("sinh", torch.sinh, True)
cosh = _unary("cosh", torch.cosh, True)
tanh = _unary("tanh", torch.tanh, True)
asinh = _unary("asinh", torch.asinh, True)
acosh = _unary("acosh", torch.acosh, True)
atanh = _unary("atanh", torch.atanh, True)
erf = _unary("erf", torch.erf, True)
erfinv = _unary("erfinv", torch.erfinv, True)
reciprocal = _unary("reciprocal", lambda x: 1.0 / x)
neg = _unary("neg", torch.negative)
digamma = _unary("digamma", torch.digamma, True)
_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
            771.3234287776530788486528258894, -176.61502916214059906584551354,
            12.507343278686904814458936853, -0.13857109526572011689554707,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)


def _lgamma(x):
    """XLA's float32 lgamma (the Lanczos approximation, g = 7, with Euler's
    reflection below 0.5), which the reference computes; ``torch.lgamma``
    rounds differently."""
    x = _f(x)
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa: E731
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1)
    acc = c(0.99999999999980993227684700473478)
    for i, coeff in enumerate(_LANCZOS):
        acc = acc + c(coeff) / (z + c(float(i)) + 1)
    t = c(7.5) + z
    log_t = c(float(np.log(7.5))) + torch.log1p(z / c(7.5))
    log_y = (c(float((np.log(2) + np.log(np.pi)) / 2)) + (z + 0.5 - t / log_t) * log_t
             + torch.log(acc))
    abs_x = torch.abs(x)
    frac = abs_x - torch.floor(abs_x)
    frac = torch.where(frac > 0.5, 1 - frac, frac)
    denom = torch.log(torch.sin(c(float(np.pi)) * frac))
    reflection = torch.where(torch.isfinite(denom), c(float(np.log(np.pi))) - denom - log_y,
                             -denom)
    out = torch.where(reflect, reflection, log_y)
    return torch.where(torch.isinf(x), torch.full_like(x, float("inf")), out)


lgamma = _unary("lgamma", _lgamma)
angle = _unary("angle", torch.angle, True)
conj = _unary("conj", lambda x: torch.conj(x).resolve_conj() if x.is_complex() else x.clone())
real = _unary("real", lambda x: torch.real(x).clone())
imag = _unary("imag", lambda x: torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x))
i0 = _unary("i0", torch.i0, True)
deg2rad = _unary("deg2rad", torch.deg2rad, True)
rad2deg = _unary("rad2deg", torch.rad2deg, True)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    """reference: operators/scale_op.cc semantics."""

    def _scale(x, s, b):
        return x * s + b if bias_after_scale else (x + b) * s

    out = apply("scale", _scale, x, scale, bias)
    if act is not None:
        from ..nn import functional as F

        out = apply(act, getattr(F, act), out)
    return out


def _inplace(x, out):
    """Write ``out`` into ``x`` (the reference rebinds x to the op's result;
    torch tracks the write on a graph tensor and refuses it on a leaf that
    requires grad)."""
    if x.is_leaf and x.requires_grad and torch.is_grad_enabled():
        raise errors.InvalidArgumentError(
            "an in-place op on a leaf Tensor that requires grad (stop_gradient=False) "
            "is not supported: use the out-of-place op")
    if tuple(out.shape) != tuple(_base.shape.__get__(x)) or out.dtype != x.dtype:
        if x.requires_grad:
            raise errors.InvalidArgumentError(
                "an in-place op that changes the shape or dtype of a Tensor on the "
                "autograd graph is not supported: use the out-of-place op")
        with torch.no_grad():
            _base.set_(x, _base.detach(out).clone())
        return x
    _base.copy_(x, out)
    return x


def increment(x, value=1.0, name=None):
    return _inplace(x, apply("increment", lambda x, v: x + v, x, value))


def clip(x, min=None, max=None, name=None):
    if isinstance(min, torch.Tensor):
        min = min.item()
    if isinstance(max, torch.Tensor):
        max = max.item()
    return apply("clip", lambda x: torch.clamp(x, min, max), x)


def lerp(x, y, weight, name=None):
    return apply("lerp", lambda x, y, w: x + w * (y - x), x, y, weight)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply("stanh", lambda x: scale_b * torch.tanh(scale_a * x), x)


def rsqrt_(x):
    return _inplace(x, rsqrt(x))


# ----------------------------------------------------------------- reductions


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    from ..core.dtype import convert_dtype

    d = convert_dtype(dtype)
    ax = _axis_norm(axis)
    return apply("sum", lambda x: torch.sum(x, dim=_dims(x, ax), keepdim=bool(keepdim), dtype=d),
                 x)


def _reduction(op_name, fn, floating=False):
    def api(x, axis=None, keepdim=False, name=None):
        ax = _axis_norm(axis)
        return apply(op_name, lambda x: fn(_f(x) if floating else x, _dims(x, ax),
                                           bool(keepdim)), x)

    api.__name__ = op_name
    return api


def _each_axis(fn):
    """``fn`` (which takes one ``dim``) over each axis of ``dims`` in turn."""
    def run(x, dims, keepdim):
        for d in sorted((d % builtins.max(x.dim(), 1) for d in
                         (dims if isinstance(dims, tuple) else (dims,))), reverse=True):
            x = fn(x, dim=d, keepdim=keepdim)
        return x

    return run


mean = _reduction("mean", lambda x, d, k: torch.mean(x, dim=d, keepdim=k), floating=True)
max = _reduction("max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
min = _reduction("min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
_prod_impl = _reduction("prod", _each_axis(torch.prod))
amax = max
amin = min
all = _reduction("all", lambda x, d, k: _each_axis(torch.all)(x.to(torch.bool), d, k))
any = _reduction("any", lambda x, d, k: _each_axis(torch.any)(x.to(torch.bool), d, k))
logsumexp = _reduction("logsumexp", lambda x, d, k: torch.logsumexp(x, dim=d, keepdim=k),
                       floating=True)
nansum = _reduction("nansum", lambda x, d, k: torch.nansum(x, dim=d, keepdim=k))
nanmean = _reduction("nanmean", lambda x, d, k: torch.nanmean(x, dim=d, keepdim=k),
                     floating=True)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    """reference: tensor/math.py prod — optional accumulate dtype."""
    if dtype is not None:
        from .manipulation import cast

        x = cast(x, dtype)
    return _prod_impl(x, axis=axis, keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis_norm(axis)

    def _cnz(x):
        dims = _dims(x, ax)
        out = torch.count_nonzero(x, dim=dims)
        if keepdim:
            for d in sorted(a % builtins.max(x.dim(), 1) for a in
                            (dims if isinstance(dims, tuple) else (dims,))):
                out = out.unsqueeze(d)
        return out.to(torch.int32)

    return apply("count_nonzero", _cnz, x)


# ----------------------------------------------------------------- cumulative


def cumsum(x, axis=None, dtype=None, name=None):
    ax = _axis_norm(axis)
    return apply("cumsum", lambda x: torch.cumsum(x.reshape(-1) if ax is None else x,
                                                  0 if ax is None else ax), x)


def cumprod(x, dim=None, dtype=None, name=None):
    ax = _axis_norm(dim)
    return apply("cumprod", lambda x: torch.cumprod(x.reshape(-1) if ax is None else x,
                                                    0 if ax is None else ax), x)


def cummax(x, axis=None, name=None):
    ax = _axis_norm(axis) or 0
    return apply("cummax", lambda x: tuple(torch.cummax(x, ax)), x)


def cummin(x, axis=None, name=None):
    ax = _axis_norm(axis) or 0
    return apply("cummin", lambda x: tuple(torch.cummin(x, ax)), x)


# ----------------------------------------------------------------- products


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """reference: operators/matmul_v2_op.cc."""

    def _matmul(x, y):
        if transpose_x and x.dim() > 1:
            x = x.transpose(-1, -2)
        if transpose_y and y.dim() > 1:
            y = y.transpose(-1, -2)
        return torch.matmul(x, y)

    return apply("matmul", _matmul, x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def dot(x, y, name=None):
    return apply("dot", lambda x, y: torch.sum(x * y, dim=-1), x, y)


def bmm(x, y, name=None):
    return apply("bmm", torch.matmul, x, y)


def t(input, name=None):
    return apply("t", lambda x: x.permute(*reversed(range(x.dim()))), input)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply("addmm", lambda i, x, y: beta * i + alpha * (x @ y), input, x, y)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return apply("diff", lambda x, p, a: torch.diff(x, n, axis, p, a), x, prepend, append)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("trace", lambda x: torch.diagonal(x, offset, axis1, axis2).sum(-1), x)


def isfinite(x, name=None):
    return apply("isfinite", torch.isfinite, x)


def isinf(x, name=None):
    return apply("isinf", torch.isinf, x)


def isnan(x, name=None):
    return apply("isnan", torch.isnan, x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply("nan_to_num", lambda x: torch.nan_to_num(x, nan, posinf, neginf), x)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def add_n(inputs, name=None):
    """Elementwise sum of a tensor list (reference: tensor/math.py:716);
    always a new tensor."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if not inputs:
        raise ValueError("add_n expects at least one input tensor")
    return apply("add_n", lambda *xs: functools.reduce(torch.add, xs).clone()
                 if len(xs) == 1 else functools.reduce(torch.add, xs), *inputs)
