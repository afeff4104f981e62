"""The op funnel of the ``paddle.*`` namespace (counterpart of
paddle_tpu/core/dispatch.py).

``apply(name, fn, *args, **kwargs)`` runs one Paddle op on torch tensors:
array-likes among ``args`` (numpy arrays, lists) become tensors in the
reference's canonical dtypes on the device of the op's tensors, the
floating tensors are cast as the active ``auto_cast`` casts the reference
op of the same name, ``fn`` runs, its outputs come back as ``Tensor``s,
and the ``check_nan_inf`` and ``benchmark`` flags act. Gradients are
torch autograd's: an output requires grad when a floating input does and
grad mode is on, as the reference's tape records a node only then.

``no_grad``, ``enable_grad``, ``is_grad_enabled`` and ``set_grad_enabled``
are torch's grad mode. There is no per-op jit cache: torch runs eagerly.
``def_op(name, fn)`` makes a Paddle op of a function on torch tensors.
"""
import functools

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs, target_dtype
from . import errors, flags
from .tensor import _np_to_torch, plain, wrap

_base = torch.Tensor


class no_grad(torch.no_grad):
    """paddle.no_grad — a context manager and a decorator."""


class enable_grad(torch.enable_grad):
    pass


def is_grad_enabled():
    return torch.is_grad_enabled()


class set_grad_enabled:
    """paddle.set_grad_enabled(mode): takes effect inside its ``with`` block,
    as in the reference."""

    def __init__(self, mode):
        self._mode = bool(mode)

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False


def _device_of(args):
    for a in args:
        if isinstance(a, _base):
            return a.device
        if isinstance(a, (list, tuple)):
            for v in a:
                if isinstance(v, _base):
                    return v.device
    from . import place

    return place.current_device()


def as_tensor(a, device):
    """An array-like op argument as a torch tensor (reference dtypes);
    tensors, Python scalars and None pass through."""
    if isinstance(a, _base):
        return plain(a)
    if a is None or isinstance(a, (bool, int, float, complex, str)):
        return a
    if isinstance(a, (np.ndarray, np.generic, list, tuple)):
        return _np_to_torch(np.asarray(a), None).to(device)
    return a


def _check_nan_inf(name, outs):
    for o in outs:
        if isinstance(o, _base) and (o.is_floating_point() or o.is_complex()):
            if not bool(torch.isfinite(o).all()):
                raise errors.PreconditionNotMetError(
                    f"NaN/Inf detected in output of op {name!r} (FLAGS_check_nan_inf)")


_CANON = {torch.int64: torch.int32, torch.float64: torch.float32,
          torch.complex128: torch.complex64}


def _canon(o):
    """jax computes in 32 bits here: torch's 64-bit results (an integer sum,
    an index) come back in the reference's dtype."""
    if isinstance(o, _base) and o.dtype in _CANON:
        return o.to(_CANON[o.dtype])
    return o


def finish(name, out):
    """Wrap an op's outputs in the reference's dtypes and apply the per-op
    flags."""
    if isinstance(out, (tuple, list)):
        outs = type(out)(wrap(_canon(o)) for o in out)
        seq = outs
    else:
        outs = wrap(_canon(out))
        seq = (outs,)
    if flags.flag_value("check_nan_inf"):
        _check_nan_inf(name, seq)
    if flags.flag_value("benchmark") and torch.cuda.is_available():
        torch.cuda.synchronize()
    return outs


def apply(name, fn, *args, **kwargs):
    """Run op ``name`` (see the module docstring)."""
    dev = None
    conv = []
    for a in args:
        if isinstance(a, _base):
            conv.append(plain(a))
        elif a is None or isinstance(a, (bool, int, float)):
            conv.append(a)
        else:
            if dev is None:
                dev = _device_of(args)
            conv.append(as_tensor(a, dev))
    if target_dtype(name) is not None:
        conv = cast_inputs(name, *conv)
    return finish(name, fn(*conv, **kwargs))


OP_REGISTRY = {}


def def_op(name, fn):
    """A Paddle op from a function on torch tensors (the REGISTER_OPERATOR
    analog): positional arguments are array-likes, statics are keywords."""

    @functools.wraps(fn)
    def api(*args, **kwargs):
        return apply(name, fn, *args, **kwargs)

    api.__name__ = name
    api.raw_fn = fn
    OP_REGISTRY[name] = api
    return api

