"""Tensor, Parameter and to_tensor (counterpart of paddle_tpu/core/tensor.py).

``Tensor`` is a ``torch.Tensor`` subclass with ``__torch_function__``
disabled: a torch op on it runs at torch's own cost and returns a plain
``torch.Tensor``. Paddle's surface is defined on it — ``shape`` as a
list, ``size`` as an int, ``stop_gradient``, ``numpy``, ``astype``, the
``paddle.*`` ops as methods and operators (attached by
``paddle_tpu_torch.tensor``), each returning a ``Tensor``. The conversion
happens only at the boundary: ``paddle.*`` functions wrap their outputs,
and a ``Layer`` that receives a ``Tensor`` hands its forward plain torch
tensors and wraps what it returns (nn/layer.py), so the port's modules
never see a ``Tensor``. Wrapping is ``as_subclass``: an alias that stays
on the autograd graph, so a gradient reaches the leaf it came from.

``Parameter`` is a ``torch.nn.Parameter`` subclass (the optimizer, the CUDA
graphs and ``convert.py`` see a torch Parameter) with Paddle's attributes
(``stop_gradient``, ``trainable``, ``name``, ``persistable``,
``optimize_attr``, ``regularizer``, ``need_clip``) and ``numpy``,
``set_value``, ``gradient``, ``clear_grad``. Its torch methods stay torch's,
because the port's modules compute with it.

Autograd is torch's: ``stop_gradient`` is ``not requires_grad`` for a
floating leaf. On a non-leaf (a view of the graph, which torch cannot
detach in place) ``stop_gradient = True`` marks the tensor, and every
``paddle.*`` op and Layer reads it detached, as the reference's tape
stops there. ``numpy()`` of a bfloat16 tensor is its exact float32 upcast
(torch cannot hand bfloat16 to numpy, and the card's machine has no
ml_dtypes).

While ``torch.export`` traces a program (``capture_scope``: jit.save and
to_static), the tracer's tensors cannot become ``Tensor``s: ``wrap``
leaves them plain, so the ``paddle.*`` functions run on them as on torch
tensors.
"""
import contextlib
import contextvars
import copy
import functools

import numpy as np
import torch

from . import dtype as dtype_mod
from . import errors
from . import place as place_mod

_base = torch.Tensor


def _np_to_torch(arr, dtype):
    """A torch copy of numpy ``arr`` in ``dtype`` (None: the reference's
    canonical dtype, float64 -> the default dtype)."""
    if arr.dtype.name == "bfloat16":  # ml_dtypes: through its raw words
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).astype(np.int16))
        t = t.view(torch.bfloat16)
    else:
        if arr.dtype == object:
            arr = np.asarray(arr.tolist())
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is None:
        if t.dtype == torch.float64:
            dtype = dtype_mod.convert_dtype(dtype_mod.get_default_dtype())
        else:
            dtype = dtype_mod.canonicalize_dtype(t.dtype)
    return t.to(dtype)


#: called as ``hook(x, alias)`` after each ``as_subclass`` of ``plain`` and
#: ``wrap`` while a static Program records (``as_subclass`` does not reach
#: a TorchFunctionMode; static/program.py)
ALIAS_HOOK = [None]


def plain(x):
    """The plain torch tensor of a Tensor (detached where it is marked
    ``stop_gradient``); anything else unchanged."""
    if type(x) is Tensor:
        if x.__dict__.get("_stop"):
            return _base.detach(x)
        out = x.as_subclass(_base)
        if ALIAS_HOOK[0] is not None:
            ALIAS_HOOK[0](x, out)
        return out
    return x


_CAPTURING = contextvars.ContextVar("capturing", default=False)


def capturing():
    """Whether this thread is inside ``capture_scope``."""
    return _CAPTURING.get()


@contextlib.contextmanager
def capture_scope():
    """The span of a ``torch.export`` trace of a port program."""
    token = _CAPTURING.set(True)
    try:
        yield
    finally:
        _CAPTURING.reset(token)


def wrap(x):
    """A torch tensor as a Tensor (itself when it is one; a tensor being
    traced stays plain)."""
    if isinstance(x, _base) and type(x) is not Tensor and not _CAPTURING.get():
        out = x.as_subclass(Tensor)
        if ALIAS_HOOK[0] is not None:
            ALIAS_HOOK[0](x, out)
        return out
    return x


def wrap_all(out):
    """wrap over tuples, lists and dicts of outputs."""
    if isinstance(out, _base):
        return wrap(out)
    if isinstance(out, tuple):
        return tuple(wrap_all(o) for o in out)
    if isinstance(out, list):
        return [wrap_all(o) for o in out]
    if isinstance(out, dict):
        return {k: wrap_all(v) for k, v in out.items()}
    return out


def plain_all(x):
    if type(x) is Tensor:
        return plain(x)
    if isinstance(x, tuple):
        return tuple(plain_all(o) for o in x)
    if isinstance(x, list):
        return [plain_all(o) for o in x]
    if isinstance(x, dict):
        return {k: plain_all(v) for k, v in x.items()}
    return x


def has_tensor(args, kwargs):
    """Whether a Tensor is among ``args`` or ``kwargs``' values (one level,
    and inside a list or tuple)."""
    for a in args:
        if type(a) is Tensor or (type(a) in (list, tuple)
                                 and any(type(v) is Tensor for v in a)):
            return True
    for a in kwargs.values():
        if type(a) is Tensor:
            return True
    return False


def boundary(fn):
    """``fn``, written on torch tensors, as a Paddle function: given a
    Tensor among its arguments it runs on the plain tensors and returns
    Tensors; given torch tensors it is ``fn``."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if has_tensor(args, kwargs):
            return wrap_all(fn(*plain_all(args), **plain_all(kwargs)))
        return fn(*args, **kwargs)

    return run


class _HookHandle:
    def __init__(self, handle=None):
        self._handle = handle

    def remove(self):
        if self._handle is not None:
            self._handle.remove()
            self._handle = None


def _wrap_hook(hook):
    def run(g):
        out = hook(wrap(g))
        return None if out is None else plain(out) if isinstance(out, _base) else out

    return run


def _grad_getter(self):
    g = _base.grad.__get__(self)
    return None if g is None else wrap(g)


def _grad_setter(self, value):
    if value is not None and not isinstance(value, _base):
        value = torch.as_tensor(np.asarray(value), dtype=self.dtype, device=self.device)
    _base.grad.__set__(self, None if value is None else plain(value).detach())


class Tensor(torch.Tensor):
    """The user-facing n-d array (see the module docstring)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __new__(cls, value=None, dtype=None, place=None, stop_gradient=True, name=None):
        t = to_tensor(value, dtype=dtype, place=place, stop_gradient=stop_gradient)
        t.name = name
        return t

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return list(_base.shape.__get__(self))

    @property
    def size(self):
        return _base.numel(self)

    @property
    def place(self):
        return place_mod.place_of(self.device)

    @property
    def stop_gradient(self):
        if self.__dict__.get("_stop"):
            return True
        if self.requires_grad:
            return False
        return self.__dict__.get("_sg", True)

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        if self.is_leaf:
            self.__dict__.pop("_stop", None)
            if self.is_floating_point() or self.is_complex():
                _base.requires_grad_(self, not value)
            else:  # torch keeps integer tensors out of autograd
                self.__dict__["_sg"] = value
        elif value:
            self.__dict__["_stop"] = True
        else:
            self.__dict__.pop("_stop", None)

    grad = property(_grad_getter, _grad_setter)

    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def persistable(self):
        return self.__dict__.get("_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    # ------------------------------------------------------------ conversion
    def numpy(self):
        t = _base.detach(self)
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = _base.numpy(_base.cpu(t))
        return arr.copy() if t.device.type == "cpu" else arr

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self.numpy())

    def __int__(self):
        return int(self.numpy())

    def __bool__(self):
        return bool(self.numpy())

    def __len__(self):
        if self.dim() == 0:
            raise TypeError("len() of a 0-D tensor")
        return _base.shape.__get__(self)[0]

    # ------------------------------------------------------------ autograd
    def backward(self, grad_tensor=None, retain_graph=False):
        from . import tape

        tape.backward([self], None if grad_tensor is None else [grad_tensor],
                      retain_graph=retain_graph)

    def gradient(self):
        g = _base.grad.__get__(self)
        return None if g is None else wrap(g).numpy()

    def clear_grad(self, set_to_zero=False):
        g = _base.grad.__get__(self)
        if set_to_zero and g is not None:
            g.zero_()
        else:
            _base.grad.__set__(self, None)

    clear_gradient = clear_grad

    def register_hook(self, hook):
        if not self.requires_grad:  # the reference keeps it; it never runs
            return _HookHandle()
        return _HookHandle(_base.register_hook(self, _wrap_hook(hook)))

    def detach(self):
        t = wrap(_base.detach(self))
        t.name = self.name
        return t

    def detach_(self):
        if self.is_leaf:
            _base.requires_grad_(self, False)
        else:
            self.__dict__["_stop"] = True
        return self

    def clone(self):
        from .. import tensor as ops

        return ops.assign(self)

    def astype(self, dtype):
        from .. import tensor as ops

        return ops.cast(self, dtype)

    def dim(self):
        return _base.dim(self)

    def numel(self):
        return _base.numel(self)

    # ------------------------------------------------------------ mutation
    def set_value(self, value):
        """Copy ``value`` in (breaks the autograd link, like the reference)."""
        _set_value(self, value)

    def copy_(self, other, blocking=True):
        self.set_value(other)
        return self

    # ------------------------------------------------------------ devices
    def cpu(self):
        return _moved(self, torch.device("cpu"))

    def cuda(self, device_id=0, blocking=True):
        return _moved(self, place_mod.CUDAPlace(device_id or 0).torch_device())

    def pin_memory(self):
        return self

    def to_device(self, place):
        return _moved(self, place_mod.resolve_device(place))

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # ------------------------------------------------------------ misc
    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place!r}, stop_gradient={self.stop_gradient},\n"
                f"       {np.array2string(self.numpy(), prefix='       ')})")

    def __format__(self, spec):
        if self.dim() == 0:
            return self.item().__format__(spec)
        return repr(self)

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        t = wrap(_base.clone(_base.detach(self)))
        if self.is_leaf and self.requires_grad:
            _base.requires_grad_(t, True)
        t.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = t
        return t


def _moved(t, device):
    """A leaf copy of ``t`` on ``device`` with its stop_gradient."""
    out = wrap(_base.detach(t).to(device))
    if t.requires_grad:
        _base.requires_grad_(out, True)
    return out


def _set_value(t, value):
    if isinstance(value, _base):
        new = _base.detach(plain(value)) if type(value) is Tensor else _base.detach(value)
    else:
        new = _np_to_torch(np.asarray(value), None)
    if tuple(new.shape) != tuple(_base.shape.__get__(t)):
        raise errors.InvalidArgumentError(
            f"set_value shape mismatch {tuple(new.shape)} vs {tuple(t.shape)}")
    with torch.no_grad():
        _base.copy_(t, new.to(device=t.device, dtype=t.dtype))
    if not t.is_leaf and type(t) is Tensor:  # off the graph from here on
        t.__dict__["_stop"] = True


class Parameter(torch.nn.Parameter):
    """A trainable torch Parameter with the reference's attributes
    (reference: framework.py:5727 ParamBase)."""

    def __new__(cls, data=None, requires_grad=True, trainable=None, name=None):
        if trainable is not None:
            requires_grad = bool(trainable)
        if data is None:
            data = torch.empty(0)
        elif not isinstance(data, _base):
            data = _np_to_torch(np.asarray(data), None)
        p = torch.Tensor._make_subclass(cls, plain(data).detach(), requires_grad)
        if name is not None:
            p.name = name
        return p

    def __init__(self, *args, **kwargs):
        pass

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def name(self):
        return self.__dict__.get("param_name")

    @name.setter
    def name(self, value):
        self.__dict__["param_name"] = value

    persistable = True
    need_clip = True
    regularizer = None
    is_distributed = False

    @property
    def optimize_attr(self):
        return self.__dict__.setdefault("optimize_attr", {"learning_rate": 1.0})

    @optimize_attr.setter
    def optimize_attr(self, value):
        self.__dict__["optimize_attr"] = value

    @property
    def place(self):
        return place_mod.place_of(self.device)

    def numpy(self):
        return Tensor.numpy(self)

    def set_value(self, value):
        _set_value(self, value)

    def gradient(self):
        g = self.grad
        return None if g is None else Tensor.numpy(g)

    def clear_grad(self, set_to_zero=False):
        if set_to_zero and self.grad is not None:
            self.grad.zero_()
        else:
            self.grad = None

    clear_gradient = clear_grad

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        result = type(self)(self.data.clone(memory_format=torch.preserve_format),
                            self.requires_grad)
        result.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = result
        return result

    def __repr__(self):
        return "Parameter containing:\n" + torch.Tensor.__repr__(self)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new leaf Tensor on ``place`` (the current place,
    the card unless ``set_device`` said otherwise; raises without a card
    unless the CPU was asked for)."""
    device = (place_mod.current_device() if place is None
              else place_mod.resolve_device(place))
    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, _base):
        t = _base.detach(data)
        if dt is not None:
            t = t.to(dt)
        t = t.to(device)
        if t is plain(data) or t.data_ptr() == data.data_ptr():
            t = t.clone()
    else:
        t = _np_to_torch(np.asarray(data), dt).to(device)
    out = torch.Tensor._make_subclass(Tensor, t, False)
    if not stop_gradient:
        out.stop_gradient = False
    return out
