"""Layer — the module base class (counterpart of paddle_tpu/nn/layer.py).

``Layer`` is a ``torch.nn.Module`` with Paddle's surface:
``create_parameter``, ``add_parameter``, ``add_sublayer``,
``register_buffer(name, tensor, persistable)``, ``parameters`` (a list)
and ``named_parameters``, ``sublayers`` and ``named_sublayers``,
``state_dict``/``set_state_dict`` with the reference's structured names (a
tied parameter once, under its first name; non-persistable buffers left
out), ``register_forward_pre_hook``/``register_forward_post_hook`` (each
returns a ``HookRemoveHelper``),
``to``/``astype`` with Paddle's spellings, ``clear_gradients``,
``full_name``. Every module of the port derives from it. torch's
``load_state_dict`` takes either structure.

The Tensor boundary: a Layer whose ``forward`` is the port's own (written
on torch tensors) and that receives a ``Tensor`` runs on the plain torch
tensors under it and returns its outputs as ``Tensor``s; its sublayers
then see plain tensors only. Called with torch tensors, it is a
``torch.nn.Module`` call and nothing is converted. A Layer that a user
writes (its ``forward`` defined outside the port) gets its arguments as
given, so Paddle code in it runs on Tensors. Forward hooks see Tensors.
"""
import collections

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.tensor import Parameter, has_tensor, plain_all, wrap_all
from ..framework.param_attr import ParamAttr
from . import initializer as init_mod

_LAYER_COUNTERS = collections.defaultdict(int)
_PORT = __name__.split(".")[0] + "."


class HookRemoveHelper:
    """What a forward hook's registration returns: ``remove()`` takes the
    hook out of the layer's hook table ``hooks`` (and of the ``extra``
    tables torch keeps beside it for the same key)."""

    def __init__(self, hooks, key, extra=()):
        self._hooks = hooks
        self._key = key
        self._extra = tuple(extra)

    def remove(self):
        for table in (self._hooks, *self._extra):
            table.pop(self._key, None)


class Layer(torch.nn.Module):
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._plain_forward = (getattr(cls.forward, "__module__", "") or "").startswith(_PORT)

    _plain_forward = False

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        if name_scope is None:
            name_scope = type(self).__name__.lower()
        idx = _LAYER_COUNTERS[name_scope]
        _LAYER_COUNTERS[name_scope] += 1
        self._full_name = f"{name_scope}_{idx}"
        self._dtype = dtype

    # ------------------------------------------------------------ call
    def __call__(self, *args, **kwargs):
        if self._plain_forward and has_tensor(args, kwargs):
            return wrap_all(self._call_impl(*plain_all(args), **plain_all(kwargs)))
        if self._compiled_call_impl is not None:
            return self._compiled_call_impl(*args, **kwargs)
        return self._call_impl(*args, **kwargs)

    # ------------------------------------------------------------ naming
    def full_name(self):
        return self._full_name

    # ------------------------------------------------------------ params
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None, generator=None):
        """A Parameter made as ``attr`` says (a ParamAttr, a name, an
        initializer, or False for no parameter: ``ParamAttr._to_attr``).
        Its initializer is the attr's, else ``default_initializer``, else
        ``set_global_initializer``'s, else Constant(0) for a bias and
        XavierNormal otherwise. It lies on ``device``, the current place
        when None, and draws from ``generator`` (the port's: a seeded
        ``torch.Generator``; ``paddle.seed``'s when None)."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = (attr.initializer or default_initializer
                or init_mod.global_initializer(is_bias)
                or (init_mod.Constant(0.0) if is_bias else init_mod.XavierNormal()))
        d = dtype_mod.convert_dtype(dtype or self._dtype)
        value = init(tuple(int(s) for s in shape), generator).to(
            device=place_mod.resolve_device(device), dtype=d)
        p = Parameter(value, trainable=attr.trainable, name=attr.name)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        if attr.regularizer is not None:
            p.regularizer = attr.regularizer
        if attr.need_clip is False:
            p.need_clip = False
        if p.name is None:
            p.name = f"{self._full_name}.w_{len(self._parameters)}"
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, persistent=None):
        super().register_buffer(name, tensor,
                                persistable if persistent is None else persistent)
        return tensor

    # ------------------------------------------------------------ iteration
    def parameters(self, include_sublayers=True, recurse=None):
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers,
                                                    recurse=recurse)]

    def named_parameters(self, prefix="", include_sublayers=True, recurse=None,
                         remove_duplicate=True):
        return super().named_parameters(
            prefix=prefix, recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers,
                                                 recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix, recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    # ------------------------------------------------------------ state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = collections.OrderedDict() if destination is None else destination
        for name, p in self.named_parameters(prefix=structured_name_prefix,
                                             include_sublayers=include_sublayers):
            dest[name] = p
        for name, layer in self.named_sublayers(prefix=structured_name_prefix,
                                                include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistent_buffers_set:
                    continue
                dest[f"{name}.{bname}" if name else bname] = b
            if not include_sublayers:
                break
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values in by structured name; returns (missing,
        unexpected) names. numpy arrays (bfloat16 ones too) and tensors."""
        from ..convert import _to_tensor

        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for key, value in state_dict.items():
                if key not in own:
                    continue
                tgt = own[key]
                src = value if isinstance(value, torch.Tensor) else _to_tensor(np.asarray(value))
                torch.Tensor.copy_(tgt, torch.Tensor.detach(src).to(device=tgt.device,
                                                                    dtype=tgt.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """torch's ``load_state_dict``, which also takes the reference's
        structure of ``state_dict()``: a tied parameter given once, under its
        first name, fills its other names too."""
        state = dict(state_dict)
        first = {}
        for name, p in self.named_parameters(remove_duplicate=False):
            if id(p) in first:
                if name not in state and first[id(p)] in state:
                    state[name] = state[first[id(p)]]
            else:
                first[id(p)] = name
        return super().load_state_dict(state, strict=strict, assign=assign)

    # ------------------------------------------------------------ hooks
    def register_forward_pre_hook(self, hook, **kwargs):
        def run(layer, inputs):
            out = hook(layer, wrap_all(inputs))
            return None if out is None else plain_all(out) if layer._plain_forward else out

        handle = super().register_forward_pre_hook(run, **kwargs)
        return HookRemoveHelper(self._forward_pre_hooks, handle.id,
                                (self._forward_pre_hooks_with_kwargs,))

    def register_forward_post_hook(self, hook):
        def run(layer, inputs, outputs):
            out = hook(layer, wrap_all(inputs), wrap_all(outputs))
            return None if out is None else plain_all(out) if layer._plain_forward else out

        handle = self.register_forward_hook(run)
        return HookRemoveHelper(self._forward_hooks, handle.id,
                                (self._forward_hooks_with_kwargs,
                                 self._forward_hooks_always_called))

    # ------------------------------------------------------------ conversion
    def to(self, *args, **kwargs):
        """Paddle's ``to(device=None, dtype=None, blocking=None)`` and torch's
        spellings: "gpu", "gpu:0", "cpu", a Place or torch.device; a dtype
        name or torch dtype (floating parameters and buffers only)."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, torch.dtype) or (isinstance(a, str) and a in dtype_mod._STR2DTYPE):
                dtype = a
            else:
                device = a
        return super().to(
            device=None if device is None else place_mod.resolve_device(device),
            dtype=None if dtype is None else dtype_mod.convert_dtype(dtype), **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_grad(set_to_zero)
