"""Carry weights across from the JAX package.

``load_numpy_state(module, state)`` takes ``{name: np.ndarray}`` (the JAX
model's ``named_parameters()`` as numpy arrays; parameter names and
layouts are the same in both packages) and copies it into ``module``'s
parameters. It is a checked copy: a missing or unexpected name, a shape
or a dtype that differs raises, and nothing is copied.

Buffers travel too: a name in ``state`` that is one of ``module``'s
buffers (an ``Int8Linear``'s or ``Int8Conv2D``'s int8 ``qweight``, its
``w_scale`` and ``act_scale``; a QAT wrapper's ``act_scale``, its layer's
parameters under ``inner.*``; BatchNorm's running statistics) is copied
into it under the same checks. Arrays keep their dtypes: int8, float32 and
bfloat16 (ml_dtypes' numpy bfloat16, which torch cannot read directly,
travels as its raw 16-bit words). The values may be numpy arrays or
anything numpy can read (the JAX package's Tensors and arrays, as its
``state_dict()`` gives them).

A tied parameter (one Parameter reachable under several names, as
``BertForPretraining``'s decoder weight is the word embedding) is listed
once by ``named_parameters()``, under its first name, in both packages,
and is copied once. ``state`` may also hold it under its other names (a
``state_dict()`` does); each such entry must equal the array under the
first name, since a tie cannot hold two values.
"""
import numpy as np
import torch


def _aliases(module):
    """{other name: first name} for every tied parameter of ``module``."""
    first = {}
    out = {}
    for name, p in module.named_parameters(remove_duplicate=False):
        if id(p) in first:
            out[name] = first[id(p)]
        else:
            first[id(p)] = name
    return out


def _numpy_dtype_name(dt):
    """numpy's name of the torch dtype ``dt`` ("bfloat16" for bf16, which
    torch cannot hand to numpy)."""
    if dt == torch.bfloat16:
        return "bfloat16"
    return torch.empty((), dtype=dt).numpy().dtype.name


def _to_tensor(arr):
    """A writable torch copy of ``arr``; a bfloat16 array through its raw
    16-bit words."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _check(name, arr, p):
    if tuple(arr.shape) != tuple(p.shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)} does not match "
                         f"the parameter's {tuple(p.shape)}")
    want = _numpy_dtype_name(p.dtype)
    if np.dtype(arr.dtype).name != want:
        raise TypeError(f"{name}: dtype {arr.dtype} does not match the "
                        f"parameter's {want}")


def _arrays(state):
    return {k: np.asarray(getattr(v, "_value", v)) for k, v in state.items()}


def load_numpy_state(module, state):
    state = _arrays(state)
    params = dict(module.named_parameters())
    buffers = {n: b for n, b in module.named_buffers() if n in state}
    aliases = _aliases(module)
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params) - set(buffers) - set(aliases))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for alias, name in aliases.items():
        if alias in state and not np.array_equal(state[alias], state[name]):
            raise ValueError(f"{alias} is tied to {name} but the state gives it "
                             "another value")
    targets = {**params, **buffers}
    for name, p in targets.items():
        _check(name, state[name], p)
    with torch.no_grad():
        for name, p in targets.items():
            p.copy_(_to_tensor(state[name]))
    return module


def load_state_dict(layer, state):
    """Load a JAX ``Layer.state_dict()`` (numpy arrays) by structured name
    (see the module docstring)."""
    state = _arrays(state)
    own = layer.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state_dict names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, t in own.items():
        _check(name, state[name], t)
    layer.set_state_dict(state)
    return layer
