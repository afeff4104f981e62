"""Carry weights across from the JAX package.

``load_numpy_state(module, state)`` takes ``{name: np.ndarray}`` (the JAX
model's ``named_parameters()`` as numpy arrays; parameter names and
layouts are the same in both packages) and copies it into ``module``'s
parameters. It is a checked copy: a missing or unexpected name, a shape
or a dtype that differs raises, and nothing is copied.

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


def load_numpy_state(module, state):
    params = dict(module.named_parameters())
    aliases = _aliases(module)
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params) - set(aliases))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for alias, name in aliases.items():
        if alias in state and not np.array_equal(state[alias], state[name]):
            raise ValueError(f"{alias} is tied to {name} but the state gives it "
                             "another value")
    for name, p in params.items():
        arr = state[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not match "
                             f"the parameter's {tuple(p.shape)}")
        want = torch.empty((), dtype=p.dtype).numpy().dtype
        if np.dtype(arr.dtype) != want:
            raise TypeError(f"{name}: dtype {arr.dtype} does not match the "
                            f"parameter's {want}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(state[name])))  # a writable copy
    return module
