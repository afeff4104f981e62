"""Carry weights across from the JAX package.

``load_numpy_state(module, state)`` takes ``{name: np.ndarray}`` (the JAX
model's ``named_parameters()`` as numpy arrays; parameter names and
layouts are the same in both packages) and copies it into ``module``'s
parameters. It is a checked copy: a missing or unexpected name, a shape
or a dtype that differs raises, and nothing is copied.
"""
import numpy as np
import torch


def load_numpy_state(module, state):
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
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
