"""InputSpec (counterpart of paddle_tpu/static/input_spec.py; reference:
python/paddle/static/input.py). A dtype is kept as its name ("float32",
"int32", ...); a torch dtype, a numpy dtype or a Python type is named the
way the reference names it."""
import numpy as np
import torch

from ..core.dtype import dtype_name


def _dtype_str(dtype):
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return dtype_name(dtype)
    return np.dtype(dtype).name


class InputSpec:
    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = _dtype_str(dtype)
        self.name = name

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), _dtype_str(tensor.dtype),
                   name or getattr(tensor, "name", None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(list(ndarray.shape), str(ndarray.dtype), name)

    def batch(self, batch_size):
        return InputSpec([batch_size] + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"
