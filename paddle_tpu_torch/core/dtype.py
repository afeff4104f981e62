"""dtype registry (counterpart of paddle_tpu/core/dtype.py).

The dtype names are torch dtypes (``paddle.float32`` is ``torch.float32``).
``convert_dtype`` takes a name, a torch dtype, a numpy dtype or a Python
type and returns the canonical torch dtype: as in the reference, the
64-bit names are accepted and compute in 32 bits (int64 -> int32, uint64
-> uint32, float64 -> float32, complex128 -> complex64), so
``to_tensor(np.int64 array)`` is int32 as in the JAX package.
"""
import numpy as np
import torch

bool = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)

_CANONICAL = {
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.float64: torch.float32,
    torch.complex128: torch.complex64,
}


def canonicalize_dtype(dtype):
    return _CANONICAL.get(dtype, dtype)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _STR2DTYPE[dtype]
        except KeyError:
            raise ValueError(f"unknown dtype {dtype!r}") from None
    name = np.dtype(dtype).name
    try:
        return _STR2DTYPE[name]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def convert_dtype(dtype):
    """A name, torch / numpy dtype or Python type -> the canonical (32-bit)
    torch dtype; None stays None."""
    if dtype is None:
        return None
    return canonicalize_dtype(_torch_dtype(dtype))


def dtype_name(dtype):
    """"float32", "int32", "bfloat16", ... for a torch dtype."""
    return str(dtype).rsplit(".", 1)[-1]


def is_floating(dtype):
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype):
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != torch.bool


def get_default_dtype():
    from . import flags

    return flags.get_flags("default_dtype")["default_dtype"]


def set_default_dtype(d):
    from . import flags

    name = dtype_name(convert_dtype(d))
    if name not in ("float16", "bfloat16", "float32", "float64"):
        raise ValueError(f"default dtype must be floating, got {name}")
    flags.set_flags({"default_dtype": name})
