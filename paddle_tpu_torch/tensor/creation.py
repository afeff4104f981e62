"""Creation ops (counterpart of paddle_tpu/tensor/creation.py). Tensors
are made on the current place (``set_device``), in the reference's
dtypes; values the reference takes from numpy (``arange``, the triangle
indices) are made by numpy here too, so they are the same bits."""
import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.dispatch import apply, finish
from ..core.tensor import Parameter, Tensor, to_tensor  # noqa: F401


def _norm_shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in np.asarray(shape.detach().cpu()).reshape(-1))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s) for s in shape)


def _dtype(dtype, default_float=True):
    d = dtype_mod.convert_dtype(dtype)
    if d is None and default_float:
        d = dtype_mod.convert_dtype(dtype_mod.get_default_dtype())
    return d


def _dev():
    return place_mod.current_device()


def _host(name, arr):
    return finish(name, torch.from_numpy(np.ascontiguousarray(arr)).to(_dev()))


def full(shape, fill_value, dtype=None, name=None):
    shape = _norm_shape(shape)
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = "bool"
        elif isinstance(fill_value, int):
            dtype = "int64"
        else:
            dtype = dtype_mod.get_default_dtype()
    return finish("full", torch.full(shape, fill_value, dtype=_dtype(dtype), device=_dev()))


def zeros(shape, dtype=None, name=None):
    return full(shape, 0.0, dtype or dtype_mod.get_default_dtype())


def ones(shape, dtype=None, name=None):
    return full(shape, 1.0, dtype or dtype_mod.get_default_dtype())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    d = dtype_mod.convert_dtype(dtype)
    return apply("full_like", lambda x: torch.full_like(x, fill_value, dtype=d), x)


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0, dtype)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    for v in (start, end, step):
        if isinstance(v, torch.Tensor):
            raise NotImplementedError("tensor bounds for arange: pass python numbers")
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer)) for v in (start, end, step))
                 else dtype_mod.get_default_dtype())
    d = _dtype(dtype)
    np_dtype = dtype_mod.dtype_name(d)
    if d == torch.bfloat16:
        return _host("arange", np.arange(start, end, step, np.float32)).to(d)
    return _host("arange", np.arange(start, end, step, np.dtype(np_dtype)))


def linspace(start, stop, num, dtype=None, name=None):
    """jnp.linspace in float32: start * (1 - s_i) + stop * s_i with s_i =
    i * (1 / (n-1)) (XLA folds the division by the constant into a product
    with its float32 reciprocal), the last point ``stop``."""
    d = _dtype(dtype)
    if isinstance(start, torch.Tensor):
        start = start.item()
    if isinstance(stop, torch.Tensor):
        stop = stop.item()
    num = int(num.item() if isinstance(num, torch.Tensor) else num)
    dev = _dev()
    f32 = torch.float32
    start_t = torch.tensor(start, dtype=f32, device=dev)
    stop_t = torch.tensor(stop, dtype=f32, device=dev)
    if num > 1:
        div = num - 1
        step = torch.arange(div, dtype=f32, device=dev) * float(np.float32(1) / np.float32(div))
        out = torch.cat([start_t * (1 - step) + stop_t * step, stop_t[None]])
    elif num == 1:
        out = start_t[None]
    else:
        out = torch.empty(0, dtype=f32, device=dev)
    if not d.is_floating_point:
        out = torch.floor(out)
    return finish("linspace", out.to(d))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    m = int(num_rows) if num_columns is None else int(num_columns)
    return finish("eye", torch.eye(int(num_rows), m, dtype=_dtype(dtype), device=_dev()))


def assign(x, output=None):
    if not isinstance(x, torch.Tensor):
        x = to_tensor(np.asarray(x), place=place_mod.current_place())
    out = apply("assign", lambda v: v.clone(), x)
    if output is not None:
        output.set_value(out)
        return output
    return out


def clone(x, name=None):
    return assign(x)


def diag(x, offset=0, padding_value=0, name=None):
    def _diag(x):
        if x.dim() == 1:
            d = torch.diag(x, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
                d = torch.where(mask, d, torch.full_like(d, padding_value))
            return d
        return torch.diagonal(x, offset)

    return apply("diag", _diag, x)


def diagflat(x, offset=0, name=None):
    return apply("diagflat", lambda x: torch.diagflat(x, offset), x)


def tril(x, diagonal=0, name=None):
    return apply("tril", lambda x: torch.tril(x, diagonal), x)


def triu(x, diagonal=0, name=None):
    return apply("triu", lambda x: torch.triu(x, diagonal), x)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(apply("meshgrid", lambda *xs: tuple(torch.meshgrid(*xs, indexing="ij")),
                      *args))


def numel(x, name=None):
    return apply("numel", lambda x: torch.tensor(x.numel(), dtype=torch.int32,
                                                 device=x.device), x)


def tril_indices(row, col, offset=0, dtype="int64"):
    r, c = np.tril_indices(row, offset, col)
    d = dtype_mod.dtype_name(_dtype(dtype, False))
    return _host("tril_indices", np.stack([r, c]).astype(np.dtype(d)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    r, c = np.triu_indices(row, offset, col if col is not None else row)
    d = dtype_mod.dtype_name(_dtype(dtype, False))
    return _host("triu_indices", np.stack([r, c]).astype(np.dtype(d)))


def complex(real, imag, name=None):
    return apply("complex", lambda r, i: torch.complex(r, i), real, imag)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """paddle.create_parameter — a standalone trainable Parameter on the
    current place, Constant(0) for a bias and XavierNormal otherwise."""
    from ..nn import initializer as init_mod

    init = default_initializer or (init_mod.Constant(0.0) if is_bias
                                   else init_mod.XavierNormal())
    value = init(_norm_shape(shape)).to(device=_dev(), dtype=_dtype(dtype))
    return Parameter(value, name=name)
