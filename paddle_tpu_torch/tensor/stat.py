"""Statistics ops (counterpart of paddle_tpu/tensor/stat.py). ``median``
averages the two middle values of an even count, as numpy's does."""
import torch

from ..core.dispatch import apply
from .math import _axis_norm, _dims, _f, mean  # noqa: F401


def _moment(fn, x, axis, unbiased, keepdim):
    ax = _axis_norm(axis)
    return apply(fn.__name__, lambda x: fn(_f(x), dim=_dims(x, ax), correction=1 if unbiased
                                           else 0, keepdim=bool(keepdim)), x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment(torch.std, x, axis, unbiased, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment(torch.var, x, axis, unbiased, keepdim)


def _quantile(name, fn, x, q, axis, keepdim):
    ax = _axis_norm(axis)

    def run(x):
        x = _f(x)
        qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
        if ax is None:
            out = fn(x.reshape(-1), qt, dim=0)
            if keepdim:
                out = out.reshape(out.shape[:qt.dim()] + (1,) * x.dim())
            return out
        if isinstance(ax, tuple):
            keep = [d for d in range(x.dim()) if d not in {a % x.dim() for a in ax}]
            moved = x.permute(keep + sorted(a % x.dim() for a in ax))
            moved = moved.reshape(moved.shape[:len(keep)] + (-1,))
            out = fn(moved, qt, dim=-1)
            if keepdim:
                shape = list(x.shape)
                for a in ax:
                    shape[a % x.dim()] = 1
                out = out.reshape(tuple(out.shape[:qt.dim()]) + tuple(shape))
            return out
        return fn(x, qt, dim=ax, keepdim=bool(keepdim))

    return apply(name, run, x)


def median(x, axis=None, keepdim=False, name=None):
    return _quantile("median", torch.quantile, x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile("nanmedian", torch.nanquantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    q = tuple(float(v) for v in q) if isinstance(q, (list, tuple)) else float(q)
    return _quantile("quantile", torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    q = tuple(float(v) for v in q) if isinstance(q, (list, tuple)) else float(q)
    return _quantile("nanquantile", torch.nanquantile, x, q, axis, keepdim)
