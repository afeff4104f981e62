"""Search and sort ops (counterpart of paddle_tpu/tensor/search.py).
Indices come back int32, the reference's index dtype; sorts are stable,
so ties resolve to the lower index as ``lax.top_k`` and the reference's
stable ``argsort`` do. ``mode`` runs through numpy, as in the reference."""
import numpy as np
import torch

from ..core.dispatch import apply
from ..core.tensor import Tensor  # noqa: F401

_I32 = torch.int32


def _arg(fn):
    def run(x, axis, keepdim):
        if axis is None:
            return fn(x.reshape(-1), 0).to(_I32)
        out = fn(x, axis).to(_I32)
        return out.unsqueeze(axis) if keepdim else out

    return run


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    ax = None if axis is None else int(axis)
    return apply("argmax", lambda x: _arg(torch.argmax)(x, ax, bool(keepdim)), x)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    ax = None if axis is None else int(axis)
    return apply("argmin", lambda x: _arg(torch.argmin)(x, ax, bool(keepdim)), x)


def argsort(x, axis=-1, descending=False, name=None):
    return apply("argsort", lambda x: torch.argsort(-x if descending else x, dim=int(axis),
                                                    stable=True).to(_I32), x)


def sort(x, axis=-1, descending=False, name=None):
    def _sort(x):
        s = torch.sort(x, dim=int(axis), stable=True).values
        return torch.flip(s, (int(axis),)) if descending else s

    return apply("sort", _sort, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    k = int(k)

    def _topk(x):
        ax = x.dim() - 1 if axis is None else int(axis) % x.dim()
        xm = torch.movedim(x, ax, -1)
        key = xm if largest else -xm
        order = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
        v = torch.take_along_dim(xm, order, dim=-1)
        return torch.movedim(v, -1, ax), torch.movedim(order.to(_I32), -1, ax)

    return apply("topk", _topk, x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)

    def _where(c, x, y):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=c.device)
        if not isinstance(y, torch.Tensor):
            y = torch.as_tensor(y, device=c.device)
        return torch.where(c.to(torch.bool), x, y)

    return apply("where", _where, condition, x, y)


def nonzero(x, as_tuple=False):
    if as_tuple:
        return apply("nonzero", lambda x: tuple(i.to(_I32).reshape(-1, 1)
                                                for i in torch.nonzero(x, as_tuple=True)), x)
    return apply("nonzero", lambda x: torch.nonzero(x).to(_I32), x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    return apply("searchsorted", lambda s, v: torch.searchsorted(s, v, right=bool(right))
                 .to(_I32), sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def masked_select(x, mask, name=None):
    from .manipulation import masked_select as _ms

    return _ms(x, mask)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def _kth(x):
        ax = int(axis)
        s, i = torch.sort(x, dim=ax, stable=True)
        sel = torch.tensor([int(k) - 1], device=x.device)
        v = torch.index_select(s, ax, sel)
        ix = torch.index_select(i, ax, sel).to(_I32)
        if not keepdim:
            v, ix = v.squeeze(ax), ix.squeeze(ax)
        return v, ix

    return apply("kthvalue", _kth, x)


def mode(x, axis=-1, keepdim=False, name=None):
    from .manipulation import _host_array, _host_out

    arr = _host_array(x)
    ax = axis % arr.ndim
    moved = np.moveaxis(arr, ax, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], arr.dtype)
    idxs = np.empty(flat.shape[0], np.int64)
    for r in range(flat.shape[0]):
        uniq, counts = np.unique(flat[r], return_counts=True)
        best = uniq[np.argmax(counts)]
        vals[r] = best
        idxs[r] = np.where(flat[r] == best)[0][-1]
    v = vals.reshape(moved.shape[:-1])
    i = idxs.reshape(moved.shape[:-1])
    if keepdim:
        v, i = np.expand_dims(v, ax), np.expand_dims(i, ax)
    return _host_out("mode", x, (v, i))
