"""Shape and layout ops (counterpart of paddle_tpu/tensor/manipulation.py).
Index arguments may be int32 (the reference's index dtype): each op casts
them for torch, which wants int64 indices, and returns the reference's
dtypes. ``unique``, ``unique_consecutive`` and ``masked_select`` have
data-dependent shapes and, as in the reference, ``unique*`` run through
numpy."""
import builtins

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import errors
from ..core.dispatch import apply, finish
from ..core.tensor import Tensor
from .math import _inplace

_base = torch.Tensor
builtins_slice = builtins.slice


def _shape_arg(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in np.asarray(shape.detach().cpu()).reshape(-1))
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s) for s in shape)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def concat(x, axis=0, name=None):
    axis = _int(axis)
    return apply("concat", lambda *xs: torch.cat(xs, axis), *x)


def stack(x, axis=0, name=None):
    return apply("stack", lambda *xs: torch.stack(xs, int(axis)), *x)


def unstack(x, axis=0, num=None):
    return list(apply("unstack", lambda x: tuple(torch.unbind(x, int(axis))), x))


def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f"array split does not result in an equal division: "
                             f"{dim} into {num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        secs = [_int(s) for s in num_or_sections]
        rem = dim - builtins.sum(s for s in secs if s > 0)
        sections = [s if s > 0 else rem for s in secs]
    return list(apply("split", lambda x: tuple(torch.split(x, sections, axis)), x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(input, axis=0):
    return unstack(input, axis)


def squeeze(x, axis=None, name=None):
    if isinstance(axis, torch.Tensor):
        axis = int(axis.item())
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    elif axis is not None:
        axis = (int(axis),)

    def _squeeze(x):
        if axis is None:
            return torch.squeeze(x)
        ax = tuple(a for a in axis if x.shape[a] == 1)
        return torch.squeeze(x, ax) if ax else x.clone()

    return apply("squeeze", _squeeze, x)


def _unsqueeze_axes(ndim, axis):
    out = ndim + len(axis)
    return sorted(a % out for a in axis)


def unsqueeze(x, axis, name=None):
    if isinstance(axis, torch.Tensor):
        axis = int(axis.item())
    if isinstance(axis, (list, tuple)):
        axis = tuple(_int(a) for a in axis)
    else:
        axis = (int(axis),)

    def _unsqueeze(x):
        for a in _unsqueeze_axes(x.dim(), axis):
            x = x.unsqueeze(a)
        return x

    return apply("unsqueeze", _unsqueeze, x)


def reshape(x, shape, name=None):
    shape = _shape_arg(shape)
    return apply("reshape", lambda x: torch.reshape(x, shape), x)


def transpose(x, perm, name=None):
    perm = tuple(int(p) for p in perm)
    return apply("transpose", lambda x: x.permute(perm), x)


def moveaxis(x, source, destination, name=None):
    s = tuple(np.atleast_1d(source).tolist())
    d = tuple(np.atleast_1d(destination).tolist())
    return apply("moveaxis", lambda x: torch.movedim(x, s, d), x)


def swapaxes(x, axis0, axis1, name=None):
    return apply("swapaxes", lambda x: torch.swapaxes(x, int(axis0), int(axis1)), x)


transpose_ = transpose


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def _flatten(x):
        nd = x.dim()
        if nd == 0:
            return x.reshape(1)
        start, stop = int(start_axis) % nd, int(stop_axis) % nd
        return x.reshape(tuple(x.shape[:start]) + (-1,) + tuple(x.shape[stop + 1:]))

    return apply("flatten", _flatten, x)


def roll(x, shifts, axis=None, name=None):
    sh = tuple(np.atleast_1d(shifts).tolist())
    if axis is None:
        return apply("roll", lambda x: torch.roll(x, int(np.sum(sh))), x)
    ax = tuple(np.atleast_1d(axis).tolist())
    return apply("roll", lambda x: torch.roll(x, sh, ax), x)


def flip(x, axis, name=None):
    ax = tuple(np.atleast_1d(axis).tolist())
    return apply("flip", lambda x: torch.flip(x, ax), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply("rot90", lambda x: torch.rot90(x, k, tuple(axes)), x)


def tile(x, repeat_times, name=None):
    reps = _shape_arg(repeat_times)
    return apply("tile", lambda x: torch.tile(x, reps), x)


def expand(x, shape, name=None):
    shape = _shape_arg(shape)

    def _expand(x):
        xshape = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
        tgt = tuple(xs if s == -1 else s for s, xs in zip(shape, xshape))
        return torch.broadcast_to(x.reshape(xshape), tgt)

    return apply("expand", _expand, x)


broadcast_to = expand


def expand_as(x, y, name=None):
    return apply("expand_as", lambda x, y: torch.broadcast_to(x, y.shape), x, y)


def broadcast_tensors(input, name=None):
    return list(apply("broadcast_tensors", lambda *xs: tuple(torch.broadcast_tensors(*xs)),
                      *input))


def cast(x, dtype):
    d = dtype_mod.convert_dtype(dtype)
    return apply("cast", lambda x: x.to(d) if x.dtype != d else x.clone(), x)


def slice(input, axes, starts, ends):
    axes = tuple(int(a) for a in axes)
    starts = tuple(_int(s) for s in starts)
    ends = tuple(_int(e) for e in ends)

    def _slice(x):
        idx = [builtins_slice(None)] * x.dim()
        for a, s, e in zip(axes, starts, ends):
            idx[a] = builtins_slice(s, e)
        return x[tuple(idx)]

    return apply("slice", _slice, input)


def _take_range(x, axis, s, e, st):
    n = x.shape[axis]
    idx = list(range(*builtins_slice(s, e, st).indices(n)))
    return torch.index_select(x, axis, torch.tensor(idx, dtype=torch.long, device=x.device))


def strided_slice(x, axes, starts, ends, strides, name=None):
    spec = list(zip((int(a) for a in axes), (int(s) for s in starts), (int(e) for e in ends),
                    (int(s) for s in strides)))

    def _ss(x):
        for a, s, e, st in spec:
            x = _take_range(x, a, s, e, st)
        return x

    return apply("strided_slice", _ss, x)


def gather(x, index, axis=0, name=None):
    axis = _int(axis)
    return apply("gather", lambda x, idx: torch.index_select(x, axis, idx.reshape(-1).long()),
                 x, index)


def gather_nd(x, index, name=None):
    def _gather_nd(x, idx):
        idx = idx.long()
        return x[tuple(idx[..., i] for i in range(idx.shape[-1]))]

    return apply("gather_nd", _gather_nd, x, index)


def take_along_axis(arr, indices, axis, broadcast=True):
    return apply("take_along_axis",
                 lambda x, i: torch.take_along_dim(x, i.long(), dim=int(axis)), arr, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign"):
    axis = int(axis)

    def _paa(x, i, v):
        i = i.long()
        v = torch.broadcast_to(torch.as_tensor(v, dtype=x.dtype, device=x.device)
                               .to(x.dtype), i.shape)
        if reduce == "assign":
            return torch.scatter(x, axis, i, v)
        if reduce == "add":
            return torch.scatter_add(x, axis, i, v)
        if reduce in ("multiply", "mul"):
            return torch.scatter_reduce(x, axis, i, v, "prod")
        raise ValueError(reduce)

    return apply("put_along_axis", _paa, arr, indices, values)


def scatter(x, index, updates, overwrite=True, name=None):
    """reference: operators/scatter_op.cc — rows of x at ``index`` replaced
    (``overwrite``) or zeroed and then summed into."""

    def _scatter(x, idx, upd):
        idx = idx.reshape(-1).long()
        if overwrite:
            return torch.index_put(x, (idx,), upd)
        return torch.index_fill(x, 0, idx, 0).index_add(0, idx, upd)

    return apply("scatter", _scatter, x, index, updates)


def scatter_nd_add(x, index, updates, name=None):
    def _snd(x, idx, upd):
        idx = idx.long()
        return torch.index_put(x, tuple(idx[..., i] for i in range(idx.shape[-1])), upd,
                               accumulate=True)

    return apply("scatter_nd_add", _snd, x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    shape = _shape_arg(shape)

    def _snd(idx, upd):
        idx = idx.long()
        zeros = torch.zeros(shape, dtype=upd.dtype, device=upd.device)
        return torch.index_put(zeros, tuple(idx[..., i] for i in range(idx.shape[-1])), upd,
                               accumulate=True)

    return apply("scatter_nd", _snd, index, updates)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index):
    return apply("index_sample", lambda x, idx: torch.gather(x, 1, idx.long()), x, index)


def index_add(x, index, axis, value, name=None):
    return apply("index_add",
                 lambda x, idx, v: torch.index_add(x, int(axis), idx.reshape(-1).long(), v),
                 x, index, value)


def masked_select(x, mask, name=None):
    return apply("masked_select", lambda x, m: x[m.to(torch.bool)], x, mask)


def masked_fill(x, mask, value, name=None):
    return apply("masked_fill",
                 lambda x, m, v: torch.where(m.to(torch.bool),
                                             torch.as_tensor(v, device=x.device).to(x.dtype), x),
                 x, mask, value)


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    if wrap:
        raise errors.UnimplementedError("fill_diagonal(wrap=True) not supported yet")
    offset = int(offset)

    def _fd(x):
        rows, cols = x.shape[0], x.shape[1]
        out = x.clone()
        if offset >= 0:
            r = torch.arange(builtins.max(builtins.min(rows, cols - offset), 0), device=x.device)
            out[r, r + offset] = float(value)
        else:
            r = torch.arange(builtins.max(builtins.min(rows + offset, cols), 0), device=x.device)
            out[r - offset, r] = float(value)
        return out

    return _inplace(x, apply("fill_diagonal", _fd, x))


_PAD_MODES = {"constant": "constant", "reflect": "reflect", "replicate": "edge",
              "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """reference: operators/pad_op.cc / pad3d. ``pad`` gives a pair for every
    axis, or pairs for the trailing spatial axes (last axis first)."""
    if isinstance(pad, torch.Tensor):
        pad = [int(v) for v in np.asarray(pad.detach().cpu()).reshape(-1)]
    pad = tuple(int(p) for p in pad)
    np_mode = _PAD_MODES[mode]

    def _pad(x):
        nd = x.dim()
        if len(pad) == 2 * nd:
            width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        else:
            npairs = len(pad) // 2
            width = [(0, 0)] * nd
            dims = (list(range(nd - npairs, nd)) if data_format.startswith("NC")
                    else list(range(1, 1 + npairs)))
            for i, d in enumerate(reversed(dims)):
                width[d] = (pad[2 * i], pad[2 * i + 1])
        if np_mode == "constant":
            flat = []
            for lo, hi in reversed(width):
                flat += [lo, hi]
            return torch.nn.functional.pad(x, flat, value=value)
        for d, (lo, hi) in enumerate(width):
            if lo or hi:
                idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=np_mode)
                x = torch.index_select(x, d, torch.from_numpy(idx).to(x.device))
        return x

    return apply("pad", _pad, x)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, torch.Tensor):
        repeats = tuple(int(v) for v in np.asarray(repeats.detach().cpu()).reshape(-1))

    def _ri(x):
        r = repeats if isinstance(repeats, int) else torch.tensor(repeats, device=x.device)
        return torch.repeat_interleave(x, r, dim=None if axis is None else int(axis))

    return apply("repeat_interleave", _ri, x)


def _host_out(name, x, arrays):
    """numpy results of a data-dependent op as Tensors on x's device."""
    from ..core.tensor import _np_to_torch

    outs = tuple(_np_to_torch(np.asarray(a), None).to(x.device) for a in arrays)
    return finish(name, outs if len(outs) > 1 else outs[0])


def _host_array(x):
    return Tensor.numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    res = np.unique(_host_array(x), return_index=return_index,
                    return_inverse=return_inverse, return_counts=return_counts, axis=axis)
    return _host_out("unique", x, res if isinstance(res, tuple) else (res,))


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    arr = _host_array(x)
    arr = arr.reshape(-1) if axis is None else arr
    mask = np.ones(len(arr), dtype=bool)
    mask[1:] = arr[1:] != arr[:-1]
    outs = [arr[mask]]
    if return_inverse:
        outs.append((np.cumsum(mask) - 1).astype(np.int64))
    if return_counts:
        idx = np.nonzero(mask)[0]
        outs.append(np.diff(np.append(idx, len(arr))).astype(np.int64))
    return _host_out("unique_consecutive", x, outs)


def as_complex(x, name=None):
    return apply("as_complex", lambda x: torch.complex(x[..., 0], x[..., 1]), x)


def as_real(x, name=None):
    return apply("as_real", lambda x: torch.stack([torch.real(x), torch.imag(x)], -1), x)


def crop(x, shape=None, offsets=None, name=None):
    shape = _shape_arg(shape)
    offsets = tuple(int(o) for o in (offsets or [0] * len(shape)))

    def _crop(x):
        return x[tuple(builtins_slice(o, o + s if s != -1 else None)
                       for o, s in zip(offsets, shape))]

    return apply("crop", _crop, x)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size

    def _shard(x):
        in_range = (x >= lo) & (x < lo + size)
        return torch.where(in_range, x - lo, torch.full_like(x, ignore_value))

    return apply("shard_index", _shard, input)


def tolist(x):
    """Nested Python list of the tensor's values (reference:
    tensor/manipulation.py:45)."""
    return _host_array(x).tolist()


def crop_tensor(x, shape=None, offsets=None, name=None):
    """Crop a ``shape``-sized window at ``offsets``; -1 in ``shape`` runs to
    the end of that axis (reference: operators/crop_tensor_op.cc)."""
    xnd = len(x.shape)
    shape = tuple(int(s) for s in (shape if shape is not None else x.shape))
    offsets = tuple(int(o) for o in (offsets if offsets is not None else [0] * xnd))

    def _crop(x):
        return x[tuple(builtins_slice(o, x.shape[i] if s == -1 else o + s)
                       for i, (o, s) in enumerate(zip(offsets, shape)))]

    return apply("crop_tensor", _crop, x)


def reverse(x, axis, name=None):
    """Legacy alias of flip (reference: fluid/layers/nn.py reverse)."""
    return flip(x, axis)
