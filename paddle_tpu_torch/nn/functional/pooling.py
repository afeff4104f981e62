"""Pooling (paddle_tpu/nn/functional.py:460-623 and :1214-1349), on ATen's
pooling ops, with the reference's geometry:

- padding takes the conv forms (conv.py's ``_norm_padding``); an
  asymmetric or wide pad, and ``ceil_mode``, pad the input explicitly
  (-inf for max, 0 for avg) before a pool of no padding. ``ceil_mode``
  widens the high-side pad so that the last partial window counts
  (out = ceil((i + lo + hi - k) / s) + 1), which is not ATen's rule;
- ``avg_pool*`` is ``exclusive`` by default: padded cells do not count;
  ``divisor_override`` divides the window's sum instead;
- max pooling routes its gradient to the first maximum of a window (ties
  under ReLU), and ``return_mask`` gives each maximum's flat index within
  its sample's and channel's unpadded spatial plane (int32), the smaller
  index at a tie;
- adaptive bins run from floor(k i / o) to ceil((k + 1) i / o).

Channels-last inputs are pooled as channels-first views.
"""
import torch

from ...amp.auto_cast import cast_inputs
from .common import _pair
from .conv import _chan_first, _norm_padding, _pairs, _same_pads

_F = torch.nn.functional
_MAX = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}
_AVG = {1: _F.avg_pool1d, 2: _F.avg_pool2d, 3: _F.avg_pool3d}
_ADAPTIVE_AVG = {1: _F.adaptive_avg_pool1d, 2: _F.adaptive_avg_pool2d,
                 3: _F.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: _F.adaptive_max_pool1d, 2: _F.adaptive_max_pool2d,
                 3: _F.adaptive_max_pool3d}


def _geometry(x, ksize, stride, padding, ceil_mode, nd):
    """Per-axis (low, high) pads of a channels-first ``x`` (SAME as XLA's
    reduce_window pads it), and whether any cell is padding."""
    sizes = x.shape[2:]
    if padding == "SAME":
        pads = _same_pads(sizes, ksize, stride, (1,) * nd)
        return pads, any(p != (0, 0) for p in pads)
    if padding == "VALID":
        return [(0, 0)] * nd, False
    pads = _pairs(padding)
    if ceil_mode:
        pads = [(lo, hi + (-(i + lo + hi - k)) % s)
                for (lo, hi), i, k, s in zip(pads, sizes, ksize, stride)]
    return pads, any(p != (0, 0) for p in pads)


def _pad(x, pads, value):
    flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
    return _F.pad(x, flat, value=value) if any(flat) else x


def _direct(pads, ksize):
    """ATen pads both sides alike, by at most half a window."""
    return all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ksize))


def _max_pool(name, x, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format, nd):
    (x,) = cast_inputs(name, x)
    ksize = _pair(kernel_size, nd)
    stride = ksize if stride is None else _pair(stride, nd)
    chan_first = _chan_first(data_format)
    if not chan_first:
        x = x.movedim(-1, 1)
    pads, _ = _geometry(x, ksize, stride, _norm_padding(padding, nd), ceil_mode, nd)
    if _direct(pads, ksize):
        res = _MAX[nd](x, ksize, stride, [lo for lo, _ in pads], return_indices=return_mask)
    else:
        res = _MAX[nd](_pad(x, pads, float("-inf")), ksize, stride,
                       return_indices=return_mask)
    if not return_mask:
        return res if chan_first else res.movedim(1, -1)
    out, idx = res
    if not _direct(pads, ksize):  # an index of the padded plane -> of x's
        padded = [s + lo + hi for s, (lo, hi) in zip(x.shape[2:], pads)]
        flat = torch.zeros_like(idx)
        for i in range(nd):
            inner = 1
            for s in padded[i + 1:]:
                inner *= s
            coord = (idx // inner) % padded[i] - pads[i][0]
            flat = flat * x.shape[2 + i] + coord
        idx = flat
    idx = idx.to(torch.int32)
    if chan_first:
        return out, idx
    return out.movedim(1, -1), idx.movedim(1, -1)


def _avg_pool(name, x, kernel_size, stride, padding, ceil_mode, exclusive, divisor,
              data_format, nd):
    (x,) = cast_inputs(name, x)
    ksize = _pair(kernel_size, nd)
    stride = ksize if stride is None else _pair(stride, nd)
    chan_first = _chan_first(data_format)
    if not chan_first:
        x = x.movedim(-1, 1)
    pads, had_pad = _geometry(x, ksize, stride, _norm_padding(padding, nd), ceil_mode, nd)
    window = 1
    for k in ksize:
        window *= k
    # the window's mean over the zero-padded input: its sum / window
    mean = _AVG[nd](_pad(x, pads, 0.0), ksize, stride)
    if divisor is not None:
        y = mean * (window / float(divisor))
    elif exclusive and had_pad:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        y = mean / _AVG[nd](_pad(ones, pads, 0.0), ksize, stride)
    else:
        y = mean
    return y if chan_first else y.movedim(1, -1)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool("max_pool1d", x, kernel_size, stride, padding, return_mask, ceil_mode,
                     "NCL", 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool("max_pool2d", x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool("max_pool3d", x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 3)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _avg_pool("avg_pool1d", x, kernel_size, stride, padding, ceil_mode, exclusive,
                     None, "NCL", 1)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW", name=None):
    return _avg_pool("avg_pool2d", x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format, 2)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
    return _avg_pool("avg_pool3d", x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format, 3)


def _adaptive(name, x, output_size, data_format, nd, mode, return_mask=False):
    (x,) = cast_inputs(name, x)
    out = _pair(output_size, nd)
    chan_first = _chan_first(data_format)
    if not chan_first:
        x = x.movedim(-1, 1)
    if return_mask:  # the reference's masked form takes NC* inputs only
        y, idx = _ADAPTIVE_MAX[nd](x, out, return_indices=True)
        return y, idx.to(torch.int32)
    y = (_ADAPTIVE_AVG if mode == "avg" else _ADAPTIVE_MAX)[nd](x, out)
    return y if chan_first else y.movedim(1, -1)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive("adaptive_avg_pool1d", x, output_size, "NCL", 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive("adaptive_avg_pool2d", x, output_size, data_format, 2, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive("adaptive_avg_pool3d", x, output_size, data_format, 3, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive("adaptive_max_pool1d", x, output_size, "NCL", 1, "max", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive("adaptive_max_pool2d", x, output_size, "NCHW", 2, "max", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive("adaptive_max_pool3d", x, output_size, "NCDHW", 3, "max", return_mask)
