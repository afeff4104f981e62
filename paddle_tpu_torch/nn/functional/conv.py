"""Convolutions and their transposes (paddle_tpu/nn/functional.py:261-457
and :1352-1363), on ATen's convolution (cuDNN on the card).

Padding takes Paddle's forms: an int, one int per spatial axis, a (low,
high) pair per axis, the flat ``[top, bottom, left, right]`` list, or
"SAME"/"VALID". "SAME" is XLA's (the odd pad on the high side, any
stride), and every asymmetric case pads the input explicitly, since ATen
pads both sides alike. Channels-last inputs (``data_format`` NLC, NHWC,
NDHWC) are convolved as channels-first views. A float32 convolution is
IEEE float32 on the card, forward and backward, whatever
``torch.backends.cudnn.allow_tf32`` says: the flag is cleared around the
port's own calls only (the ``ieee_convolution`` custom op and its
backward, which a captured program keeps), as the port's float32
products are full float32 already.
"""
import contextlib
from typing import List, Tuple

import torch

from ...amp.auto_cast import cast_inputs
from .common import _pair


def _norm_padding(padding, nd):
    """Paddle's padding forms -> "SAME"/"VALID", nd ints, or nd pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return (int(padding),) * nd
    flat = [tuple(int(v) for v in p) if isinstance(p, (list, tuple)) else int(p)
            for p in padding]
    if len(flat) == 2 * nd and all(isinstance(p, int) for p in flat):
        return tuple((flat[2 * i], flat[2 * i + 1]) for i in range(nd))
    return tuple(flat)


def _pairs(pads):
    return [(p, p) if isinstance(p, int) else tuple(p) for p in pads]


def _same_pads(sizes, ksize, stride, dilation):
    """XLA's SAME: out = ceil(in / stride), the odd pad on the high side."""
    pads = []
    for i, k, s, d in zip(sizes, ksize, stride, dilation):
        out = -(-i // s)
        total = max((out - 1) * s + d * (k - 1) + 1 - i, 0)
        pads.append((total // 2, total - total // 2))
    return pads


@contextlib.contextmanager
def _ieee_f32(t):
    """cuDNN's TF32 switched off around a float32 convolution on the card,
    and set back after."""
    if t.is_cuda and t.dtype == torch.float32:
        prev = torch._C._get_cudnn_allow_tf32()
        torch._C._set_cudnn_allow_tf32(False)
        try:
            yield
        finally:
            torch._C._set_cudnn_allow_tf32(prev)
    else:
        yield


@torch.library.custom_op("paddle_tpu_torch::ieee_convolution", mutates_args=())
def _ieee_convolution(x: torch.Tensor, w: torch.Tensor, stride: List[int], padding: List[int],
                      dilation: List[int], transposed: bool, output_padding: List[int],
                      groups: int) -> torch.Tensor:
    """ATen's convolution under ``_ieee_f32``, as a custom op: a program
    captured by torch.export (to_static, jit.save) keeps the cleared TF32
    flag, which a Python context manager around an inlined call would
    not."""
    with _ieee_f32(x):
        return torch.ops.aten.convolution(x, w, None, stride, padding, dilation, transposed,
                                          output_padding, groups)


@_ieee_convolution.register_fake
def _(x, w, stride, padding, dilation, transposed, output_padding, groups):
    return torch.ops.aten.convolution(x, w, None, stride, padding, dilation, transposed,
                                      output_padding, groups)


@torch.library.custom_op("paddle_tpu_torch::ieee_convolution_backward", mutates_args=())
def _ieee_convolution_backward(grad: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                               stride: List[int], padding: List[int], dilation: List[int],
                               transposed: bool, output_padding: List[int], groups: int,
                               mask: List[bool]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The input and weight gradients under ``_ieee_f32``; one not asked
    for (``mask``) comes back empty."""
    with _ieee_f32(x):
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad.contiguous(), x, w, None, stride, padding, dilation, transposed,
            output_padding, groups, (mask[0], mask[1], False))
    return (gx if mask[0] else x.new_empty(0)), (gw if mask[1] else w.new_empty(0))


@_ieee_convolution_backward.register_fake
def _(grad, x, w, stride, padding, dilation, transposed, output_padding, groups, mask):
    gx, gw, _ = torch.ops.aten.convolution_backward(
        grad.contiguous(), x, w, None, stride, padding, dilation, transposed, output_padding,
        groups, (mask[0], mask[1], False))
    return (gx if mask[0] else x.new_empty(0)), (gw if mask[1] else w.new_empty(0))


def _conv_setup(ctx, inputs, output):
    x, w = inputs[0], inputs[1]
    ctx.save_for_backward(x, w)
    ctx.conf = tuple(inputs[2:])


def _conv_backward(ctx, grad):
    x, w = ctx.saved_tensors
    mask = [bool(ctx.needs_input_grad[0]), bool(ctx.needs_input_grad[1])]
    gx, gw = _ieee_convolution_backward(grad, x, w, *ctx.conf, mask)
    return ((gx if mask[0] else None), (gw if mask[1] else None),
            None, None, None, None, None, None)


_ieee_convolution.register_autograd(_conv_backward, setup_context=_conv_setup)


def _conv(x, w, stride, padding, dilation, transposed, output_padding, groups):
    return _ieee_convolution(x, w, list(stride), list(padding), list(dilation),
                             bool(transposed), list(output_padding), int(groups))


def _chan_first(data_format):
    return data_format in ("NCHW", "NCL", "NCDHW")


def _add_bias(y, b, nd):
    if b is None:
        return y
    return y + b.reshape((1, -1) + (1,) * nd)


def _conv_nd(name, x, weight, bias, stride, padding, dilation, groups, data_format, nd):
    x, weight, bias = cast_inputs(name, x, weight, bias)
    chan_first = _chan_first(data_format)
    if not chan_first:
        x = x.movedim(-1, 1)
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    pad = _norm_padding(padding, nd)
    ksize = tuple(weight.shape[2:])
    if pad == "VALID":
        pad = ((0, 0),) * nd
    elif pad == "SAME":
        pad = _same_pads(x.shape[2:], ksize, stride, dilation)
    pad = _pairs(pad)
    if all(lo == hi for lo, hi in pad):
        sym = [lo for lo, _ in pad]
    else:
        flat = [v for lo, hi in reversed(pad) for v in (lo, hi)]
        x = torch.nn.functional.pad(x, flat)
        sym = [0] * nd
    y = _add_bias(_conv(x, weight, stride, sym, dilation, False, (0,) * nd, groups), bias, nd)
    return y if chan_first else y.movedim(1, -1)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd("conv1d", x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """Weight [out, in / groups, kh, kw]."""
    return _conv_nd("conv2d", x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd("conv3d", x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3)


def _transpose_padding(padding, nd):
    pad = _norm_padding(padding, nd)
    if isinstance(pad, str):
        if pad != "VALID":
            raise NotImplementedError(
                f"string padding {padding!r} for conv transpose (SAME is ambiguous for "
                "transposed convs; pass explicit ints)")
        pad = ((0, 0),) * nd
    return _pairs(pad)


def _resolve_output_padding(x, weight, output_size, output_padding, stride, pads,
                            dilation, nd, data_format):
    """output_padding from a requested output_size: op = out - ((i - 1) s -
    lo - hi + d (k - 1) + 1), valid when 0 <= op < stride."""
    if output_size is None:
        return _pair(output_padding, nd)
    sizes = list(output_size)[-nd:]
    xs = x.shape[2:2 + nd] if _chan_first(data_format) else x.shape[1:1 + nd]
    ks = weight.shape[2:2 + nd]
    ops = []
    for i in range(nd):
        lo, hi = pads[i]
        base = (xs[i] - 1) * stride[i] - lo - hi + dilation[i] * (ks[i] - 1) + 1
        op = int(sizes[i]) - base
        if not 0 <= op < stride[i]:
            raise ValueError(f"output_size[{i}]={sizes[i]} unreachable: base {base}, "
                             f"stride {stride[i]} (need base <= size < base+stride)")
        ops.append(op)
    return tuple(ops)


def _conv_transpose_nd(name, x, weight, bias, stride, padding, output_padding, dilation,
                       groups, output_size, data_format, nd):
    """Weight [in, out / groups, *k]; output (i - 1) s - lo - hi + d (k - 1)
    + 1 + output_padding per axis, the output_padding cells on the high side
    holding the bias only."""
    x, weight, bias = cast_inputs(name, x, weight, bias)
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    pads = _transpose_padding(padding, nd)
    out_pad = _resolve_output_padding(x, weight, output_size, output_padding, stride, pads,
                                      dilation, nd, data_format)
    chan_first = _chan_first(data_format)
    if not chan_first:
        x = x.movedim(-1, 1)
    # the whole transposed output, cut to the asked pads (ATen pads both
    # sides alike), widened by zeros where output_padding passes its end
    y = _conv(x, weight, stride, (0,) * nd, dilation, True, (0,) * nd, groups)
    for i, ((lo, hi), op) in enumerate(zip(pads, out_pad)):
        full = y.shape[2 + i]
        y = y.narrow(2 + i, lo, max(min(full - hi + op, full) - lo, 0))
        if op > hi:
            shape = list(y.shape)
            shape[2 + i] = op - hi
            y = torch.cat([y, y.new_zeros(shape)], dim=2 + i)
    y = _add_bias(y, bias, nd)
    return y if chan_first else y.movedim(1, -1)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd("conv1d_transpose", x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size, data_format, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1, output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd("conv2d_transpose", x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size, data_format, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd("conv3d_transpose", x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size, data_format, 3)
