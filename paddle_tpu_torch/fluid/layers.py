"""fluid.layers (counterpart of paddle_tpu/fluid/layers.py; reference:
python/paddle/fluid/layers/, the 1.x functional namespace): aliases of
``static.nn``'s builders and of the 2.0 tensor and functional ops, which
share their semantics."""
from ..nn import functional as _F
from ..static import data  # noqa: F401
from ..static import nn as _static_nn
from ..static.compat import Print, create_global_var, py_func  # noqa: F401
from ..static.nn_control_flow import case, cond, switch_case, while_loop  # noqa: F401
from ..tensor import (  # noqa: F401
    abs, arange, argmax, argmin, argsort, assign, cast, ceil, clip,
    concat, cos, cumsum, exp, expand_as, eye, flatten,
    floor, gather, gather_nd, increment, linspace, log, matmul, mean,
    ones, ones_like, pow, reshape, scale,
    scatter, shape, sign, sin, slice, split, sqrt, square, squeeze,
    stack, sum, tanh, topk, transpose, unsqueeze, where, zeros,
    zeros_like,
)
from ..tensor.manipulation import crop_tensor, reverse  # noqa: F401


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    """reference: fluid/layers/tensor.py fill_constant -> paddle.full."""
    from ..tensor.creation import full

    return full(shape, value, dtype=dtype)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    from .. import tensor as pt

    return pt.all(input, axis=dim, keepdim=keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    from .. import tensor as pt

    return pt.any(input, axis=dim, keepdim=keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    from .. import tensor as pt

    return pt.mean(input, axis=dim, keepdim=keep_dim)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    from .. import tensor as pt

    return pt.sum(input, axis=dim, keepdim=keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    from .. import tensor as pt

    return pt.max(input, axis=dim, keepdim=keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    from .. import tensor as pt

    return pt.min(input, axis=dim, keepdim=keep_dim)


# static.nn builders double as fluid.layers builders
fc = _static_nn.fc
conv2d = _static_nn.conv2d
batch_norm = _static_nn.batch_norm


def embedding(input, size, is_sparse=False, is_distributed=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """Legacy builder (reference: fluid/layers/nn.py embedding): the
    [vocab, dim] table and its lookup."""
    from ..nn.layers.common import Embedding as _Embedding

    return _Embedding(size[0], size[1], padding_idx=padding_idx, weight_attr=param_attr)(input)


# functional aliases (fluid.layers.<act> == F.<act>)
relu = _F.relu
sigmoid = _F.sigmoid
softmax = _F.softmax
log_softmax = _F.log_softmax
gelu = _F.gelu
leaky_relu = _F.leaky_relu
elu = _F.elu
dropout = _F.dropout
cross_entropy = _F.cross_entropy
softmax_with_cross_entropy = _F.softmax_with_cross_entropy
mse_loss = _F.mse_loss
one_hot = _F.one_hot
label_smooth = _F.label_smooth
conv2d_transpose = _F.conv2d_transpose
dice_loss = _F.dice_loss
log_loss = _F.log_loss


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None, exclusive=True,
           data_format="NCHW"):
    """Legacy pooling (reference: fluid/layers/nn.py pool2d)."""
    if pool_type not in ("max", "avg"):
        raise ValueError(f"pool_type must be 'max' or 'avg', got {pool_type!r}")
    if global_pooling:
        hw = input.shape[2:] if data_format == "NCHW" else input.shape[1:3]
        pool_size, pool_stride, pool_padding = list(hw), list(hw), 0
    if pool_type == "max":
        return _F.max_pool2d(input, pool_size, pool_stride, pool_padding, ceil_mode=ceil_mode,
                             data_format=data_format)
    return _F.avg_pool2d(input, pool_size, pool_stride, pool_padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=data_format)
