"""Normalisations (paddle_tpu/nn/functional.py:626-780).

``batch_norm`` in training normalises by the batch's mean and biased
variance (ATen's ``native_batch_norm``, handed no running buffers) and
updates the running buffers in place as the reference does:
``running = momentum * running + (1 - momentum) * batch``, with the
biased variance (jnp.var), ``momentum`` 0.9 by default (torch's momentum
is the other way round, and its running variance is the unbiased one).
The batch variance is read back from the kernel's saved inverse standard
deviation. Under auto_cast its inputs are float32 (``batch_norm_train``
and ``batch_norm_infer`` are on the black list).

Inside ``global_batch_stats(sum_fn, ranks)`` (the training step over a
data mesh, distributed/spmd.py) each rank holds an equal part of the
global batch, and training-mode batch norm takes the global batch's
statistics, as the reference's one program over the mesh does: mean =
``sum_fn(sum x) / n``, var = ``sum_fn(sum (x - mean)**2) / n`` (jnp.var's
two passes) over the ``n`` rows of all ``ranks`` ranks, ``sum_fn`` a sum
over the ranks that the backward differentiates through; then the
reference's ``(x - mean) * rsqrt(var + eps) * w + b`` and its running
update.
"""
import contextlib
import contextvars

import torch

from ...amp.auto_cast import cast_inputs

# (sum over the ranks, number of ranks) inside global_batch_stats
_GLOBAL_STATS = contextvars.ContextVar("global_batch_stats", default=None)


@contextlib.contextmanager
def global_batch_stats(sum_fn, ranks):
    """Training-mode batch norm takes the statistics of the batch of all
    ``ranks`` ranks (module docstring)."""
    token = _GLOBAL_STATS.set((sum_fn, int(ranks)))
    try:
        yield
    finally:
        _GLOBAL_STATS.reset(token)


def _global_batch_norm(xc, weight, bias, epsilon, sum_fn, ranks):
    """[N, C, ...] -> (y, mean, var) over the global batch."""
    dims = [0] + list(range(2, xc.dim()))
    shape = (1, -1) + (1,) * (xc.dim() - 2)
    n = (xc.numel() // xc.shape[1]) * ranks
    mean = sum_fn(xc.sum(dims)) / n
    d = xc - mean.reshape(shape)
    var = sum_fn(torch.square(d).sum(dims)) / n
    y = d * torch.rsqrt(var.reshape(shape) + epsilon)
    return _affine(y, weight, bias), mean, var


def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None,
               name=None):
    ax = _channel_axis(x, data_format)
    use_batch = training and not (use_global_stats or False)
    if not use_batch:
        x, running_mean, running_var, weight, bias = cast_inputs(
            "batch_norm_infer", x, running_mean, running_var, weight, bias)
        xc = x.movedim(ax, 1) if ax != 1 else x
        y = torch.nn.functional.batch_norm(xc, running_mean, running_var, weight, bias,
                                           training=False, eps=float(epsilon))
        return y.movedim(1, ax) if ax != 1 else y
    x, weight, bias = cast_inputs("batch_norm_train", x, weight, bias)
    xc = x.movedim(ax, 1) if ax != 1 else x
    sync = _GLOBAL_STATS.get()
    if sync is not None:
        y, mean, var = _global_batch_norm(xc, weight, bias, float(epsilon), *sync)
        var = var.detach()
    else:
        y, mean, invstd = torch.native_batch_norm(xc, weight, bias, None, None, True, 0.0,
                                                  float(epsilon))
        var = None
    if running_mean is not None:
        m = float(momentum)
        with torch.no_grad():
            if var is None:
                var = invstd.detach().pow(-2) - float(epsilon)
            running_mean.mul_(m).add_((1 - m) * mean.detach().to(running_mean.dtype))
            running_var.mul_(m).add_((1 - m) * var.to(running_var.dtype))
    return y.movedim(1, ax) if ax != 1 else y


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def _affine(y, weight, bias):
    shape = (1, -1) + (1,) * (y.dim() - 2)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW",
                  name=None):
    """Each sample's and channel's own statistics; the running buffers are
    not read or written, as in the reference."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    dims = tuple(range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return _affine((x - mean) * torch.rsqrt(var + eps), weight, bias)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, int(num_groups), c // int(num_groups)) + tuple(x.shape[2:]))
    dims = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=dims, keepdim=True)
    var = (xg - mean).square().mean(dim=dims, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(y, weight, bias)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                        name=None):
    """x / (k + alpha * mean of the squares over ``size`` channels) ** beta
    (the window zero-padded, its divisor ``size``)."""
    (x,) = cast_inputs("lrn", x)
    half = size // 2
    sq = torch.nn.functional.pad(x.square().movedim(1, -1), (half, size - half - 1))
    s = sq.unfold(-1, size, 1).sum(-1).movedim(-1, 1)
    return x / torch.pow(k + alpha * s / size, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    (x,) = cast_inputs("normalize", x)
    norm = torch.pow(torch.pow(torch.abs(x), p).sum(dim=axis, keepdim=True), 1.0 / p)
    return x / torch.clamp(norm, min=epsilon)
