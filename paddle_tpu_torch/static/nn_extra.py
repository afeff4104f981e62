"""Further ``paddle.static.nn`` builders (counterpart of
paddle_tpu/static/nn_extra.py; reference: python/paddle/static/nn/ —
LayerHelper-style functions that make parameters inside the recording
program and apply the op). Each builder makes the matching ``nn`` Layer
(or its parameters) on the current place and applies it, so a recording
program sees its calls. Where the reference's op is one funnel call that
reads its input's shapes when it runs (``crf_decoding``), the port's is
recorded as one call (``program.as_one_call``).
"""
import numpy as np
import torch

from ..core.tensor import boundary
from .program import as_one_call


def embedding(input, size, is_sparse=False, is_distributed=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """reference: static/nn/common.py embedding."""
    from ..nn.layers.common import Embedding

    return Embedding(size[0], size[1], padding_idx=padding_idx, weight_attr=param_attr)(input)


def sparse_embedding(input, size, padding_idx=None, is_test=False, entry=None,
                     param_attr=None, dtype="float32"):
    """reference: fluid/contrib/sparse_embedding. In one program it is a
    dense table, as in the reference's single-program path."""
    return embedding(input, size, padding_idx=padding_idx, param_attr=param_attr, dtype=dtype)


def _check_nchw(kw, builder):
    fmt = kw.get("data_format", kw.get("data_layout", "NCHW"))
    if fmt not in ("NCHW", "NCDHW", "NCL"):
        raise NotImplementedError(
            f"{builder}: data_format {fmt!r} unsupported (channel-first only, as in "
            "the reference)")


def _apply_act(out, kw):
    act = kw.get("act")
    if act:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1, param_attr=None, bias_attr=None, **kw):
    from ..nn.layers.conv import Conv2DTranspose

    _check_nchw(kw, "conv2d_transpose")
    layer = Conv2DTranspose(input.shape[1], num_filters, filter_size, stride, padding,
                            output_padding, dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr)
    return _apply_act(layer(input), kw)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, **kw):
    from ..nn.layers.conv import Conv3D

    _check_nchw(kw, "conv3d")
    layer = Conv3D(input.shape[1], num_filters, filter_size, stride, padding, dilation, groups,
                   weight_attr=param_attr, bias_attr=bias_attr)
    return _apply_act(layer(input), kw)


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1, param_attr=None, bias_attr=None, **kw):
    from ..nn.layers.conv import Conv3DTranspose

    _check_nchw(kw, "conv3d_transpose")
    layer = Conv3DTranspose(input.shape[1], num_filters, filter_size, stride, padding,
                            output_padding, dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr)
    return _apply_act(layer(input), kw)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, **kw):
    from ..nn.layers.norm import LayerNorm

    layer = LayerNorm(list(input.shape[begin_norm_axis:]), epsilon=epsilon,
                      weight_attr=False if not scale else param_attr,
                      bias_attr=False if not shift else bias_attr)
    return layer(input)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", **kw):
    from ..nn.layers.norm import GroupNorm

    _check_nchw({"data_layout": data_layout}, "group_norm")
    layer = GroupNorm(groups, input.shape[1], epsilon=epsilon, weight_attr=param_attr,
                      bias_attr=bias_attr)
    return layer(input)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None, **kw):
    from ..nn.layers.norm import InstanceNorm2D

    layer = InstanceNorm2D(input.shape[1], epsilon=epsilon, weight_attr=param_attr,
                           bias_attr=bias_attr)
    return layer(input)


@boundary
def _prelu_element(x, a):
    return torch.where(x >= 0, x, a[None] * x)


def prelu(x, mode="all", param_attr=None, **kw):
    """reference: static/nn/common.py prelu (mode all/channel/element,
    slopes 0.25)."""
    from ..nn import functional as F
    from ..tensor import creation

    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [x.shape[1]]
    elif mode == "element":
        shape = list(x.shape[1:])
    else:
        raise ValueError(f"prelu mode must be all/channel/element, got {mode!r}")
    alpha = creation.create_parameter(shape, "float32")
    alpha.set_value(np.full(shape, 0.25, np.float32))
    if mode == "element":
        return _prelu_element(x, alpha)
    return F.prelu(x, alpha)


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None, **kw):
    """reference: fluid/layers/nn.py bilinear_tensor_product."""
    from ..nn import functional as F
    from ..tensor import creation

    w = creation.create_parameter([size, x.shape[-1], y.shape[-1]], "float32")
    b = creation.create_parameter([size], "float32", is_bias=True)
    return F.bilinear(x, y, w, b)


@boundary
def _data_norm(x, n, s, sq):
    # reference data_norm_op.cc:302: mean = sum / size, scale =
    # sqrt(size / square_sum); the square sum is pre-seeded, so the op
    # subtracts no mean from it
    return (x - s / n) * torch.sqrt(n / sq)


def data_norm(input, epsilon=1e-5, param_attr=None, **kw):
    """reference: fluid/layers/nn.py data_norm — normalize by the
    accumulated statistics (batch size, sum, square sum), which are
    constants of the program, not trainable weights."""
    from ..core.tensor import plain

    d = input.shape[-1]
    dev = plain(input).device
    size = torch.full([d], 1e4, dtype=torch.float32, device=dev)
    ssum = torch.zeros([d], dtype=torch.float32, device=dev)
    sqsum = torch.full([d], 1e4, dtype=torch.float32, device=dev)
    return _data_norm(input, size, ssum, sqsum)


@boundary
def _row_conv(x, w):
    t = x.shape[-2]
    out = torch.zeros_like(x)
    for k in range(w.shape[0]):
        out[..., :t - k, :] = out[..., :t - k, :] + x[..., k:t, :] * w[k]
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """reference: operators/row_conv_op.cc — lookahead convolution over
    the time dim: out[t] = sum_{k=0..K} w[k] * x[t+k]."""
    from ..tensor import creation

    w = creation.create_parameter([int(future_context_size) + 1, input.shape[-1]], "float32")
    return _apply_act(_row_conv(input, w), {"act": act})


@boundary
@as_one_call
def _viterbi(unary, trans, lens):
    n = unary.shape[-1]
    b, t = unary.shape[0], unary.shape[1]
    if lens is None:
        # from the shape at run time: a placeholder's build-time dims
        # would freeze every step of a [-1, -1, N] program
        lens = torch.full((b,), t, dtype=torch.int64, device=unary.device)
    # paddle layout [N+2, N] (crf_decoding_op.h): row 0 start weights,
    # row 1 stop weights, rows 2.. pairwise; a bare [N, N] is pairwise
    if trans.shape[0] == n + 2:
        start, stop, pair = trans[0], trans[1], trans[2:]
    else:
        start = torch.zeros(n, dtype=unary.dtype, device=unary.device)
        stop = torch.zeros(n, dtype=unary.dtype, device=unary.device)
        pair = trans[:n, :n]
    ident = torch.arange(n, device=unary.device)[None, :].expand(b, n)
    score = unary[:, 0] + start[None, :]
    backs = []
    for step in range(1, t):
        cand = score[:, :, None] + pair[None, :, :]  # [B, from, to]
        best, back = torch.max(cand, dim=1)
        live = (step < lens)[:, None]
        # a finished sample keeps its score and points to itself, so the
        # backtrack walks its final tag through the padding
        score = torch.where(live, best + unary[:, step], score)
        backs.append(torch.where(live, back, ident))
    tag = torch.argmax(score + stop[None, :], dim=-1)
    path = [tag]
    for back in reversed(backs):
        tag = torch.gather(back, 1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1).to(torch.int32)


def crf_decoding(potentials, transition_params=None, lengths=None, **kw):
    """Viterbi decode of linear-chain CRF unary potentials (reference:
    operators/crf_decoding_op.h): the argmax tag path [B, T]. With
    per-sample ``lengths`` the steps past each length are frozen (stop
    weights apply at the true last step; the padding repeats the final
    tag)."""
    if transition_params is None:
        raise ValueError("crf_decoding needs transition_params [N+2, N] or [N, N]")
    return _viterbi(potentials, transition_params, lengths)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1, padding=0, dilation=1,
                  groups=1, deformable_groups=1, im2col_step=1, weight_attr=None,
                  bias_attr=None, name=None):
    """reference: static/nn/common.py:168 deform_conv2d: v1 (``mask`` None)
    or v2, its weight [num_filters, C / groups, kh, kw] (and bias) made on
    the current place, the op ``vision.ops.deform_conv2d`` (no im2col
    scratch, so ``im2col_step`` is moot)."""
    from ..tensor import creation
    from ..vision.ops import deform_conv2d as _dc

    ks = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size, filter_size)
    w = creation.create_parameter([num_filters, x.shape[1] // groups, ks[0], ks[1]], "float32",
                                  attr=weight_attr)
    b = None
    if bias_attr is not False:
        b = creation.create_parameter([num_filters], "float32", attr=bias_attr, is_bias=True)
    return _dc(x, offset, w, bias=b, stride=stride, padding=padding, dilation=dilation,
               deformable_groups=deformable_groups, groups=groups, mask=mask)


def multi_box_head(*args, **kwargs):
    raise NotImplementedError(
        "multi_box_head: compose prior_box/density_prior_box + conv2d heads directly, as "
        "in the reference")


@boundary
def _nce(x, lab, negs, sw, dist_arr, w, b, n, k, num_true, samp):
    lab = lab.reshape(lab.shape[0], -1)
    sl = torch.cat([lab.to(torch.int64), negs.to(torch.int64)], dim=1)
    logits = torch.einsum("bd,bsd->bs", x, w[sl]) + b[sl]
    o = torch.sigmoid(logits)
    if samp == "uniform":
        q = torch.full(sl.shape, 1.0 / n, dtype=x.dtype, device=x.device)
    elif samp == "log_uniform":
        q = torch.log((sl + 2.0) / (sl + 1.0)) / float(np.log(float(n)))
    else:
        q = dist_arr[sl]
    big = q * k
    is_true = torch.arange(sl.shape[1], device=x.device) < num_true
    cost = torch.where(is_true[None, :], -torch.log(o / (o + big)),
                       -torch.log(big / (o + big)))
    out = cost.sum(dim=1, keepdim=True)
    if sw is not None:
        out = out * sw.reshape(-1, 1)
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None, bias_attr=None,
        num_neg_samples=None, name=None, sampler="uniform", custom_dist=None, seed=0,
        is_sparse=False):
    """Noise-contrastive estimation loss (reference: fluid/layers/loss.py
    nce, operators/nce_op.h): per row, sigmoid logits o for the true
    labels and ``num_neg_samples`` noise classes drawn on the host at
    build time (numpy ``RandomState(seed)``, constants of the program);
    cost = -log(o/(o+B)) for true, -log(B/(o+B)) for noise, B = q(class) *
    num_neg. Returns [B, 1]."""
    from ..core.tensor import plain
    from ..tensor import creation

    dim = input.shape[-1]
    n = int(num_total_classes)
    k = 10 if num_neg_samples is None else int(num_neg_samples)
    num_true = label.shape[1] if len(label.shape) > 1 else 1
    bsz = input.shape[0]
    w = creation.create_parameter([n, dim], "float32", attr=param_attr)
    b = creation.create_parameter([n], "float32", attr=bias_attr, is_bias=True)
    rng = np.random.RandomState(seed if seed else None)
    if sampler == "uniform":
        negs = rng.randint(0, n, size=(bsz, k))
    elif sampler == "log_uniform":
        # inverse-transform sampling of f(x) ~ 1/((x+1) ln(range+1))
        # (reference math/sampler.cc LogUniformSampler::Sample)
        u = rng.rand(bsz, k)
        negs = (np.exp(u * np.log(n)).astype(np.int64) - 1) % n
    elif sampler == "custom_dist":
        p = np.asarray(custom_dist, np.float64)
        negs = rng.choice(n, size=(bsz, k), p=p / p.sum())
    else:
        raise ValueError(f"sampler must be uniform/log_uniform/custom_dist, got {sampler!r}")
    dev = plain(input).device
    negs_t = torch.as_tensor(np.asarray(negs, np.int64), device=dev)
    dist_t = (None if sampler != "custom_dist"
              else torch.as_tensor(np.asarray(custom_dist, np.float32), device=dev))
    return _nce(input, label, negs_t, sample_weight, dist_t, w, b, n, k, int(num_true),
                sampler)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Static spectral_norm (reference: fluid/layers/nn.py:3631) through
    ``nn.SpectralNorm``."""
    from ..nn.layers.norm import SpectralNorm

    layer = SpectralNorm(list(weight.shape), dim=dim, power_iters=power_iters, eps=eps)
    return layer(weight)
