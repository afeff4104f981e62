"""Linear, embedding, dropout, resampling and the other common ops
(paddle_tpu/nn/functional.py:159-258 and :965-1211). Each casts its inputs
as the active auto_cast does for the reference op of the same name."""
import math

import numpy as np
import torch

from ...amp.auto_cast import cast_inputs
from ...core import random as random_core
from ...core.tensor import plain
from ...ops import attention as attn_ops
from ...ops import torch_ops as pt


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


# ------------------------------------------------------ linear / embedding


def linear(x, weight, bias=None, name=None):
    """y = x W + b with W [in, out] (Paddle's layout)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """``sparse`` is accepted for the API; the lookup is dense, as in the
    reference."""
    (weight,) = cast_inputs("embedding", weight)
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def one_hot(x, num_classes, name=None):
    """float32 [..., num_classes] one-hot rows of integer ids ``x``; an id
    outside [0, num_classes) gives a row of zeros, as ``jax.nn.one_hot``."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior, the prior uniform (1 / the
    last axis's size) unless ``prior_dist`` is given."""
    (label, prior_dist) = cast_inputs("label_smooth", label, prior_dist)
    eps = float(epsilon)
    if prior_dist is None:
        return (1 - eps) * label + eps / label.shape[-1]
    return (1 - eps) * label + eps * prior_dist


# ------------------------------------------------------------ dropout


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    """Dropout by the counter-hash ``fast_keep_mask``, keyed by one key of
    the key stream (taken only when ``training and p > 0``, as in the
    reference). ``axis`` shares one mask along the other axes."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and p > 0.0:
            (x,) = cast_inputs("dropout_infer_downscale", x)
            return x * (1.0 - float(p))
        return x
    key = random_core.next_key()
    (x,) = cast_inputs("dropout", x)
    shape = x.shape
    if axis is not None:
        axes = {a % x.dim() for a in ([axis] if isinstance(axis, int) else axis)}
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = random_core.fast_keep_mask(key, 1.0 - p, shape, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, pt.divide_by_scalar(x, 1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """One mask entry per (sample, channel)."""
    return dropout(x, p, axis=(0, 1) if data_format == "NCHW" else (0, 3),
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p, axis=(0, 1) if data_format == "NCDHW" else (0, 4),
                   training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout; the mask is jax.random.bernoulli's (bitwise)
    under one key of the key stream."""
    if not training or p == 0.0:
        return x
    key = random_core.next_key()
    (x,) = cast_inputs("alpha_dropout", x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = random_core.uniform(key, tuple(x.shape), device=x.device) < float(
        np.float32(1.0 - p))
    a = (1.0 / math.sqrt((alpha_p ** 2 * p + 1) * (1 - p))) if p < 1 else 0.0
    b = -a * alpha_p * p
    return a * torch.where(keep, x, alpha_p) + b


# ------------------------------------------------------------ attention


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, name=None):
    """Layout [batch, heads, seq, head_dim]; unmasked calls run the flash
    kernels (ops/attention.py)."""
    return attn_ops.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training)


def gather_tree(ids, parents):
    """Beam-search backtrack: ``ids`` and ``parents`` [T, B, beam]
    (integers); returns [T, B, beam] where each final beam's whole
    sequence is found by following its parent pointers back from step
    T - 1, on the tensors' device."""
    idx = torch.arange(ids.shape[2], device=ids.device).expand(ids.shape[1], -1)
    out = torch.empty_like(ids)
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = torch.gather(ids[t], 1, idx)
        idx = torch.gather(parents[t], 1, idx).long()
    return out


# ------------------------------------------------------------ resampling


def _resize_weights(in_size, out_size, kernel, device):
    """jax.image.resize's weight matrix [in, out] for one axis (its
    ``compute_weight_mat`` at translation 0, antialiased): half-pixel
    sample positions, the kernel widened by in/out on a downscale, each
    column normalised, samples outside the input zeroed."""
    scale = np.float32(out_size) / np.float32(in_size)
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * float(inv) - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs() / kscale
    if kernel == "cubic":
        w = ((1.5 * x - 2.5) * x) * x + 1.0
        w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
        w = torch.where(x >= 2.0, 0.0, w)
    else:
        w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                align_mode=0, data_format="NCHW", name=None):
    """2-D resize of an NCHW (or NHWC) batch: "nearest" and "bilinear" by
    the reference's own sampling (half-pixel or align-corners), "bicubic"
    and "area" as jax.image.resize's cubic and linear kernels."""
    if size is not None and scale_factor is not None:
        raise ValueError("interpolate: pass exactly one of size / scale_factor")
    if size is None and scale_factor is None:
        raise ValueError("interpolate: one of size / scale_factor is required")
    chan_first = data_format == "NCHW"
    img = x.permute(0, 2, 3, 1) if chan_first else x  # [n, h, w, c]
    h, w = img.shape[1], img.shape[2]
    if size is not None:
        oh, ow = _pair(size) if not isinstance(size, int) else (size, size)
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else (scale_factor,) * 2
        oh, ow = int(h * sf[0]), int(w * sf[1])
    (img,) = cast_inputs("interpolate", img)
    dev = img.device

    def src_pos(o, i_sz):
        pos = torch.arange(o, dtype=torch.float32, device=dev)
        if align_corners:
            return (pos * (float(i_sz - 1) / float(o - 1)) if o > 1
                    else torch.zeros(1, dtype=torch.float32, device=dev))
        return torch.clamp((pos + 0.5) * (i_sz / o) - 0.5, 0.0, float(i_sz - 1))

    if mode == "bilinear":
        si, sj = src_pos(oh, h), src_pos(ow, w)
        i0, j0 = torch.floor(si).long(), torch.floor(sj).long()
        i1, j1 = torch.clamp(i0 + 1, max=h - 1), torch.clamp(j0 + 1, max=w - 1)
        wi = (si - i0)[None, :, None, None]
        wj = (sj - j0)[None, None, :, None]
        top, bot = img[:, i0], img[:, i1]
        tl, tr, bl, br = top[:, :, j0], top[:, :, j1], bot[:, :, j0], bot[:, :, j1]
        out = (1 - wi) * ((1 - wj) * tl + wj * tr) + wi * ((1 - wj) * bl + wj * br)
    elif mode == "nearest":
        if align_corners:  # rounds half up, as the reference
            i_idx = torch.floor(src_pos(oh, h) + 0.5).long()
            j_idx = torch.floor(src_pos(ow, w) + 0.5).long()
        else:  # floor(i * in / out) in integers
            i_idx = torch.arange(oh, device=dev) * h // oh
            j_idx = torch.arange(ow, device=dev) * w // ow
        out = img[:, i_idx][:, :, j_idx]
    elif mode in ("bicubic", "area"):
        kernel = "cubic" if mode == "bicubic" else "linear"
        wh = _resize_weights(h, oh, kernel, dev).to(img.dtype)
        ww = _resize_weights(w, ow, kernel, dev).to(img.dtype)
        out = torch.einsum("nhwc,ho,wp->nopc", img, wh, ww)
    else:
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    out = out.to(x.dtype)
    return out.permute(0, 3, 1, 2) if chan_first else out


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    (x,) = cast_inputs("pixel_shuffle", x)
    r = int(upscale_factor)
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [n, c * kh * kw, blocks], channel-major as the reference's
    patches."""
    (x,) = cast_inputs("unfold", x)
    return torch.nn.functional.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                                      padding=_pair(paddings), stride=_pair(strides))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True,
                name=None):
    """Bilinear sampling of x [n, c, h, w] at ``grid`` [n, gh, gw, 2] (x, y
    in [-1, 1]), corners outside the input read as 0, as the reference
    computes it (``mode`` and ``padding_mode`` are not read there either)."""
    x, grid = cast_inputs("grid_sample", x, grid)
    n, c, h, w = x.shape
    if align_corners:
        gx = (grid[..., 0] + 1) * (w - 1) / 2
        gy = (grid[..., 1] + 1) * (h - 1) / 2
    else:
        gx = ((grid[..., 0] + 1) * w - 1) / 2
        gy = ((grid[..., 1] + 1) * h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        ixc = torch.clamp(ix, 0, w - 1).long()
        iyc = torch.clamp(iy, 0, h - 1).long()
        valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        vals = x.permute(0, 2, 3, 1)[batch, iyc, ixc]  # [n, gh, gw, c]
        return torch.where(valid[..., None], vals, 0.0)

    wa = ((x1 - gx) * (y1 - gy))[..., None]
    wb = ((x1 - gx) * (gy - y0))[..., None]
    wc = ((gx - x0) * (y1 - gy))[..., None]
    wd = ((gx - x0) * (gy - y0))[..., None]
    out = (sample(x0, y0) * wa + sample(x0, y1) * wb + sample(x1, y0) * wc
           + sample(x1, y1) * wd)
    return out.permute(0, 3, 1, 2)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The [n, h, w, 2] sampling grid of the affine maps ``theta`` [n, 2, 3]
    over an output of ``out_shape`` [n, c, h, w]."""
    (theta,) = cast_inputs("affine_grid", theta)
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    n, c, h, w = (int(s) for s in out_shape)
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev)
        xs = torch.linspace(-1, 1, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).to(theta.dtype)
    return torch.einsum("nij,hwj->nhwi", theta, base)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None, data_format="NCHW"):
    (x,) = cast_inputs("temporal_shift", x)
    nt, c, h, w = x.shape
    seg = int(seg_num)
    xr = x.reshape(nt // seg, seg, c, h, w)
    fold = int(c * shift_ratio)
    out_a = torch.cat([xr[:, 1:, :fold], torch.zeros_like(xr[:, :1, :fold])], dim=1)
    out_b = torch.cat([torch.zeros_like(xr[:, :1, fold:2 * fold]),
                       xr[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([out_a, out_b, xr[:, :, 2 * fold:]], dim=2).reshape(nt, c, h, w)


def bilinear(x1, x2, weight, bias=None, name=None):
    """[B, in1] x [out, in1, in2] x [B, in2] -> [B, out]."""
    x1, x2, weight, bias = cast_inputs("bilinear", x1, x2, weight, bias)
    y = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return y if bias is None else y + bias


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = cast_inputs("cosine_similarity", x1, x2)
    return (x1 * x2).sum(dim=axis) / torch.clamp(
        torch.linalg.vector_norm(x1, dim=axis) * torch.linalg.vector_norm(x2, dim=axis),
        min=eps)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """The ``paddle.pad`` op (tensor/manipulation.py) on torch tensors."""
    from ...tensor import manipulation

    return plain(manipulation.pad(x, pad, mode, value, data_format))


def unstack(x, axis=0, num=None):
    (x,) = cast_inputs("unstack", x)
    return list(torch.unbind(x, int(axis)))


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    """Each row of the last axis on the ``offset`` diagonal of a square
    matrix (``dim1``/``dim2`` are not read, as in the reference)."""
    (input,) = cast_inputs("diag_embed", input)
    return torch.diag_embed(input, offset=int(offset))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen] of ``arange(maxlen) < x``, in ``dtype`` as the
    reference gives it (64-bit types in their 32-bit forms)."""
    from ...core.dtype import canonicalize_dtype, convert_dtype

    if maxlen is None:
        maxlen = int(x.max())
    r = torch.arange(int(maxlen), device=x.device)
    return (r < x[..., None]).to(canonicalize_dtype(convert_dtype(dtype)))
