"""The functional ops of the BERT, Llama/GPT and seq2seq paths
(counterpart of the matching entries of paddle_tpu/nn/functional.py).
Each casts its inputs as the active auto_cast does for the reference op
of the same name (amp/auto_cast.py)."""
import math

import torch

from ..ops import torch_ops as pt
from ..amp.auto_cast import cast_inputs
from ..core import random as random_core
from ..ops import attention as attn_ops


def relu(x):
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def gelu(x):
    """Exact (erf) GELU, the JAX package's ``approximate=False`` default."""
    (x,) = cast_inputs("gelu", x)
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def silu(x):
    """x * sigmoid(x), as ``jax.nn.silu``."""
    (x,) = cast_inputs("silu", x)
    return x * torch.sigmoid(x)


def tanh(x):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def linear(x, weight, bias=None):
    """y = x W + b with W [in, out] (Paddle's layout)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(x, weight, padding_idx=None):
    (weight,) = cast_inputs("embedding", weight)
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
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


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
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


def softmax(x, axis=-1):
    (x,) = cast_inputs("softmax", x)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    (x,) = cast_inputs("log_softmax", x)
    return torch.log_softmax(x, dim=axis)


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True):
    """Softmax cross entropy over ``axis``. Hard labels equal to
    ``ignore_index`` add nothing and are left out of the mean."""
    input, weight = cast_inputs("cross_entropy", input, weight)
    logp = (torch.log_softmax(input, dim=axis) if use_softmax
            else torch.log(input.clamp_min(1e-30)))
    if soft_label:
        return _reduce_loss(-(label * logp).sum(dim=axis), reduction)
    lbl = label.long()
    if lbl.dim() == logp.dim():
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    picked = torch.take_along_dim(logp.movedim(axis, -1),
                                  lbl.clamp_min(0)[..., None], dim=-1)[..., 0]
    loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        wpc = torch.where(valid, weight[lbl.clamp_min(0)], 0.0)
        loss = loss * wpc
        if reduction == "mean":
            return loss.sum() / wpc.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    return _reduce_loss(loss, reduction)


def one_hot(x, num_classes, name=None):
    """float32 [..., num_classes] one-hot rows of integer ids ``x``; an id
    outside [0, num_classes) gives a row of zeros, as ``jax.nn.one_hot``
    in the reference (paddle_tpu/nn/functional.py:189)."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior, the prior uniform (1 / the
    last axis's size) unless ``prior_dist`` is given (paddle_tpu/nn/
    functional.py:195)."""
    (label, prior_dist) = cast_inputs("label_smooth", label, prior_dist)
    eps = float(epsilon)
    if prior_dist is None:
        return (1 - eps) * label + eps / label.shape[-1]
    return (1 - eps) * label + eps * prior_dist


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True):
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
