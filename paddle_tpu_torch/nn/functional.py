"""The functional ops of the BERT serving path (counterpart of the
matching entries of paddle_tpu/nn/functional.py)."""
import math

import torch

from ..ops import attention as attn_ops


def relu(x):
    return torch.relu(x)


def gelu(x):
    """Exact (erf) GELU, the JAX package's ``approximate=False`` default."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def tanh(x):
    return torch.tanh(x)


def linear(x, weight, bias=None):
    """y = x W + b with W [in, out] (Paddle's layout)."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(x, weight, padding_idx=None):
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def dropout(x, p=0.5, training=True):
    """Inference form only: identity outside training (or at p = 0).
    Training-mode dropout needs the threefry key stream, which arrives
    with the training slice."""
    if not training or p == 0.0:
        return x
    raise NotImplementedError(
        "dropout in training mode arrives with the BERT training slice; "
        "call eval() on the model to serve it")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
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


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True):
    """Layout [batch, heads, seq, head_dim]; unmasked calls run the flash
    kernel (ops/attention.py)."""
    return attn_ops.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training)
