"""Scaled-dot-product attention dispatch (counterpart of
paddle_tpu/ops/attention.py).

An unmasked call goes to the flash kernel (ops/flash_attention.py): on a
CUDA tensor that is always the hand-written kernel, on a CPU tensor its
plain version. A masked call runs ``_sdpa_ref``. The JAX package's
sequence-length gate (``pallas_attention_min_seq``, a TPU measurement)
and its warn-and-fall-back on a kernel failure are not carried over: an
H100 gate is a later measurement, and a kernel failure raises.
"""
import math

import torch

from . import flash_attention


def _sdpa_ref(q, k, v, mask, *, scale, is_causal):
    """Plain attention on [batch, heads, seq, head_dim]: bool/int masks
    keep where true, float masks add; softmax in float32."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    neg = torch.finfo(logits.dtype).min
    if is_causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((s_q, s_k), dtype=torch.bool,
                            device=q.device).tril(s_k - s_q)
        logits = torch.where(causal, logits, neg)
    if mask is not None:
        if not mask.dtype.is_floating_point:
            logits = torch.where(mask.to(torch.bool), logits, neg)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True):
    """q, k, v: [batch, heads, seq, head_dim]."""
    p = float(dropout_p) if training else 0.0
    if p > 0.0:
        raise NotImplementedError(
            "attention dropout in training mode arrives with the BERT "
            "training slice (the threefry key stream that seeds it); call "
            "eval() on the model to serve it")
    scale = 1.0 / math.sqrt(q.shape[-1])
    if attn_mask is None:
        return flash_attention.mha(q, k, v, scale=scale, causal=is_causal)
    return _sdpa_ref(q, k, v, attn_mask, scale=scale, is_causal=bool(is_causal))
