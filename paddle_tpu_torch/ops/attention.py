"""Scaled-dot-product attention dispatch (counterpart of
paddle_tpu/ops/attention.py).

An unmasked call goes to the flash kernels (ops/flash_attention.py): on a
CUDA tensor that is always the hand-written kernels, on a CPU tensor their
plain versions. A masked call runs ``_sdpa_ref``. In training mode with
``dropout_p > 0`` one key is taken from the key stream before dispatch, as
the reference does: the kernels drop by their counter hash seeded with the
key's last word, ``_sdpa_ref`` by ``fast_keep_mask`` over the whole
[batch, heads, q, k] keyed by both words. Under auto_cast the inputs take
the dtype of the op that runs ("flash_attention" or "sdpa").

The JAX package's sequence-length gate (``pallas_attention_min_seq``, a
TPU measurement) and its warn-and-fall-back on a kernel failure are not
carried over: an H100 gate is a later measurement, and a kernel failure
raises.
"""
import math

import torch

from .. import tensor as pt
from ..amp.auto_cast import cast_inputs
from ..core import random as random_core
from . import flash_attention


def _sdpa_ref(q, k, v, mask, key=None, *, scale, dropout_p=0.0, is_causal):
    """Plain attention on [batch, heads, seq, head_dim]: bool/int masks
    keep where true, float masks add; softmax in float32; dropout by
    ``fast_keep_mask(key)`` on the probabilities."""
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
    if dropout_p > 0.0 and key is not None:
        keep = random_core.fast_keep_mask(key, 1.0 - dropout_p, probs.shape, probs.device)
        probs = torch.where(keep, pt.divide_by_scalar(probs, 1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True):
    """q, k, v: [batch, heads, seq, head_dim]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = float(dropout_p) if training else 0.0
    key = random_core.next_key() if p > 0.0 else None
    if attn_mask is None:
        q, k, v = cast_inputs("flash_attention", q, k, v)
        # the kernels' dropout seed is the key's last word
        return flash_attention.mha(q, k, v, scale=scale, causal=is_causal, dropout_p=p,
                                   seed=None if key is None else random_core.key_data(key)[-1])
    q, k, v, attn_mask = cast_inputs("sdpa", q, k, v, attn_mask)
    return _sdpa_ref(q, k, v, attn_mask, key, scale=scale, dropout_p=p,
                     is_causal=bool(is_causal))
