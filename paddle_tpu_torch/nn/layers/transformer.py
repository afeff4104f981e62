"""Transformer encoder stack and the causal mask helper (counterpart of
paddle_tpu/nn/layers/transformer.py). Attention dispatches through
F.scaled_dot_product_attention: unmasked calls run the flash kernels. The
products and residual sums go through the port's tensor ops, which cast as
auto_cast does for the reference's ops of the same name."""
import copy

import torch

from ... import tensor as pt
from ...core.place import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


def _convert_attention_mask(attn_mask, dtype=torch.float32):
    """bool/int masks -> additive float masks: true/nonzero keeps a
    position, false/0 adds -1e9. Float masks pass through (already
    additive)."""
    if attn_mask is None or attn_mask.dtype.is_floating_point:
        return attn_mask
    zero = torch.zeros((), dtype=dtype, device=attn_mask.device)
    return torch.where(attn_mask.to(torch.bool), zero, -1e9)


class MultiHeadAttention(torch.nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, *, device="cuda",
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def _fused_qkv(self, x):
        """Self-attention: one [H, 3H] product instead of three [H, H]
        ones (each output element is the same dot product)."""
        w = torch.cat([self.q_proj.weight, self.k_proj.weight,
                       self.v_proj.weight], dim=1)
        b = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias])
        return pt.add(pt.matmul(x, w), b).chunk(3, dim=-1)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        if key is query and value is key:
            q, k, v = self._fused_qkv(query)
        else:
            q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        out = F.scaled_dot_product_attention(
            self._split_heads(q), self._split_heads(k), self._split_heads(v),
            attn_mask=_convert_attention_mask(attn_mask),
            dropout_p=self.dropout, training=self.training)
        return self.out_proj(self._merge_heads(out))


class TransformerEncoderLayer(torch.nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, device="cuda", generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = pt.add(residual, self.dropout1(self.self_attn(src, src, src, src_mask)))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self.activation)
        src = self.linear2(self.dropout(act(self.linear1(src))))
        src = pt.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(torch.nn.Module):
    """``num_layers`` independent deep copies of ``encoder_layer``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [copy.deepcopy(encoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        output = src
        for mod in self.layers:
            output = mod(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


class Transformer(torch.nn.Module):
    """Only the reference's static mask helper so far: the encoder-decoder
    model itself (``TransformerDecoder``, MHA caches) is a later slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the port's Transformer has only "
                                  "generate_square_subsequent_mask so far")

    @staticmethod
    def generate_square_subsequent_mask(length, *, device="cuda"):
        """[length, length] float32 additive mask: 0 on and below the
        diagonal, -inf above it."""
        dev = resolve_device(device)
        mask = torch.full((length, length), float("-inf"), device=dev)
        return torch.triu(mask, diagonal=1)
