"""Transformer stack: multi-head attention with its incremental and static
caches, the encoder and decoder layers and stacks, the encoder-decoder
``Transformer`` and its causal mask helper (counterpart of
paddle_tpu/nn/layers/transformer.py). Attention dispatches through
F.scaled_dot_product_attention: unmasked calls run the flash kernels,
masked ones the plain softmax. The products and residual sums go through
the port's tensor ops, which cast as auto_cast does for the reference's
ops of the same name."""
import copy

import torch

from ...ops import torch_ops as pt
from ...amp.auto_cast import cast_inputs
from ...core.place import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm
from ..layer import Layer


def _convert_attention_mask(attn_mask, dtype=torch.float32):
    """bool/int masks -> additive float masks: true/nonzero keeps a
    position, false/0 adds -1e9. Float masks pass through (already
    additive)."""
    if attn_mask is None or attn_mask.dtype.is_floating_point:
        return attn_mask
    zero = torch.zeros((), dtype=dtype, device=attn_mask.device)
    return torch.where(attn_mask.to(torch.bool), zero, -1e9)


class MultiHeadAttention(Layer):
    """Multi-head attention over [batch, seq, embed_dim] inputs.

    ``forward(query, key, value, attn_mask, cache)``: with ``cache`` a
    ``Cache`` (self-attention decoding), this call's keys and values are
    appended to the cached ones on the sequence axis and the grown cache
    is returned; with a ``StaticCache`` (cross-attention decoding) the
    cached keys and values are used as they are and ``key``/``value`` are
    not read. Returns ``out``, or ``(out, cache)`` under a ``Cache``, with
    ``None`` for the attention weights before the cache when
    ``need_weights`` (the flash kernels do not form them)."""

    class Cache:
        def __init__(self, k, v):
            self.k = k
            self.v = v

    class StaticCache:
        def __init__(self, k, v):
            self.k = k
            self.v = v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, *, device=None,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device,
                  generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def gen_cache(self, key, value=None, type=None):
        """``type=StaticCache``: keys and values projected once from ``key``
        and ``value`` (``key`` where ``value`` is None). Otherwise an empty
        incremental ``Cache`` ([batch, heads, 0, head_dim] zeros on
        ``key``'s device) when ``value`` is None, else ``Cache(key,
        value)``."""
        if type is MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        if value is None:
            shape = (key.shape[0], self.num_heads, 0, self.head_dim)
            return self.Cache(torch.zeros(shape, device=key.device),
                              torch.zeros(shape, device=key.device))
        return self.Cache(key, value)

    def _fused_qkv(self, x):
        """Self-attention: one [H, 3H] product instead of three [H, H]
        ones (each output element is the same dot product); the biases,
        where the projections have them, added as one."""
        w = torch.cat([self.q_proj.weight, self.k_proj.weight,
                       self.v_proj.weight], dim=1)
        qkv = pt.matmul(x, w)
        biases = [p.bias for p in (self.q_proj, self.k_proj, self.v_proj)]
        if all(b is not None for b in biases):
            qkv = pt.add(qkv, torch.cat(biases))
        return qkv.chunk(3, dim=-1)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = key if value is None else value
        static = isinstance(cache, self.StaticCache)
        projs = (self.q_proj, self.k_proj, self.v_proj)
        # fused only over plain Linears: a quantized projection (an
        # Int8Linear of quantization.quantize_weights) has no f32 weight
        # to concatenate and runs its own product (the reference's fused
        # path reads .weight and fails there)
        if (key is query and value is key and not static
                and self.kdim == self.embed_dim == self.vdim
                and all(type(p) is Linear for p in projs)
                and len({p.bias is None for p in projs}) == 1):
            q, k, v = (self._split_heads(t) for t in self._fused_qkv(query))
        else:
            q = self._split_heads(self.q_proj(query))
            if static:
                k, v = cache.k, cache.v
            else:
                k = self._split_heads(self.k_proj(key))
                v = self._split_heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat(cast_inputs("concat", cache.k, k), dim=2)
            v = torch.cat(cast_inputs("concat", cache.v, v), dim=2)
            cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask),
            dropout_p=self.dropout, training=self.training)
        out = self.out_proj(self._merge_heads(out))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None and not static:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *, device=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device,
                  generator=generator)
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

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = pt.add(residual, self.dropout1(src))
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
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` independent deep copies of ``encoder_layer``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [copy.deepcopy(encoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory``, feed-forward. With
    ``cache`` = (incremental ``Cache``, ``StaticCache``) it decodes one
    step and returns ``(out, (grown Cache, StaticCache))``; under the
    static cache ``memory`` is not read and may be None."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *, device=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device,
                  generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = pt.add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        static_cache = None if cache is None else cache[1]
        tgt = self.cross_attn(tgt, memory, memory, memory_mask, static_cache)
        tgt = pt.add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(F, self.activation)
        tgt = self.linear2(self.dropout(act(self.linear1(tgt))))
        tgt = pt.add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incremental_cache, static_cache)

    def gen_cache(self, memory):
        """(an empty incremental ``Cache``, the ``StaticCache`` of
        ``memory``'s keys and values)."""
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    """``num_layers`` independent deep copies of ``decoder_layer``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [copy.deepcopy(decoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Each layer's (Cache, StaticCache); with ``do_zip`` two lists
        instead, the incremental caches and the static ones."""
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(Layer):
    """Encoder-decoder Transformer; the defaults are the base model of
    "Attention Is All You Need" (6 + 6 layers, d_model 512, 8 heads, FFN
    2048, dropout 0.1). Under ``normalize_before`` each stack ends in a
    LayerNorm. ``custom_encoder``/``custom_decoder`` replace the stacks."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None, generator=None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation, attn_dropout,
                act_dropout, normalize_before)
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device,
                  generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(*args, **kw)
            enc_norm = LayerNorm(d_model, device=device) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers, enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(*args, **kw)
            dec_norm = LayerNorm(d_model, device=device) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers, dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """[length, length] float32 additive mask: 0 on and below the
        diagonal, -inf above it."""
        dev = resolve_device(device)
        mask = torch.full((length, length), float("-inf"), device=dev)
        return torch.triu(mask, diagonal=1)
