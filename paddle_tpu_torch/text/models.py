"""BERT, GPT and Llama (counterpart of paddle_tpu/text/models.py), built
on the port's own layers. Every unmasked attention runs the flash kernels:
BERT's encoder layers and Llama's causal attention run K1 forward (and
K2/K3 backward when training); GPT's attention carries the reference's
additive float mask, so it runs the plain ``_sdpa_ref`` as the reference
does."""
import torch

from .. import nn
from ..ops import torch_ops as pt
from ..amp.auto_cast import cast_inputs
from ..core.place import resolve_device
from ..core.tensor import boundary
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Layer
from ..distributed.meta_parallel import mp_layers as mpl


class BertEmbeddings(Layer):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size, **kw)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size, **kw)
        self.layer_norm = nn.LayerNorm(hidden_size, device=device)
        self.dropout = nn.Dropout(hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
            position_ids = position_ids[None].expand(input_ids.shape[0], -1)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = pt.add(pt.add(self.word_embeddings(input_ids),
                            self.position_embeddings(position_ids)),
                     self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, hidden_size, *, device=None, generator=None):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size, device=device,
                               generator=generator)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


class BertModel(Layer):
    """BERT-base by default (12 layers, hidden 768, 12 heads, FFN 3072).
    ``forward`` returns (sequence_output, pooled) with the pooler, else
    the sequence output."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, max_position_embeddings=512,
                 type_vocab_size=2, initializer_range=0.02, pad_token_id=0, with_pool=True,
                 *, device=None, generator=None):
        """``initializer_range`` and ``pad_token_id`` are accepted and unused,
        as in the reference."""
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.embeddings = BertEmbeddings(vocab_size, hidden_size,
                                         max_position_embeddings, type_vocab_size,
                                         hidden_dropout_prob, **kw)
        enc_layer = nn.TransformerEncoderLayer(
            hidden_size, num_attention_heads, intermediate_size,
            dropout=hidden_dropout_prob, activation=hidden_act,
            attn_dropout=attention_probs_dropout_prob, act_dropout=0.0, **kw)
        self.encoder = nn.TransformerEncoder(enc_layer, num_hidden_layers)
        self.pooler = BertPooler(hidden_size, **kw) if with_pool else None
        self.hidden_size = hidden_size
        self.vocab_size = vocab_size

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(emb, attention_mask)
        if self.pooler is not None:
            return seq, self.pooler(seq)
        return seq


class BertLMPredictionHead(Layer):
    """Masked-LM head: transform, GELU, LayerNorm, then logits against the
    word embeddings (``decoder_weight`` is that very Parameter, tied)."""

    def __init__(self, hidden_size, vocab_size, embedding_weights=None, *,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.transform = nn.Linear(hidden_size, hidden_size, device=dev,
                                   generator=generator)
        self.layer_norm = nn.LayerNorm(hidden_size, device=dev)
        self.decoder_weight = embedding_weights  # tied
        self.decoder_bias = I.create_parameter([vocab_size], I.Constant(0.0), dev)

    def forward(self, hidden_states):
        x = self.layer_norm(F.gelu(self.transform(hidden_states)))
        return pt.add(pt.matmul(x, self.decoder_weight, transpose_y=True),
                      self.decoder_bias)


class BertForPretraining(Layer):
    """MLM + NSP heads over a BertModel (the BERT pretraining benchmark
    model). ``named_parameters()`` lists the tied decoder weight once,
    under ``bert.embeddings.word_embeddings.weight``, as the reference
    does."""

    def __init__(self, bert=None, *, device=None, generator=None, **bert_kwargs):
        super().__init__()
        if bert is None:
            bert = BertModel(**bert_kwargs, device=device, generator=generator)
        self.bert = bert
        dev = bert.embeddings.word_embeddings.weight.device
        self.cls = BertLMPredictionHead(
            bert.hidden_size, bert.vocab_size, bert.embeddings.word_embeddings.weight,
            device=dev, generator=generator)
        self.nsp = nn.Linear(bert.hidden_size, 2, device=dev, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        """masked_positions: optional [B, P] int positions of the masked
        tokens; only those rows go through the vocab projection."""
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        if masked_positions is not None:
            seq = pt.take_along_axis(seq, masked_positions[..., None], axis=1)
        return self.cls(seq), self.nsp(pooled)


@boundary
def bert_pretraining_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                          ignore_index=-100):
    """Masked-LM + NSP loss (the reference's BertPretrainingCriterion
    semantics); on Tensors it returns a Tensor."""
    mlm_loss = F.cross_entropy(mlm_logits, mlm_labels, ignore_index=ignore_index,
                               reduction="mean", axis=-1)
    nsp_loss = F.cross_entropy(nsp_logits, nsp_labels, reduction="mean")
    return pt.add(mlm_loss, nsp_loss)


class GPTDecoderLayer(Layer):
    def __init__(self, hidden_size, num_heads, intermediate_size, dropout=0.0,
                 act="gelu", *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.ln1 = nn.LayerNorm(hidden_size, device=dev)
        self.attn = nn.MultiHeadAttention(hidden_size, num_heads, dropout, **kw)
        self.ln2 = nn.LayerNorm(hidden_size, device=dev)
        self.fc1 = nn.Linear(hidden_size, intermediate_size, **kw)
        self.fc2 = nn.Linear(intermediate_size, hidden_size, **kw)
        self.act = act
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        h = self.ln1(x)
        x = pt.add(x, self.attn(h, h, h, mask))
        h = self.ln2(x)
        return pt.add(x, self.dropout(self.fc2(getattr(F, self.act)(self.fc1(h)))))


class GPTModel(Layer):
    """Pre-norm causal decoder (GPT-2 style); the head is ``wte`` used
    transposed."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 dropout=0.0, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        intermediate_size = intermediate_size or 4 * hidden_size
        self.wte = nn.Embedding(vocab_size, hidden_size, **kw)
        self.wpe = nn.Embedding(max_seq_len, hidden_size, **kw)
        self.blocks = nn.LayerList([
            GPTDecoderLayer(hidden_size, num_heads, intermediate_size, dropout, **kw)
            for _ in range(num_layers)])
        self.ln_f = nn.LayerNorm(hidden_size, device=dev)
        self.max_seq_len = max_seq_len

    def forward(self, input_ids):
        b, t = input_ids.shape
        pos = torch.arange(t, device=input_ids.device)[None].expand(b, t)
        x = pt.add(self.wte(input_ids), self.wpe(pos))
        mask = nn.Transformer.generate_square_subsequent_mask(t, device=input_ids.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return pt.matmul(self.ln_f(x), self.wte.weight, transpose_y=True)

    def generate(self, input_ids, **kwargs):
        from .generation import generate as _generate

        return _generate(self, input_ids, **kwargs)


class RMSNorm(Layer):
    def __init__(self, hidden_size, eps=1e-6, *, device=None):
        super().__init__()
        self.weight = self.create_parameter([hidden_size],
                                            default_initializer=I.Constant(1.0),
                                            device=device)
        self.eps = eps

    def forward(self, x):
        return rms_norm(*cast_inputs("rms_norm", x, self.weight), eps=self.eps)


def rms_norm(x, w, *, eps=1e-6):
    """RMSNorm as the reference rounds it: the mean square in float32,
    rsqrt rounded to x's dtype before the two products. Shared with the
    cached decode of generation.py."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def _rope_tables(head_dim, positions, dtype, base=10000.0):
    """(cos, sin) [1, 1, T, head_dim / 2] of the absolute ``positions``
    [T], or [B, 1, T, head_dim / 2] of per-row positions [B, T], computed
    in float32 and cast to ``dtype`` as the reference does. A decode step
    computes them once for all layers."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=positions.device) / head_dim))
    freqs = positions.to(torch.float32)[..., None] * inv  # torch.outer's products
    if positions.dim() == 1:
        freqs = freqs[None]
    return torch.cos(freqs)[:, None].to(dtype), torch.sin(freqs)[:, None].to(dtype)


def _rotate(x, cos, sin):
    """Rotary embedding of x [B, H, T, D] by its tables: the interleaved
    pairs (x[..., ::2], x[..., 1::2]) rotate and interleave again."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape)


def _rope(x, base=10000.0, positions=None):
    """Rotary embedding. x: [B, H, T, D]; positions: [T] absolute positions
    (defaults to 0..T-1)."""
    if positions is None:
        positions = torch.arange(x.shape[-2], device=x.device)
    return _rotate(x, *_rope_tables(x.shape[-1], positions, x.dtype, base))


def _promoted(*ts):
    """The tensors in their promoted dtype, as jnp promotes the operands of
    one op (bf16 with float32 -> float32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _repeat_kv(x, rep):
    """GQA: each K/V head serves ``rep`` query heads in a row (the
    reference's ``jnp.repeat`` on the head axis)."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=1)


def _tp_group(layer):
    """The active mp group where ``layer`` was stamped tensor-parallel
    and a tensor-parallel scope is open, else None."""
    return mpl.mp_group() if layer._tensor_parallel else None


class LlamaAttention(Layer):
    _tensor_parallel = False

    def __init__(self, hidden_size, num_heads, num_kv_heads=None, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(bias_attr=False, device=resolve_device(device), generator=generator)
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = hidden_size // num_heads
        kv_width = self.num_kv_heads * self.head_dim
        self.q_proj = nn.Linear(hidden_size, hidden_size, **kw)
        self.k_proj = nn.Linear(hidden_size, kv_width, **kw)
        self.v_proj = nn.Linear(hidden_size, kv_width, **kw)
        self.o_proj = nn.Linear(hidden_size, hidden_size, **kw)

    def forward(self, x):
        b, t, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        wq, wk, wv = self.q_proj.weight, self.k_proj.weight, self.v_proj.weight
        tp = _tp_group(self)
        if tp is not None:
            # the rank's heads: q's column block; K/V's block where mp
            # divides the KV heads, else the whole projections (a KV head
            # is split over ranks), of which the rank's queries take theirs
            if nh % tp.n:
                raise ValueError(f"tensor parallel: {tp.n} mp ranks do not divide {nh} heads")
            x = mpl.CopyToMP.apply(x, tp)
            gather_kv = nkv % tp.n != 0
            if gather_kv:
                wk = mpl.GatherWeight.apply(wk, 1, tp)
                wv = mpl.GatherWeight.apply(wv, 1, tp)
            else:
                nkv //= tp.n
            nh //= tp.n
        # the reference's ops "llama_qkv_rope" and "llama_attn_out": cast as
        # auto_cast casts them (under O1 not at all), their products in the
        # promoted dtype as jnp promotes (bf16 with float32 -> float32)
        x, wq, wk, wv = _promoted(*cast_inputs("llama_qkv_rope", x, wq, wk, wv))
        q = torch.matmul(x, wq).reshape(b, t, nh, hd).transpose(1, 2)
        k = torch.matmul(x, wk).reshape(b, t, nkv, hd).transpose(1, 2)
        v = torch.matmul(x, wv).reshape(b, t, nkv, hd).transpose(1, 2)
        cos, sin = _rope_tables(hd, torch.arange(t, device=x.device), x.dtype)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        if tp is not None and gather_kv:
            rep = self.num_heads // self.num_kv_heads
            k, v = (_repeat_kv(a, rep).narrow(1, tp.rank * nh, nh) for a in (k, v))
        else:
            k, v = _repeat_kv(k, nh // nkv), _repeat_kv(v, nh // nkv)
        # causal attention through the dispatching sdpa: K1 on the card
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             training=self.training)
        out, wo = _promoted(*cast_inputs("llama_attn_out", out, self.o_proj.weight))
        out = torch.matmul(out.transpose(1, 2).reshape(b, t, nh * hd), wo)
        return out if tp is None else mpl.ReduceFromMP.apply(out, tp)


class LlamaMLP(Layer):
    _tensor_parallel = False

    def __init__(self, hidden_size, intermediate_size, *, device=None, generator=None):
        super().__init__()
        kw = dict(bias_attr=False, device=resolve_device(device), generator=generator)
        self.gate_proj = nn.Linear(hidden_size, intermediate_size, **kw)
        self.up_proj = nn.Linear(hidden_size, intermediate_size, **kw)
        self.down_proj = nn.Linear(intermediate_size, hidden_size, **kw)

    def forward(self, x):
        tp = _tp_group(self)
        if tp is not None:
            x = mpl.CopyToMP.apply(x, tp)
        y = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return y if tp is None else mpl.ReduceFromMP.apply(y, tp)


class LlamaDecoderLayer(Layer):
    def __init__(self, hidden_size, num_heads, intermediate_size, num_kv_heads=None, *,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.input_layernorm = RMSNorm(hidden_size, device=dev)
        self.self_attn = LlamaAttention(hidden_size, num_heads, num_kv_heads, **kw)
        self.post_attention_layernorm = RMSNorm(hidden_size, device=dev)
        self.mlp = LlamaMLP(hidden_size, intermediate_size, **kw)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(Layer):
    """Llama-2 architecture, 7B by default (vocab 32000, hidden 4096, 32
    layers, 32 heads, FFN 11008); shrink it by the keyword arguments.
    ``forward`` returns the logits [B, T, vocab]. ``generate`` runs the
    KV-cached decode, greedy or sampled (text/generation.py).

    ``tensor_parallel=True`` stamps the reference's Megatron specs
    (models.py:332-343): q, k, v, gate and up column-parallel, o and down
    row-parallel, the embedding vocab-parallel and ``lm_head``
    column-parallel over the vocabulary. Outside a tensor-parallel scope
    the model is the plain one; inside a step over a mesh with mp > 1
    (``distributed.meta_parallel.mp_layers``) each rank holds its blocks,
    attends with its heads and runs the Megatron collectives; the logits
    are gathered whole for the loss, as the reference's ``loss_fn`` sees
    them."""

    _tensor_parallel = False

    def __init__(self, vocab_size=32000, hidden_size=4096, num_layers=32,
                 num_heads=32, intermediate_size=11008, num_kv_heads=None,
                 max_seq_len=4096, tensor_parallel=False, *, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.embed_tokens = nn.Embedding(vocab_size, hidden_size, **kw)
        self.layers = nn.LayerList([
            LlamaDecoderLayer(hidden_size, num_heads, intermediate_size, num_kv_heads, **kw)
            for _ in range(num_layers)])
        self.norm = RMSNorm(hidden_size, device=dev)
        self.lm_head = nn.Linear(hidden_size, vocab_size, bias_attr=False, **kw)
        if tensor_parallel:
            self._stamp_tensor_parallel()

    def _stamp_tensor_parallel(self, axis="mp"):
        self.embed_tokens.weight.mp_spec = (axis, None)  # vocab-parallel
        self.lm_head.weight.mp_spec = (None, axis)
        for layer in self.layers:
            attn, mlp = layer.self_attn, layer.mlp
            for col in (attn.q_proj, attn.k_proj, attn.v_proj, mlp.gate_proj, mlp.up_proj):
                col.weight.mp_spec = (None, axis)  # shard heads / ffn
            for row in (attn.o_proj, mlp.down_proj):
                row.weight.mp_spec = (axis, None)  # summed over the ranks
            attn._tensor_parallel = mlp._tensor_parallel = True
        self._tensor_parallel = True

    def forward(self, input_ids):
        tp = _tp_group(self)
        if tp is None:
            x = self.embed_tokens(input_ids)
        else:
            (w,) = cast_inputs("embedding", self.embed_tokens.weight)
            x = mpl.vocab_parallel_lookup(input_ids, w, tp)
        for layer in self.layers:
            x = layer(x)
        if tp is None:
            return self.lm_head(self.norm(x))
        h = mpl.CopyToMP.apply(self.norm(x), tp)
        logits = F.linear(h, self.lm_head.weight)
        return mpl.GatherFromMP.apply(logits, logits.dim() - 1, tp)

    def generate(self, input_ids, use_cache=True, **kwargs):
        """KV-cached decode by default; ``eos_token_id``, ``max_length`` or
        ``use_cache=False`` take the generic full-width path."""
        from .generation import generate as _generate
        from .generation import llama_generate as _llama_generate

        if (use_cache and kwargs.get("eos_token_id") is None
                and kwargs.get("max_length") is None):
            for k in ("eos_token_id", "max_length", "pad_token_id"):
                kwargs.pop(k, None)
            return _llama_generate(self, input_ids, **kwargs)
        return _generate(self, input_ids, **kwargs)
