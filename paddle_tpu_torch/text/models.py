"""BERT (counterpart of the BERT classes of paddle_tpu/text/models.py),
built on the port's own layers so every encoder layer's attention runs
the flash kernels: K1 forward, and K2/K3 backward when training."""
import torch

from .. import nn
from .. import tensor as pt
from ..core.place import resolve_device
from ..nn import functional as F
from ..nn import initializer as I


class BertEmbeddings(torch.nn.Module):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1, *, device="cuda",
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


class BertPooler(torch.nn.Module):
    def __init__(self, hidden_size, *, device="cuda", generator=None):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size, device=device,
                               generator=generator)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


class BertModel(torch.nn.Module):
    """BERT-base by default (12 layers, hidden 768, 12 heads, FFN 3072).
    ``forward`` returns (sequence_output, pooled) with the pooler, else
    the sequence output."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, max_position_embeddings=512,
                 type_vocab_size=2, with_pool=True, *, device="cuda",
                 generator=None):
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


class BertLMPredictionHead(torch.nn.Module):
    """Masked-LM head: transform, GELU, LayerNorm, then logits against the
    word embeddings (``decoder_weight`` is that very Parameter, tied)."""

    def __init__(self, hidden_size, vocab_size, embedding_weights=None, *,
                 device="cuda", generator=None):
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


class BertForPretraining(torch.nn.Module):
    """MLM + NSP heads over a BertModel (the BERT pretraining benchmark
    model). ``named_parameters()`` lists the tied decoder weight once,
    under ``bert.embeddings.word_embeddings.weight``, as the reference
    does."""

    def __init__(self, bert=None, *, device="cuda", generator=None, **bert_kwargs):
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


def bert_pretraining_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                          ignore_index=-100):
    """Masked-LM + NSP loss (the reference's BertPretrainingCriterion
    semantics)."""
    mlm_loss = F.cross_entropy(mlm_logits, mlm_labels, ignore_index=ignore_index,
                               reduction="mean", axis=-1)
    nsp_loss = F.cross_entropy(nsp_logits, nsp_labels, reduction="mean")
    return pt.add(mlm_loss, nsp_loss)
