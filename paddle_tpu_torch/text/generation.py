"""Autoregressive greedy generation (counterpart of
paddle_tpu/text/generation.py).

- ``generate``: any causal LM whose forward(ids) gives logits. One forward
  at the full ``total`` width per step over a static buffer padded with
  ``pad_token_id``, reading row ``cur - 1``, as the reference's jitted
  step does; eos stops a row, and the result is cut at the longest row.
- ``llama_generate``: the KV-cached decode of ``LlamaModel``. One
  ``[B, KV, total, D]`` buffer each for K and V per layer, in the
  parameters' dtype; the prefill writes rows 0..t0-1, step i feeds the
  token at absolute position t0 + i - 1 and writes its row there before
  the attention. Every attention (the causal prefill and each
  single-query step) runs K1 over the valid prefix of the cache, read in
  place (ops/flash_attention.py ``_kv_operand``).

- ``llama_decode_model``: the same model as a ``DecodeModel`` for the
  continuous-batching engine (inference/decode.py): per-slot K/V pools,
  per-row positions, K1 at per-row key lengths.

The reference runs the whole cached loop as one jitted ``lax.scan``; here
it is a Python loop of eager ops whose tokens stay on the device until
the end. ``_LlamaWeights.layers`` repeats the decoder layer's maths over
the collected weights on purpose, as the reference's cached loop does
beside its ``LlamaDecoderLayer``, and both cached paths (``_CachedLlama``
and the engine's model) run it: a rounding change in ``text/models.py``
must be made there too (the parity tests hold them against each other).
Sampling (``do_sample=True``: temperature, top-k, top-p and jax's
categorical draw) is not ported yet and raises.
"""
import math

import numpy as np
import torch

from ..nn import functional as F
from ..ops import flash_attention
from .models import _repeat_kv, _rope_tables, _rotate, rms_norm


def _greedy_only(do_sample):
    if do_sample:
        raise NotImplementedError("do_sample=True: sampling is not ported yet "
                                  "(greedy decoding only)")


def sample_next(logits, key=None, do_sample=False, temperature=1.0, top_k=0, top_p=1.0):
    """logits [B, V] -> token ids [B] int32 (greedy: the first maximum, as
    ``jnp.argmax``)."""
    _greedy_only(do_sample)
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def _prompt(input_ids):
    """input_ids (numpy, list or tensor; 1-d or [B, T]) -> int32 [B, T]."""
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.cpu().numpy()
    ids = np.asarray(input_ids).astype(np.int32)
    return ids[None, :] if ids.ndim == 1 else ids


def _device(model):
    return next(model.parameters()).device


def generate(model, input_ids, max_new_tokens=32, max_length=None,
             do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
             eos_token_id=None, pad_token_id=0, seed=0):
    """Decode continuation tokens for ``model`` (any forward(ids) -> logits
    causal LM). Returns an int32 numpy array of width up to prompt_len +
    max_new_tokens: rows that hit eos early are padded with pad_token_id,
    and the result is cut at the longest row once every row has finished."""
    ids = _prompt(input_ids)
    b, t0 = ids.shape
    total = max_length or (t0 + max_new_tokens)
    steps = total - t0
    if steps <= 0:
        return ids
    _greedy_only(do_sample)
    dev = _device(model)
    was_training = model.training
    model.eval()
    try:
        # static-shape buffer: ids padded to `total`, a cursor advances
        buf = torch.full((b, total), pad_token_id, dtype=torch.int32, device=dev)
        buf[:, :t0] = torch.from_numpy(ids).to(dev)
        done = np.zeros((b,), bool)
        cur = t0
        with torch.inference_mode():
            for _ in range(steps):
                nxt = sample_next(model(buf)[:, cur - 1]).cpu().numpy()
                if eos_token_id is not None:
                    nxt = np.where(done, pad_token_id, nxt).astype(np.int32)
                    done |= nxt == eos_token_id
                buf[:, cur] = torch.from_numpy(nxt).to(dev)
                cur += 1
                if eos_token_id is not None and done.all():
                    break
    finally:
        if was_training:
            model.train()
    return buf[:, :cur].cpu().numpy()


def _collect_llama_params(model):
    """Per-layer weights of a text.models.LlamaModel, by the reference's
    keys."""
    p = dict(model.named_parameters())
    layers = []
    for i in range(len(model.layers)):
        pre = f"layers.{i}."
        layers.append({
            "ln1": p[pre + "input_layernorm.weight"],
            "wq": p[pre + "self_attn.q_proj.weight"],
            "wk": p[pre + "self_attn.k_proj.weight"],
            "wv": p[pre + "self_attn.v_proj.weight"],
            "wo": p[pre + "self_attn.o_proj.weight"],
            "ln2": p[pre + "post_attention_layernorm.weight"],
            "gate": p[pre + "mlp.gate_proj.weight"],
            "up": p[pre + "mlp.up_proj.weight"],
            "down": p[pre + "mlp.down_proj.weight"],
        })
    return {"embed": p["embed_tokens.weight"], "norm": p["norm.weight"],
            "head": p["lm_head.weight"], "layers": layers}


class _LlamaWeights:
    """A LlamaModel's weights by the reference's keys, and its decoder maths
    over them: ``layers`` runs x [B, T, hidden] through every decoder
    layer and leaves the attention, with any cache write, to the caller's
    ``attend(layer, q, k, v)`` (q [B, heads, T, D], k/v [B, kv_heads, T,
    D], rotated); ``logits`` applies the final norm and the head. The cached
    generate and the decode engine's model share it, so both round where
    ``rms_norm`` and ``_rotate`` round."""

    def __init__(self, model):
        attn = model.layers[0].self_attn
        self.params = _collect_llama_params(model)
        self.nh, self.nkv, self.hd = attn.num_heads, attn.num_kv_heads, attn.head_dim
        self.scale = 1.0 / math.sqrt(self.hd)

    def layers(self, x, cos, sin, attend):
        b, t, _ = x.shape
        nh, nkv, hd = self.nh, self.nkv, self.hd
        for li, lp in enumerate(self.params["layers"]):
            h = rms_norm(x, lp["ln1"])
            q = torch.matmul(h, lp["wq"]).reshape(b, t, nh, hd).transpose(1, 2)
            k = torch.matmul(h, lp["wk"]).reshape(b, t, nkv, hd).transpose(1, 2)
            v = torch.matmul(h, lp["wv"]).reshape(b, t, nkv, hd).transpose(1, 2)
            q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
            out = attend(li, q, k, v)
            x = x + torch.matmul(out.transpose(1, 2).reshape(b, t, nh * hd), lp["wo"])
            h2 = rms_norm(x, lp["ln2"])
            x = x + torch.matmul(F.silu(torch.matmul(h2, lp["gate"]))
                                 * torch.matmul(h2, lp["up"]), lp["down"])
        return x

    def logits(self, x):
        return torch.matmul(rms_norm(x, self.params["norm"]), self.params["head"])

    def attention(self, q, k, v, k_len=None):
        """K1 (causal, bottom-right) of q over k/v, GQA heads repeated."""
        rep = self.nh // self.nkv
        return flash_attention.mha(q, _repeat_kv(k, rep), _repeat_kv(v, rep),
                                   scale=self.scale, causal=True, k_len=k_len)


class _CachedLlama(_LlamaWeights):
    """A LlamaModel's weights and a KV cache for ``batch`` rows of up to
    ``total`` positions. ``forward(token_ids, start)`` runs the tokens at
    absolute positions start..start+t-1 through every layer, writes their
    K/V rows into the cache and attends over its first start + t rows."""

    def __init__(self, model, batch, total):
        super().__init__(model)
        emb = self.params["embed"]
        # the cache dtype follows the params (bf16 weights -> bf16 cache)
        shape = (len(self.params["layers"]), batch, self.nkv, total, self.hd)
        self.k = torch.zeros(shape, dtype=emb.dtype, device=emb.device)
        self.v = torch.zeros(shape, dtype=emb.dtype, device=emb.device)

    def forward(self, token_ids, start):
        n_valid = start + token_ids.shape[1]
        x = self.params["embed"][token_ids.long()]
        positions = torch.arange(start, n_valid, device=x.device)
        cos, sin = _rope_tables(self.hd, positions, x.dtype)

        def attend(li, q, k, v):
            self.k[li, :, :, start:n_valid] = k
            self.v[li, :, :, start:n_valid] = v
            # causal, bottom-right aligned over the valid prefix: K1 reads
            # the cache's first n_valid rows in place
            return self.attention(q, self.k[li, :, :, :n_valid], self.v[li, :, :, :n_valid])

        return self.logits(self.layers(x, cos, sin, attend))


def llama_generate(model, input_ids, max_new_tokens=32, do_sample=False,
                   temperature=1.0, top_k=0, top_p=1.0, seed=0):
    """KV-cached greedy decode for text.models.LlamaModel: the prefill, then
    one single-token step per new token. Returns an int32 numpy array
    [B, prompt + max_new_tokens]."""
    _greedy_only(do_sample)
    ids = _prompt(input_ids)
    b, t0 = ids.shape
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            run = _CachedLlama(model, b, t0 + max_new_tokens)
            prompt = torch.from_numpy(ids).to(_device(model))
            tok = sample_next(run.forward(prompt, 0)[:, -1])
            new = [tok]
            for i in range(1, max_new_tokens):
                # `tok` occupies absolute position t0 + i - 1
                tok = sample_next(run.forward(tok[:, None], t0 + i - 1)[:, -1])
                new.append(tok)
            new = torch.stack(new, dim=1).cpu().numpy()
    finally:
        if was_training:
            model.train()
    return np.concatenate([ids, new], axis=1)


def llama_decode_model(model, max_slots, max_seq_len):
    """A ``DecodeModel`` (inference/decode.py) over a text.models.LlamaModel,
    for the continuous-batching ``DecodeEngine`` with ``max_slots`` slots of
    ``max_seq_len`` positions. Its KV buffers are one K and one V pool a
    layer, ``[max_slots, kv_heads, max_seq_len, head_dim]`` in the weights'
    dtype (``kv_seq_axis`` 2), owned by the engine.

    - prefill: one prompt ``[1, P_b]`` (padded to its bucket) through the
      layers with K1 causal over its own K/V at ``k_len`` = the prompt's
      length; returns the logits at its last token and every layer's K/V
      ``[1, kv_heads, P_b, head_dim]``.
    - step: one token for every slot (a step row is a slot). Each row
      writes its K/V at ``(slot, positions[slot])`` of the pools and
      attends through K1 over its own slot, read in place, at ``k_len`` =
      positions + 1: the pools' width and the other rows' lengths never
      enter a row's attention. It is ``_CachedLlama.forward``'s maths with
      per-row positions (``_LlamaWeights.layers``)."""
    from ..inference.decode import DecodeModel

    w = _LlamaWeights(model)
    emb = w.params["embed"]
    n_layers = len(w.params["layers"])
    rows = torch.arange(max_slots, device=emb.device)

    def prefill_fn(weights, tokens, lengths):
        x = weights.params["embed"][tokens]
        cos, sin = _rope_tables(weights.hd, torch.arange(tokens.shape[1], device=x.device),
                                x.dtype)
        kv = []

        def attend(li, q, k, v):
            kv.extend((k, v))
            return weights.attention(q, k, v, k_len=lengths)

        x = weights.layers(x, cos, sin, attend)
        last = x[torch.arange(tokens.shape[0], device=x.device), lengths.long() - 1]
        return (weights.logits(last), *kv)

    def step_fn(weights, tokens, positions, *pools):
        x = weights.params["embed"][tokens][:, None]
        cos, sin = _rope_tables(weights.hd, positions[:, None], x.dtype)
        at = positions.long()
        k_len = positions + 1

        def attend(li, q, k, v):
            pk, pv = pools[2 * li], pools[2 * li + 1]
            pk[rows, :, at] = k[:, :, 0]
            pv[rows, :, at] = v[:, :, 0]
            return weights.attention(q, pk, pv, k_len=k_len)

        return weights.logits(weights.layers(x, cos, sin, attend)[:, 0])

    kv_spec = [((w.nkv, w.hd), emb.dtype)] * (2 * n_layers)
    return DecodeModel(w, prefill_fn, step_fn, kv_spec, vocab_size=emb.shape[0],
                       kv_seq_axis=2, device=emb.device, max_slots=max_slots,
                       max_seq_len=max_seq_len)
