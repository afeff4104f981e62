"""Autoregressive generation (counterpart of
paddle_tpu/text/generation.py): greedy, or sampled with temperature, top-k
and top-p through jax.random's own categorical stream
(``core/random.py``), bitwise where the logits are.

- ``generate``: any causal LM whose forward(ids) gives logits. One forward
  at the full ``total`` width per step over a static buffer padded with
  ``pad_token_id``, reading row ``cur - 1``, as the reference's jitted
  step does; eos stops a row, and the result is cut at the longest row.
  A sampled step draws with ``sub`` of the host key stream ``key, sub =
  split(key)`` from ``PRNGKey(seed)``. Eager on every device.
- ``llama_generate``: the KV-cached decode of ``LlamaModel``. One
  ``[B, KV, total, D]`` buffer each for K and V per layer, in the
  parameters' dtype. The prefill writes rows 0..t0-1 through K1 causal
  over the cache's first t0 rows (read in place, ops/flash_attention.py
  ``_kv_operand``) and gives the first token, sampled with
  ``PRNGKey(seed)`` itself. Every later step has one shape and reads
  everything it changes from the device: the token, its position and the
  key sit in fixed buffers; the step writes its K/V row at the position
  (the reference's ``dynamic_update_slice``), runs K1's length form over
  the whole cache at ``k_len = position + 1``, samples with ``sub`` of
  ``key, sub = split(key)``, writes the token into a ``[B,
  max_new_tokens]`` buffer and advances position, key and index itself.
  On the card that step is warmed up (the first step, for real), captured
  once per call into a CUDA graph (core/cuda_graph.py) and replayed for
  every later token with no host work between replays; the tokens are
  read back once. On the CPU the same step runs eagerly.
- ``llama_decode_model``: the same model as a ``DecodeModel`` for the
  continuous-batching engine (inference/decode.py): per-slot K/V pools,
  per-row positions, K1 at per-row key lengths. Its prefill and step
  build no tensor from host data, so the engine captures them.

The reference runs the whole cached loop as one jitted ``lax.scan`` and
keeps one compiled decode per model and configuration. Here the graph is
captured per call and dropped after it, because a graph pins its cache
(2.1 GB for Llama-2-7B at batch 16 and 256 positions): the reference's
per-model cache is matched in its tokens, not in its mechanism.
``_LlamaWeights.layers`` repeats the decoder layer's maths over the
collected weights on purpose, as the reference's cached loop does beside
its ``LlamaDecoderLayer``, and both cached paths (``_CachedLlama`` and
the engine's model) run it: a rounding change in ``text/models.py`` must
be made there too (the parity tests hold them against each other).
"""
import math

import numpy as np
import torch

from .. import tensor as pt
from ..core import random
from ..core.cuda_graph import Graph
from ..nn import functional as F
from ..ops import flash_attention
from .models import _repeat_kv, _rope_tables, _rotate, rms_norm

_F32_MIN = torch.finfo(torch.float32).min


def _apply_top_k(logits, k):
    """Logits below the k-th largest (found with a sort) become the
    float32 minimum."""
    kth = torch.sort(logits, dim=-1).values[..., -k, None]
    return torch.where(logits < kth, _F32_MIN, logits)


def _apply_top_p(logits, p):
    """Keep the smallest prefix of the logits sorted descending whose
    softmax mass reaches p (always at least one token): the logit at
    ``sum(cumsum < p)`` is the cutoff, and logits below it become the
    float32 minimum. The softmax is jax.nn.softmax's (exp of x - max over
    their sum). A cutoff index past the vocabulary (rounding keeps the
    whole cumsum below p) masks nothing, as jax's gather fills it."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    e = torch.exp(sorted_logits - sorted_logits.amax(dim=-1, keepdim=True))
    cum = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
    idx = (cum < p).sum(dim=-1, keepdim=True)
    vocab = logits.shape[-1]
    cutoff = sorted_logits.gather(-1, idx.clamp_max(vocab - 1))
    cutoff = torch.where(idx < vocab, cutoff, -torch.inf)
    return torch.where(logits < cutoff, _F32_MIN, logits)


def _filter_logits(logits, temperature=1.0, top_k=0, top_p=1.0):
    """What a sampled token is drawn from: float32 logits divided by the
    temperature (as the jitted reference rounds it: times the float32
    reciprocal, ``tensor.divide_by_scalar``), then top-k and top-p
    filtered."""
    logits = logits.float()
    if temperature != 1.0:
        logits = pt.divide_by_scalar(logits, max(temperature, 1e-6))
    if top_k and top_k > 0:
        logits = _apply_top_k(logits, int(top_k))
    if top_p < 1.0:
        logits = _apply_top_p(logits, float(top_p))
    return logits


def sample_next(logits, key=None, do_sample=False, temperature=1.0, top_k=0, top_p=1.0):
    """logits [B, V] -> token ids [B] int32: greedy, the first maximum (as
    ``jnp.argmax``), or sampled as the reference's ``sample_next`` samples:
    jax.random.categorical under ``key`` (a host key, or a 2-word device
    tensor) over the filtered logits. Builds no tensor from host data when
    ``key`` lives on the device."""
    if not do_sample:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    filtered = _filter_logits(logits, temperature, top_k, top_p)
    return random.categorical(key, filtered).to(torch.int32)


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
    dev = _device(model)
    was_training = model.training
    model.eval()
    try:
        # static-shape buffer: ids padded to `total`, a cursor advances
        buf = torch.full((b, total), pad_token_id, dtype=torch.int32, device=dev)
        buf[:, :t0] = torch.from_numpy(ids).to(dev)
        done = np.zeros((b,), bool)
        key = random.PRNGKey(seed)
        cur = t0
        with torch.inference_mode():
            for _ in range(steps):
                key, sub = random.split(key)
                nxt = sample_next(model(buf)[:, cur - 1], sub, do_sample, temperature, top_k,
                                  top_p).cpu().numpy()
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
    """A LlamaModel's weights, a KV cache for ``batch`` rows of ``t0 +
    max_new_tokens`` positions and the decode state on the device: the last
    token ``tok`` [B], its absolute position ``pos`` [1] and ``k_len``
    [B] (= pos + 1 in every row), the key ``key`` (2 words), the emitted
    ``tokens`` [B, max_new_tokens] and the column ``index`` [1] of the
    next. ``prefill(prompt)`` fills rows 0..t0-1 and emits the first
    token; ``step()`` feeds ``tok`` and emits the next, reading and
    advancing only that state, so one capture serves every step.
    ``sampling``: ``sample_next``'s do_sample, temperature, top_k, top_p."""

    def __init__(self, model, batch, t0, max_new_tokens, sampling=None, seed=0):
        super().__init__(model)
        emb = self.params["embed"]
        dev = emb.device
        # the cache dtype follows the params (bf16 weights -> bf16 cache)
        shape = (len(self.params["layers"]), batch, self.nkv, t0 + max_new_tokens, self.hd)
        self.k = torch.zeros(shape, dtype=emb.dtype, device=dev)
        self.v = torch.zeros(shape, dtype=emb.dtype, device=dev)
        self.sampling = dict(sampling or {})
        self.tokens = torch.zeros((batch, max(max_new_tokens, 1)), dtype=torch.int64,
                                  device=dev)
        self.tok = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.k_len = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.key = random.key_tensor(random.PRNGKey(seed), dev)

    def forward(self, token_ids, start):
        """The prefix form: the tokens at absolute positions
        start..start+t-1 through every layer, their K/V rows written into
        the cache, K1 causal over its first start + t rows."""
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

    def prefill(self, prompt):
        """prompt [B, t0] -> rows 0..t0-1 of the cache; the first token,
        sampled with the seed's key itself (the reference's :290)."""
        t0 = prompt.shape[1]
        tok = sample_next(self.forward(prompt, 0)[:, -1], self.key, **self.sampling)
        self.tok.copy_(tok)
        self.tokens[:, 0] = self.tok
        self.pos.fill_(t0)
        self.k_len.fill_(t0 + 1)
        self.index.fill_(1)

    def step(self):
        """One token for every row at one shape: ``tok`` at ``pos`` writes
        its K/V row there, attends through K1's length form over the whole
        cache at ``k_len``, and the next token, sampled with ``sub`` of
        ``key, sub = split(key)`` (the reference's :295), goes to
        ``tokens[:, index]``; then pos, k_len and index advance. Builds
        no tensor from host data."""
        x = self.params["embed"][self.tok][:, None]
        cos, sin = _rope_tables(self.hd, self.pos, x.dtype)

        def attend(li, q, k, v):
            self.k[li].index_copy_(2, self.pos, k)
            self.v[li].index_copy_(2, self.pos, v)
            return self.attention(q, self.k[li], self.v[li], k_len=self.k_len)

        logits = self.logits(self.layers(x, cos, sin, attend))[:, -1]
        sub = None
        if self.sampling.get("do_sample"):
            keys = random.split(self.key)
            self.key.copy_(keys[0])
            sub = keys[1]
        self.tok.copy_(sample_next(logits, sub, **self.sampling))
        self.tokens.index_copy_(1, self.index, self.tok[:, None])
        self.pos += 1
        self.k_len += 1
        self.index += 1

    def decode(self, n, cuda_graph=True):
        """``n`` steps. On the card (unless ``cuda_graph`` is False) the
        first runs for real as the warm-up of a capture, and the captured
        step replays for the rest."""
        if n <= 0:
            return
        if not (cuda_graph and self.k.is_cuda):
            for _ in range(n):
                self.step()
            return
        graph = Graph(self.step, self.k.device)
        for _ in range(n - 1):
            graph.replay()


def llama_generate(model, input_ids, max_new_tokens=32, do_sample=False,
                   temperature=1.0, top_k=0, top_p=1.0, seed=0, cuda_graph=True):
    """KV-cached decode for text.models.LlamaModel, greedy or sampled: the
    prefill, then one single-token step per new token, captured as one
    CUDA graph on the card (module docstring). ``cuda_graph=False`` runs
    the steps eagerly on the card as well, to compare with the graph.
    Returns an int32 numpy array [B, prompt + max_new_tokens]."""
    ids = _prompt(input_ids)
    b, t0 = ids.shape
    sampling = dict(do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            run = _CachedLlama(model, b, t0, max_new_tokens, sampling, seed)
            run.prefill(torch.from_numpy(ids).to(_device(model)))
            run.decode(max_new_tokens - 1, cuda_graph)
            new = run.tokens.cpu().numpy().astype(np.int32)
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
