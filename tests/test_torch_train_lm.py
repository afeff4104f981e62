"""Training after serving: the port's ``build_train_step`` on a causal
Llama and on an encoder-decoder Transformer (paddle_tpu_torch) against the
JAX package's, with the JAX model's weights carried across and inputs from
a numpy seed.

- Llama: bench.py's ``LLAMA_SMOKE`` (vocab 256, hidden 64, 2 layers, 2
  heads of 32, FFN 128) at seq 64, and a GQA variant with one KV head;
  AdamW(weight decay 0.1, ClipGradByGlobalNorm(1.0)) on a scheduler, the
  loss of bench.py's ``run_llama``, 3 steps with the scheduler stepped
  after each.
- Transformer: 2 + 2 layers of d_model 64, 2 heads, FFN 128, dropout 0.1
  everywhere, a 101-token embedding tied to the output projection,
  sinusoidal positions (chip_smoke.translation_model), 16 source and 12
  target tokens (the cross-attention at Sq != Sk), label smoothing 0.1
  (``label_smooth`` over ``one_hot``, soft-label cross entropy), Adam(0.9,
  0.98, 1e-9) under NoamDecay.

The JAX side takes its Pallas kernels in interpret mode for the unmasked
attention (``_use_pallas`` patched, ``pallas_attention_min_seq`` 0), so
both sides run the flash formulas and drop by the kernel hash; the
decoder's masked self-attention takes the plain path on both.

Tolerances, each with its reason:
- O0 (float32): every step's loss 1e-5 relative; the first moment / (1 -
  beta1) (the clipped gradients, summed over the steps) within 1e-4 of
  each tensor's max magnitude plus 1e-8; parameters within 2.5 * the sum
  of the steps' rates (an Adam step is about lr * sign(g), and a gradient
  that is 0 up to rounding may flip its sign);
- O1 (bf16 products): test_torch_train.py's, loss 2e-3 relative and
  moments within 5e-2 of the max plus 1e-5 (bf16 rounds at other points
  in XLA and torch); Llama over 3 steps, the Transformer over one, as
  test_torch_train.py holds its O1 step (with dropout everywhere the bf16
  roundings of a step move the two sides' next gradients apart beyond
  that);
- ``recompute=True`` against ``False`` in the port: bitwise (the same
  operations on the same inputs); against the JAX package's
  ``recompute=True``: O0's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.distributed import topology
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import attention as jattention
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.text.models import LlamaModel as JaxLlama
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.distributed import spmd as tspmd
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text.models import LlamaModel

torch.set_num_threads(2)

VOCAB, HIDDEN, LAYERS, HEADS, FFN = 256, 64, 2, 2, 128  # bench.py's LLAMA_SMOKE
SEQ, BATCH, STEPS = 64, 2, 3
MT = dict(d_model=64, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
          dim_feedforward=128, dropout=0.1)
MT_VOCAB, MT_SRC, MT_TGT, MT_BATCH = 101, 16, 12, 4
TOLS = {"O0": (1e-5, 1e-4, 1e-8), "O1": (2e-3, 5e-2, 1e-5)}


@pytest.fixture
def kernels_on_both_sides(monkeypatch):
    monkeypatch.setattr(jattention, "_use_pallas", lambda: True)
    paddle.set_flags({"pallas_attention_min_seq": 0})
    yield
    paddle.set_flags({"pallas_attention_min_seq": 1024})


def _state(layer):
    return {n: np.asarray(p.numpy()) for n, p in layer.named_parameters()}


def _mesh():
    return topology.build_mesh(dp=1, devices=jax.devices()[:1])


def _keys(i):
    return (jax.random.fold_in(jax.random.PRNGKey(0), i),
            trandom.fold_in(trandom.PRNGKey(0), i))


def _run(jpair, tpair, x, y, scheds, steps=STEPS, recompute=(False, False), **kw):
    """``steps`` steps of both training steps from the same weights;
    returns (losses, rates, params, states) per side."""
    (jlayer, jloss, jo), (tlayer, tloss, to) = jpair, tpair
    jstep, jinit = jspmd.build_train_step(jlayer, jloss, jo, mesh=_mesh(),
                                          recompute=recompute[0], **kw)
    tstep, tinit = tspmd.build_train_step(tlayer, tloss, to, recompute=recompute[1], **kw)
    jp, js = jinit()
    tp, ts = tinit()
    assert list(tp) == list(jp)
    out = {"j": ([], []), "t": ([], [])}
    for i in range(steps):
        jkey, tkey = _keys(i)
        assert jo.get_lr() == to.get_lr()
        out["j"][1].append(jo.get_lr())
        out["t"][1].append(to.get_lr())
        jl, jp, js = jstep(jp, js, jnp.asarray(x), jnp.asarray(y), key=jkey)
        tl, tp, ts = tstep(tp, ts, torch.from_numpy(x), torch.from_numpy(y), key=tkey)
        out["j"][0].append(float(jl))
        out["t"][0].append(float(tl))
        for s in scheds:
            s.step()
    return out, (jp, js), (tp, ts)


def _check(out, jside, tside, amp_level, beta1=0.9):
    tol_loss, tol_grad, floor = TOLS[amp_level]
    (jp, js), (tp, ts) = jside, tside
    assert all(np.isfinite(out["t"][0]))
    np.testing.assert_allclose(out["t"][0], out["j"][0], rtol=tol_loss)
    lr_sum = sum(out["t"][1])
    for n in tp:
        g_j = np.asarray(js[n][0]) / (1 - beta1)
        g_t = ts[n][0].numpy() / (1 - beta1)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=tol_grad * np.abs(g_j).max() + floor,
                                   err_msg=n)
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=0,
                                   atol=2.5 * lr_sum, err_msg=n)
        assert float(ts[n][2]) == float(js[n][2]) == len(out["t"][0])


# ------------------------------------------------------------------ Llama


def _lm_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    labels = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    return ids, labels


def _jax_lm_loss(logits, labels):
    # bench.py run_llama's loss
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _torch_lm_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1).mean()


def _llama_pair(num_kv_heads):
    cfg = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS, num_heads=HEADS,
               intermediate_size=FFN, num_kv_heads=num_kv_heads, max_seq_len=128)
    paddle.seed(0)
    jm = JaxLlama(**cfg)
    tm = LlamaModel(**cfg, device="cpu")
    load_numpy_state(tm, _state(jm))
    jm.train()
    tm.train()
    return jm, tm


def _lm_optimizers(jm, tm):
    """AdamW(weight decay 0.1, global-norm clip 1.0) on a warmup into a
    cosine decay, as bench.py's recipe with a schedule."""
    js = jlr.LinearWarmup(jlr.CosineAnnealingDecay(3e-3, T_max=8), 2, 1e-3, 3e-3)
    ts = tlr.LinearWarmup(tlr.CosineAnnealingDecay(3e-3, T_max=8), 2, 1e-3, 3e-3)
    jo = jopt.AdamW(js, parameters=jm.parameters(), weight_decay=0.1,
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    to = topt.AdamW(ts, parameters=tm.parameters(), weight_decay=0.1,
                    grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    return jo, to, (js, ts)


@pytest.mark.parametrize("num_kv_heads,amp_level", [(None, "O0"), (1, "O0"), (None, "O1")],
                         ids=["mha-O0", "gqa1-O0", "mha-O1"])
def test_llama_train_steps_match_jax(kernels_on_both_sides, num_kv_heads, amp_level):
    jm, tm = _llama_pair(num_kv_heads)
    jo, to, scheds = _lm_optimizers(jm, tm)
    x, y = _lm_batch()
    out, jside, tside = _run((jm, _jax_lm_loss, jo), (tm, _torch_lm_loss, to), x, y, scheds,
                             amp_level=amp_level)
    assert out["t"][1] == [1e-3, 2e-3, 3e-3]  # the scheduler's rates reached the steps
    _check(out, jside, tside, amp_level)
    assert out["t"][0][-1] < out["t"][0][0]


def test_recompute_is_bitwise_and_matches_jax_recompute(kernels_on_both_sides):
    """The port's ``recompute=True`` gives the same bits as ``False`` (loss,
    parameters, state) and agrees with the JAX package's
    ``recompute=True`` within O0's bounds."""
    x, y = _lm_batch()
    results = {}
    for recompute in (False, True):
        _, tm = _llama_pair(None)
        to = topt.AdamW(3e-3, parameters=tm.parameters(), weight_decay=0.1,
                        grad_clip=tnn.ClipGradByGlobalNorm(1.0))
        step, init = tspmd.build_train_step(tm, _torch_lm_loss, to, recompute=recompute)
        p, s = init()
        losses = []
        for i in range(2):
            loss, p, s = step(p, s, torch.from_numpy(x), torch.from_numpy(y), key=_keys(i)[1])
            losses.append(loss)
        results[recompute] = (losses, p, s)
    (l0, p0, s0), (l1, p1, s1) = results[False], results[True]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
        assert all(torch.equal(a, b) for a, b in zip(s0[n], s1[n])), n
    jm, tm = _llama_pair(None)
    jo, to, scheds = _lm_optimizers(jm, tm)
    out, jside, tside = _run((jm, _jax_lm_loss, jo), (tm, _torch_lm_loss, to), x, y, scheds,
                             steps=2, recompute=(True, True))
    _check(out, jside, tside, "O0")


def test_gqa_repeat_kv_backward_sums_the_query_heads():
    """``_repeat_kv``'s backward gives each KV head the sum of the
    gradients of the query heads it serves (jnp.repeat's transpose)."""
    from paddle_tpu_torch.text.models import _repeat_kv

    k = torch.randn(2, 2, 5, 4, dtype=torch.float64, requires_grad=True)
    g = torch.randn(2, 6, 5, 4, dtype=torch.float64)
    (dk,) = torch.autograd.grad(_repeat_kv(k, 3), k, g)
    torch.testing.assert_close(dk, g.reshape(2, 2, 3, 5, 4).sum(2), rtol=0, atol=0)
    # the JAX side runs in float32 (x64 off): the same sums, rounded there
    jdk = jax.grad(lambda a: jnp.sum(jnp.repeat(a, 3, axis=1) * g.float().numpy()))(
        k.detach().float().numpy())
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ Transformer


class _JaxTranslation(jnn.Layer):
    """The JAX twin of chip_smoke.translation_model's module."""

    def __init__(self, vocab, src_len, **cfg):
        super().__init__()
        self.transformer = jnn.Transformer(**cfg)
        self.embed = jnn.Embedding(vocab, cfg["d_model"])
        self.scale = cfg["d_model"] ** 0.5
        self.src_len = src_len
        self.dropout = cfg["dropout"]
        self.table = chip_smoke.sinusoid_table(chip_smoke.MT_POSITIONS, cfg["d_model"])

    def inputs(self, ids):
        x = self.embed(ids) * self.scale + JTensor(jnp.asarray(self.table[:ids.shape[1]]))
        return JF.dropout(x, self.dropout, training=self.training)

    def forward(self, packed):
        src, tgt = packed[:, :self.src_len], packed[:, self.src_len:]
        memory = self.transformer.encoder(self.inputs(src))
        mask = jnn.Transformer.generate_square_subsequent_mask(tgt.shape[1])
        out = self.transformer.decoder(self.inputs(tgt), memory, mask)
        return paddle.matmul(out, self.embed.weight, transpose_y=True)


def _jax_smoothed_loss(logits, labels):
    soft = JF.label_smooth(JF.one_hot(JTensor(labels), MT_VOCAB), epsilon=0.1)
    return JF.cross_entropy(JTensor(logits), soft, soft_label=True)._value


def _torch_smoothed_loss(logits, labels):
    soft = TF.label_smooth(TF.one_hot(labels, MT_VOCAB), epsilon=0.1)
    return TF.cross_entropy(logits, soft, soft_label=True)


def _translation_pair():
    """The JAX twin with every weight drawn from a numpy seed (its stacks
    start as copies of one layer), and the port's module with them."""
    jm = _JaxTranslation(MT_VOCAB, MT_SRC, **MT)
    rng = np.random.RandomState(5)
    for _, p in jm.named_parameters():
        scale = 0.05 if len(p.shape) == 1 else (2.0 / sum(p.shape)) ** 0.5
        p._value = jnp.asarray(rng.randn(*p.shape).astype(np.float32) * scale)
    tm = chip_smoke.translation_model(torch, tnn, "cpu", vocab=MT_VOCAB, src_len=MT_SRC, **MT)
    load_numpy_state(tm, _state(jm))
    jm.train()
    tm.train()
    return jm, tm


def _mt_batch():
    """Teacher forcing: the decoder reads [BOS, t0 .. t10] and learns
    t0 .. t11."""
    rng = np.random.RandomState(1)
    src = rng.randint(3, MT_VOCAB, (MT_BATCH, MT_SRC))
    tgt = rng.randint(3, MT_VOCAB, (MT_BATCH, MT_TGT))
    dec_in = np.concatenate([np.zeros((MT_BATCH, 1), np.int64), tgt[:, :-1]], 1)
    return np.concatenate([src, dec_in], 1).astype(np.int32), tgt.astype(np.int32)


@pytest.mark.parametrize("amp_level,steps", [("O0", STEPS), ("O1", 1)])
def test_transformer_label_smoothed_noam_steps_match_jax(kernels_on_both_sides, amp_level,
                                                         steps):
    """O0 over 3 steps; O1 over one, as test_torch_train.py holds its O1
    step (after a step the bf16 roundings of the two sides have moved the
    weights apart, and dropout 0.1 everywhere amplifies that)."""
    jm, tm = _translation_pair()
    js = jlr.NoamDecay(MT["d_model"], warmup_steps=4000, last_epoch=3999)
    ts = tlr.NoamDecay(MT["d_model"], warmup_steps=4000, last_epoch=3999)
    jo = jopt.Adam(js, beta1=0.9, beta2=0.98, epsilon=1e-9, parameters=jm.parameters())
    to = topt.Adam(ts, beta1=0.9, beta2=0.98, epsilon=1e-9, parameters=tm.parameters())
    x, y = _mt_batch()
    out, jside, tside = _run((jm, _jax_smoothed_loss, jo), (tm, _torch_smoothed_loss, to),
                             x, y, (js, ts), steps=steps, amp_level=amp_level)
    peak = 64 ** -0.5 * 4000 ** -0.5
    np.testing.assert_allclose(out["t"][1][0], peak, rtol=1e-12)
    _check(out, jside, tside, amp_level)
    assert steps == 1 or out["t"][0][-1] < out["t"][0][0]


# ------------------------------------------------------------------ functional


def test_label_smooth_and_one_hot_match_reference():
    ids = np.array([[0, 3, 9], [-1, 10, 2]], np.int32)  # -1 and 10: rows of zeros
    want = JF.one_hot(paddle.to_tensor(ids), 10).numpy()
    got = TF.one_hot(torch.from_numpy(ids), 10)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    prior = np.random.RandomState(2).dirichlet(np.ones(10)).astype(np.float32)
    for kw in (dict(), dict(epsilon=0.25)):
        np.testing.assert_allclose(
            TF.label_smooth(got, **kw).numpy(),
            JF.label_smooth(paddle.to_tensor(want), **kw).numpy(), rtol=1e-7)
    np.testing.assert_allclose(
        TF.label_smooth(got, prior_dist=torch.from_numpy(prior), epsilon=0.2).numpy(),
        JF.label_smooth(paddle.to_tensor(want), prior_dist=paddle.to_tensor(prior),
                        epsilon=0.2).numpy(), rtol=1e-7)
