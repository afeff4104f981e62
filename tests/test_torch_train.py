"""The port's training path (paddle_tpu_torch: optimizer, clip, amp,
BertForPretraining, distributed/spmd.py build_train_step) against the JAX
package's, with the JAX model's weights carried across and inputs made from
a numpy seed.

Tolerances, each with its reason:
- optimizer ``_update`` and global-norm clip: 1e-6 relative (the same
  float32 formulas, summed in another order);
- pretraining forward and loss in eval mode: 1e-4 abs (as
  tests/test_torch_bert.py);
- one ``build_train_step`` step at bench.py's smoke config, hidden and
  attention dropout 0.1 on both sides under the same key. The JAX side
  takes its Pallas kernels in interpret mode for the unmasked attention
  (``_use_pallas`` patched, ``pallas_attention_min_seq`` 0), so both sides
  drop by the kernel hash. O0: loss 1e-5 relative; clipped gradients
  (AdamW's first moment / (1 - beta1)) within 1e-4 of each tensor's max
  magnitude plus 1e-8; updated parameters within 2.5 * lr, because AdamW's
  first step is about lr * sign(g) and a gradient that is 0 up to rounding
  (the key-projection bias: softmax ignores it) may flip its sign. O1:
  loss 2e-3 relative and gradients within 5e-2 of each tensor's max
  magnitude plus 1e-5 (bf16 products round at other points in XLA and in
  torch), updated parameters within 2.5 * lr. O2 (every op but the black
  list in bf16) is held to the O1 tolerances.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import random as jrandom
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.distributed import topology
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import attention as jattention
from paddle_tpu.text.models import BertForPretraining as JaxPretraining
from paddle_tpu.text.models import bert_pretraining_loss as jax_pretraining_loss
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import cuda_build
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.distributed import spmd as tspmd
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.models import BertForPretraining, bert_pretraining_loss

# the module (paddle_tpu.amp's attribute of this name is the function)
jamp = importlib.import_module("paddle_tpu.amp.auto_cast")

torch.set_num_threads(2)

SMOKE = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=256,
             hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
SEQ, PRED, BATCH, LR = 64, 20, 4, 1e-4


def _state(layer):
    return {n: np.asarray(p.numpy()) for n, p in layer.named_parameters()}


# ------------------------------------------------------------------ optimizer


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("cls,hypers", [
    ("Adam", dict(b1=0.9, b2=0.999, eps=1e-8, l2=0.0)),
    ("Adam", dict(b1=0.8, b2=0.99, eps=1e-6, l2=0.01)),
    ("AdamW", dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, l2=0.0)),
    ("AdamW", dict(b1=0.85, b2=0.95, eps=1e-7, wd=0.1, l2=0.0)),
])
def test_update_matches_reference(cls, hypers):
    jcls, tcls = getattr(jopt, cls), getattr(topt, cls)
    p, m, v = _rand(5, 7, seed=1), np.zeros((5, 7), np.float32), np.zeros((5, 7), np.float32)
    jstate = (jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), jnp.zeros((), jnp.float32))
    tstate = (torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(v),
              torch.zeros((), dtype=torch.float32))
    for step in range(4):
        g = _rand(5, 7, seed=10 + step)
        jout = jcls._update(jstate[0], jnp.asarray(g), jnp.asarray(3e-3, jnp.float32),
                            *jstate[1:], **hypers)
        tout = tcls._update(tstate[0], torch.from_numpy(g), torch.tensor(3e-3),
                            *tstate[1:], **hypers)
        for a, b in zip(jout, tout):
            assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
        jstate, tstate = jout, tout


@pytest.mark.parametrize("clip_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(clip_norm):
    grads = [_rand(4, 6, seed=1), _rand(9, seed=2), _rand(3, 2, 2, seed=3)]
    want = jnn.ClipGradByGlobalNorm(clip_norm).clip_arrays([jnp.asarray(g) for g in grads])
    clip = tnn.ClipGradByGlobalNorm(clip_norm)
    got = clip.clip_arrays([torch.from_numpy(g) for g in grads])
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)
    # the (param, grad) form leaves params with need_clip=False untouched
    params = [torch.nn.Parameter(torch.zeros(1)) for _ in grads]
    params[1].need_clip = False
    pairs = clip(list(zip(params, [torch.from_numpy(g) for g in grads])))
    assert torch.equal(pairs[1][1], torch.from_numpy(grads[1]))
    assert clip.clip_arrays([None]) == [None]


def test_eager_step_matches_reference_apply():
    """Optimizer.step() on torch Parameters with .grad set equals the
    reference's apply_gradients_arrays (clip, then _update) over 3 steps."""
    ps = {"a": _rand(6, 4, seed=1), "b": _rand(4, seed=2)}
    tparams = [torch.nn.Parameter(torch.from_numpy(ps[n].copy())) for n in ps]
    topt_ = topt.AdamW(2e-2, parameters=tparams, weight_decay=0.05,
                       grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    jopt_ = jopt.AdamW(2e-2, parameters=[], weight_decay=0.05,
                       grad_clip=jnn.ClipGradByGlobalNorm(0.5))
    jparams = {n: jnp.asarray(a) for n, a in ps.items()}
    jstate = jopt_.init_state_arrays(jparams)
    for step in range(3):
        grads = {n: _rand(*a.shape, seed=20 + step) * 3 for n, a in ps.items()}
        for p, n in zip(tparams, ps):
            p.grad = torch.from_numpy(grads[n])
        topt_.step()
        topt_.clear_grad()
        assert all(p.grad is None for p in tparams)
        jparams, jstate = jopt_.apply_gradients_arrays(
            jparams, {n: jnp.asarray(g) for n, g in grads.items()}, jstate)
    for p, n in zip(tparams, ps):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]),
                                   rtol=1e-6, atol=1e-7)


def test_optimizer_refuses_what_is_not_ported():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(NotImplementedError, match="schedulers"):
        topt.AdamW(learning_rate=lambda: 0.1, parameters=p)
    with pytest.raises(NotImplementedError, match="regularizer"):
        topt.Adam(parameters=p, weight_decay=object())
    with pytest.raises(NotImplementedError):
        topt.AdamW(parameters=p, apply_decay_param_fun=lambda n: True)


# ------------------------------------------------------------------ amp


def test_auto_cast_lists_are_the_reference_lists():
    assert tamp.AMP_WHITE_LIST == jamp.AMP_WHITE_LIST
    assert tamp.AMP_BLACK_LIST == jamp.AMP_BLACK_LIST


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_cast_inputs_follow_the_lists(level):
    x = torch.randn(3, 4, requires_grad=True)
    ids = torch.arange(3)
    assert tamp.cast_inputs("linear", x) == (x,)  # no auto_cast: untouched
    with tamp.auto_cast(level=level):
        (w,) = tamp.cast_inputs("linear", x)
        (b,) = tamp.cast_inputs("layer_norm", x.to(torch.bfloat16))
        g, i = tamp.cast_inputs("gelu", x, ids)
        with tamp.auto_cast(enable=False):
            assert tamp.target_dtype("matmul") is None
        assert tamp.target_dtype("matmul") == torch.bfloat16
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert i is ids
    assert g.dtype == (torch.bfloat16 if level == "O2" else torch.float32)
    # master weights stay float32: the gradient comes back through the cast
    (w.float().sum() + g.float().sum()).backward()
    assert x.grad.dtype == torch.float32
    with tamp.auto_cast(level="O1", custom_black_list=["linear"]):
        assert tamp.target_dtype("linear") == torch.float32


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_reference(reduction, weighted):
    logits = _rand(3, 5, 11, seed=4)
    labels = np.random.RandomState(5).randint(0, 11, (3, 5)).astype(np.int32)
    labels[0, :2] = -100  # ignored
    weight = np.abs(_rand(11, seed=6)) if weighted else None
    want = JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(labels),
                            weight=None if weight is None else paddle.to_tensor(weight),
                            reduction=reduction)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           weight=None if weight is None else torch.from_numpy(weight),
                           reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-6, atol=1e-6)


def test_soft_label_and_column_labels_match_reference():
    logits = _rand(4, 6, seed=7)
    soft = np.abs(_rand(4, 6, seed=8))
    soft /= soft.sum(-1, keepdims=True)
    col = np.array([[1], [0], [5], [2]], np.int64)
    probs = np.abs(logits) / np.abs(logits).sum(-1, keepdims=True)
    for kw, lab, x in ((dict(soft_label=True), soft, logits), ({}, col, logits),
                       (dict(use_softmax=False), col, probs)):
        want = JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(lab), **kw)
        got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-6)


# ------------------------------------------------------------------ model


@pytest.fixture(scope="module")
def pretraining():
    paddle.seed(0)
    jm = JaxPretraining(**SMOKE)
    tm = BertForPretraining(**SMOKE, device="cpu")
    load_numpy_state(tm, _state(jm))
    return jm, tm


def test_named_parameters_match_jax_name_by_name(pretraining):
    jm, tm = pretraining
    jnames = [n for n, _ in jm.named_parameters()]
    tnames = [n for n, _ in tm.named_parameters()]
    assert tnames == jnames and len(tnames) == 46
    assert tnames.index("cls.decoder_bias") < tnames.index("cls.transform.weight")
    assert "cls.decoder_weight" not in tnames
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _state(jm)[n])


def test_convert_carries_the_tied_weight():
    paddle.seed(1)
    jm = JaxPretraining(**SMOKE)
    state = _state(jm)
    tm = BertForPretraining(**SMOKE, device="cpu")
    word = "bert.embeddings.word_embeddings.weight"
    # a state_dict-style copy that lists the tie under both names is taken
    load_numpy_state(tm, {**state, "cls.decoder_weight": state[word]})
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    np.testing.assert_array_equal(tm.cls.decoder_weight.detach().numpy(), state[word])
    with pytest.raises(ValueError, match="tied"):
        load_numpy_state(tm, {**state, "cls.decoder_weight": state[word] + 1.0})
    with pytest.raises(KeyError):
        load_numpy_state(tm, {n: a for n, a in state.items() if n != word})


def test_pretraining_forward_and_loss_match_jax(pretraining):
    jm, tm = pretraining
    jm.eval()
    tm.eval()
    rng = np.random.RandomState(3)
    ids = rng.randint(0, SMOKE["vocab_size"], (2, SEQ)).astype(np.int32)
    pos = np.stack([rng.choice(SEQ, PRED, replace=False) for _ in range(2)]).astype(np.int32)
    mlm = rng.randint(0, SMOKE["vocab_size"], (2, PRED)).astype(np.int32)
    mlm[1, 3:7] = -1  # ignored
    nsp = np.array([0, 1], np.int32)
    try:
        jl, jn = jm(paddle.to_tensor(ids), masked_positions=paddle.to_tensor(pos))
        jloss = jax_pretraining_loss(jl, jn, paddle.to_tensor(mlm), paddle.to_tensor(nsp),
                                     ignore_index=-1)
        with torch.no_grad():
            tl, tn = tm(torch.from_numpy(ids), masked_positions=torch.from_numpy(pos))
            tloss = bert_pretraining_loss(tl, tn, torch.from_numpy(mlm), torch.from_numpy(nsp),
                                          ignore_index=-1)
    finally:
        jm.train()
        tm.train()
    assert tuple(tl.shape) == (2, PRED, SMOKE["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn.numpy()), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss.numpy()), rtol=1e-5)


def test_masked_attention_dropout_matches_jax(pretraining):
    """With an attention mask both sides run plain attention, whose dropout
    is ``fast_keep_mask`` over [b, h, q, k] keyed by both key words."""
    jm, tm = pretraining
    ids = np.random.RandomState(4).randint(0, SMOKE["vocab_size"], (2, SEQ)).astype(np.int32)
    keep = np.ones((2, 1, 1, SEQ), bool)
    keep[1, ..., 50:] = False
    with jrandom.rng_guard(jax.random.PRNGKey(21)):
        jl, _ = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(keep))
    with torch.no_grad(), trandom.rng_guard(trandom.PRNGKey(21)):
        tl, _ = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()), rtol=0, atol=1e-4)


# ------------------------------------------------------------------ train step


class _JaxWrapper(jnn.Layer):
    """bench.py's TrainWrapper: packed [ids | positions] in, MLM logits out."""

    def __init__(self, inner, seq_len):
        super().__init__()
        self.inner = inner
        self.seq_len = seq_len

    def forward(self, packed):
        return self.inner(packed[:, :self.seq_len],
                          masked_positions=packed[:, self.seq_len:])[0]


class _TorchWrapper(torch.nn.Module):
    def __init__(self, inner, seq_len):
        super().__init__()
        self.inner = inner
        self.seq_len = seq_len

    def forward(self, packed):
        return self.inner(packed[:, :self.seq_len],
                          masked_positions=packed[:, self.seq_len:])[0]


def _jax_loss(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0])


def _torch_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0].mean()


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMOKE["vocab_size"], (BATCH, SEQ))
    pos = np.stack([rng.choice(SEQ, PRED, replace=False) for _ in range(BATCH)])
    labels = rng.randint(0, SMOKE["vocab_size"], (BATCH, PRED)).astype(np.int32)
    return np.concatenate([ids, pos], 1).astype(np.int32), labels


def _opt(mod, model):
    return mod.AdamW(LR, parameters=model.parameters(), weight_decay=0.01,
                     grad_clip=(jnn if mod is jopt else tnn).ClipGradByGlobalNorm(1.0))


@pytest.mark.parametrize("amp_level,tol_loss,tol_grad,floor_grad", [
    ("O0", 1e-5, 1e-4, 1e-8), ("O1", 2e-3, 5e-2, 1e-5), ("O2", 2e-3, 5e-2, 1e-5)])
def test_train_step_matches_jax(monkeypatch, amp_level, tol_loss, tol_grad, floor_grad):
    monkeypatch.setattr(jattention, "_use_pallas", lambda: True)
    paddle.set_flags({"pallas_attention_min_seq": 0})
    try:
        paddle.seed(0)
        jw = _JaxWrapper(JaxPretraining(**SMOKE), SEQ)
        tw = _TorchWrapper(BertForPretraining(**SMOKE, device="cpu"), SEQ)
        state = _state(jw)
        load_numpy_state(tw, state)
        jstep, jinit = jspmd.build_train_step(
            jw, _jax_loss, _opt(jopt, jw), mesh=topology.build_mesh(dp=1, devices=jax.devices()[:1]),
            amp_level=amp_level)
        tstep, tinit = tspmd.build_train_step(tw, _torch_loss, _opt(topt, tw),
                                              amp_level=amp_level)
        x, y = _batch()
        jp, js = jinit()
        tp, ts = tinit()
        assert list(tp) == list(jp)
        jloss, jp, js = jstep(jp, js, jnp.asarray(x), jnp.asarray(y),
                              key=jax.random.fold_in(jax.random.PRNGKey(0), 3))
        tloss, tp, ts = tstep(tp, ts, torch.from_numpy(x), torch.from_numpy(y),
                              key=trandom.fold_in(trandom.PRNGKey(0), 3))
    finally:
        paddle.set_flags({"pallas_attention_min_seq": 1024})
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol_loss)
    for n in tp:
        g_j = np.asarray(js[n][0]) / (1 - 0.9)
        g_t = ts[n][0].numpy() / (1 - 0.9)
        atol = tol_grad * np.abs(g_j).max() + floor_grad
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=atol, err_msg=n)
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=0,
                                   atol=2.5 * LR, err_msg=n)
        assert float(ts[n][2]) == float(js[n][2]) == 1.0  # the step counter t
    assert not np.array_equal(tp["inner.cls.decoder_bias"].numpy(),
                              state["inner.cls.decoder_bias"])


def test_train_step_takes_the_reference_keys_and_donates():
    """A step takes 1 + 3 * layers keys from the guarded key, the same
    key gives the same loss, another key another loss; donate=True updates
    the given tensors in place, donate=False leaves them."""
    torch.manual_seed(0)
    tw = _TorchWrapper(BertForPretraining(**SMOKE, device="cpu"), SEQ)
    x, y = (torch.from_numpy(a) for a in _batch())
    taken = []
    real = trandom.next_key

    def spy():
        taken.append(real())
        return taken[-1]

    step, init = tspmd.build_train_step(tw, _torch_loss, _opt(topt, tw), donate=False)
    params, st = init()
    before = {n: p.clone() for n, p in params.items()}
    trandom.next_key, saved = spy, trandom.next_key
    try:
        loss1, new, _ = step(params, st, x, y, key=trandom.PRNGKey(1))
    finally:
        trandom.next_key = saved
    assert taken == [trandom.fold_in(trandom.PRNGKey(1), i) for i in range(7)]
    assert all(torch.equal(params[n], before[n]) for n in params)
    assert not torch.equal(new["inner.cls.decoder_bias"], params["inner.cls.decoder_bias"])
    loss2, _, _ = step(params, init()[1], x, y, key=trandom.PRNGKey(1))
    loss3, _, _ = step(params, init()[1], x, y, key=trandom.PRNGKey(2))
    assert float(loss1) == float(loss2) != float(loss3)
    step, init = tspmd.build_train_step(tw, _torch_loss, _opt(topt, tw))
    params, st = init()
    ref = params["inner.cls.decoder_bias"]
    _, out, out_st = step(params, st, x, y)
    assert out["inner.cls.decoder_bias"] is ref and float(out_st["inner.cls.decoder_bias"][2]) == 1
    assert not torch.equal(ref, before["inner.cls.decoder_bias"])


@pytest.mark.parametrize("option", [
    dict(mesh=object()), dict(recompute=True), dict(shard_optimizer=True),
    dict(sharding_stage=2), dict(fp16_allreduce=True), dict(dgc_configs={}),
    dict(strategy=object()), dict(offload=True), dict(bad_step_guard=True)])
def test_unported_train_step_options_raise(option):
    m = tnn.Linear(2, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        tspmd.build_train_step(m, lambda out, y: out.sum(), topt.AdamW(parameters=m.parameters()),
                               **option)


def test_train_step_amp_level_and_buffers_are_checked():
    m = tnn.Linear(2, 2, device="cpu")
    opt = topt.AdamW(parameters=m.parameters())
    with pytest.raises(ValueError):
        tspmd.build_train_step(m, lambda out, y: out.sum(), opt, amp_level="O3")
    m.register_buffer("stat", torch.zeros(2))
    with pytest.raises(NotImplementedError, match="buffers"):
        tspmd.build_train_step(m, lambda out, y: out.sum(), opt)


# ------------------------------------------------------------------ cuda_build


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes (directly or through
    another header) changes that library's hash; editing anything else does
    not. No nvcc is needed to compute it."""
    (tmp_path / "common.cuh").write_text('#include "inner.cuh"\nint a;\n')
    (tmp_path / "inner.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int c;\n")
    (tmp_path / "k1.cu").write_text('#include "common.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "k2.cu").write_text('#include "other.cuh"\n')
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    assert cuda_build._sources("k1") == ["k1.cu", "common.cuh", "inner.cuh"]
    h1, h2 = cuda_build.source_hash("k1"), cuda_build.source_hash("k2")
    (tmp_path / "inner.cuh").write_text("int b2;\n")
    assert cuda_build.source_hash("k1") != h1
    assert cuda_build.source_hash("k2") == h2
    h1 = cuda_build.source_hash("k1")
    (tmp_path / "other.cuh").write_text("int c2;\n")
    assert cuda_build.source_hash("k1") == h1 and cuda_build.source_hash("k2") != h2
    assert cuda_build._target("k1")[1].endswith(f"libk1-{h1}.so")


def test_port_kernels_share_one_dropout_hash_header():
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert "flash_attention_common.cuh" in cuda_build._sources(name)


@pytest.mark.parametrize("name,headers", [
    ("flash_attention_fwd", ["flash_attention_common.cuh", "flash_attention_f32.cuh",
                             "flash_attention_sm90.cuh"]),
    ("flash_attention_bwd_dq", ["flash_attention_common.cuh", "flash_attention_f32.cuh",
                                "flash_attention_sm90.cuh"]),
    ("flash_attention_bwd_dkv", ["flash_attention_common.cuh", "flash_attention_f32.cuh",
                                 "flash_attention_sm90.cuh"]),
])
def test_each_kernel_library_hashes_every_header_it_includes(name, headers):
    """A library is rebuilt when any csrc header it includes changes: the
    three kernels share the dropout hash, the f32 products and the sm90
    PTX."""
    assert cuda_build._sources(name) == [name + ".cu"] + headers
