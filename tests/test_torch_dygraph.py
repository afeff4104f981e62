"""The port's dygraph path (paddle_tpu_torch: nn.Layer, the Tensor
boundary, eager loss.backward() / opt.step()) against the JAX package's
eager loop:

- a tiny BERT (2 layers, hidden 32) trained four dygraph steps in both
  packages, hidden and attention dropout 0.1 and AdamW, the JAX model's
  weights carried across by ``state_dict`` (convert.load_state_dict), the
  losses within the reference's own rtol=1e-5
  (tests/test_to_static_models.py:62). Dropout draws the global key
  stream in both; the JAX side takes its Pallas attention in interpret
  mode (``_use_pallas`` patched, ``pallas_attention_min_seq`` 0) so that
  both drop attention by the kernel hash;
- ``Layer.state_dict()`` names equal to the JAX ``Layer``'s;
- an ``nn.Layer`` subclass written in Paddle's style, with forward hooks,
  its outputs and gradients within 1e-5 of their largest magnitude;
- ``set_flags`` refusing a non-default value of a flag the port has no
  knob for.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.ops import attention as jattention
from paddle_tpu.text.models import BertForPretraining as JaxPretraining
from paddle_tpu.text.models import bert_pretraining_loss as jax_loss
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.text.models import BertForPretraining, bert_pretraining_loss

TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64,
            hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
BATCH, SEQ, PRED, STEPS, LR = 2, 16, 3, 4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _numpy_state(layer):
    return {n: np.asarray(v.numpy()) for n, v in layer.state_dict().items()}


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(0, TINY["vocab_size"], (BATCH, SEQ)).astype(np.int32)
        types = rng.randint(0, 2, (BATCH, SEQ)).astype(np.int32)
        pos = np.stack([rng.choice(SEQ, PRED, replace=False) for _ in range(BATCH)]
                       ).astype(np.int32)
        mlm = rng.randint(0, TINY["vocab_size"], (BATCH, PRED)).astype(np.int32)
        nsp = rng.randint(0, 2, (BATCH,)).astype(np.int32)
        out.append((ids, types, pos, mlm, nsp))
    return out


def _train(P, model, loss_fn):
    """The dygraph loop a Paddle user writes."""
    opt = P.optimizer.AdamW(LR, parameters=model.parameters(), weight_decay=0.01)
    P.seed(7)
    losses = []
    for ids, types, pos, mlm, nsp in _batches():
        mlm_logits, nsp_logits = model(P.to_tensor(ids), P.to_tensor(types),
                                       masked_positions=P.to_tensor(pos))
        loss = loss_fn(mlm_logits, nsp_logits, P.to_tensor(mlm), P.to_tensor(nsp))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return np.asarray(losses)


def test_tiny_bert_dygraph_training_matches_jax(monkeypatch):
    monkeypatch.setattr(jattention, "_use_pallas", lambda: True)
    jp.set_flags({"pallas_attention_min_seq": 0})
    try:
        jp.seed(0)
        jmodel = JaxPretraining(**TINY)
        tmodel = BertForPretraining(**TINY, device="cpu")
        load_state_dict(tmodel, _numpy_state(jmodel))
        want = _train(jp, jmodel, jax_loss)
        got = _train(tp, tmodel, bert_pretraining_loss)
    finally:
        jp.set_flags({"pallas_attention_min_seq": 1024})
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the weights moved together too, within lr / 10; AdamW moves each by
    # about lr * sign(g) a step, and a gradient that is 0 but for rounding
    # (the key projections' biases, which softmax ignores) may take either
    # sign, so those are held to 2.5 lr a step
    jstate, tstate = _numpy_state(jmodel), _numpy_state(tmodel)
    for name in jstate:
        tol = 2.5 * LR * STEPS if name.endswith("k_proj.bias") else LR / 10
        np.testing.assert_allclose(tstate[name], jstate[name], rtol=0, atol=tol, err_msg=name)


def test_tensor_boundary_keeps_the_modules_plain():
    """A port Layer given Tensors runs on plain tensors inside and returns
    Tensors; given torch tensors it returns torch tensors, the same bits."""
    torch.manual_seed(0)
    m = BertForPretraining(**{**TINY, "hidden_dropout_prob": 0.0,
                              "attention_probs_dropout_prob": 0.0}, device="cpu")
    seen = []
    m.bert.encoder.layers[0].register_forward_hook(lambda mod, a, out: seen.append(type(a[0])))
    ids = np.random.RandomState(1).randint(0, TINY["vocab_size"], (2, SEQ)).astype(np.int32)
    plain_out = m(torch.from_numpy(ids))
    wrapped = m(tp.to_tensor(ids))
    assert type(plain_out[0]) is torch.Tensor and type(wrapped[0]) is tp.Tensor
    assert seen == [torch.Tensor, torch.Tensor]
    assert torch.equal(plain_out[0], torch.Tensor.as_subclass(wrapped[0], torch.Tensor))
    assert wrapped[0].shape == [2, SEQ, TINY["vocab_size"]]


def test_state_dict_names_equal_the_jax_layers():
    jp.seed(0)
    jm = JaxPretraining(**TINY)
    tm = BertForPretraining(**TINY, device="cpu")
    assert list(tm.state_dict()) == list(jm.state_dict())
    state = _numpy_state(jm)
    load_state_dict(tm, state)
    for name, arr in _numpy_state(tm).items():
        assert np.array_equal(arr, state[name]), name
    bad = dict(state)
    bad.pop(next(iter(bad)))
    with pytest.raises(KeyError):
        load_state_dict(tm, bad)
    bad = {**state, "cls.decoder_bias": state["cls.decoder_bias"][:-1]}
    with pytest.raises(ValueError):
        load_state_dict(tm, bad)
    bad = {**state, "cls.decoder_bias": state["cls.decoder_bias"].astype(np.int32)}
    with pytest.raises(TypeError):
        load_state_dict(tm, bad)
    missing, unexpected = tm.set_state_dict({"nope": np.zeros(1, np.float32)})
    assert unexpected == ["nope"] and len(missing) == len(state)


def _mlp(P):
    class MLP(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w1 = self.create_parameter([4, 8])
            self.b1 = self.create_parameter([8], is_bias=True)
            self.head = P.nn.Linear(8, 3, **({"device": "cpu"} if P is tp else {}))
            self.register_buffer("scale", P.to_tensor(np.float32([2.0])))
            self.register_buffer("tmp", P.to_tensor(np.float32([1.0])), persistable=False)

        def forward(self, x):
            h = P.tanh(P.add(P.matmul(x, self.w1), self.b1)) * self.scale
            return self.head(h)

    return MLP


def test_layer_subclass_with_hooks():
    xv = np.random.RandomState(2).standard_normal((5, 4)).astype(np.float32)

    def run(P):
        P.seed(3)
        m = _mlp(P)()
        rng = np.random.RandomState(4)
        for name, p in m.named_parameters():
            p.set_value(rng.standard_normal(tuple(p.shape)).astype(np.float32))
        calls = []
        pre = m.register_forward_pre_hook(lambda layer, inputs: (inputs[0] * 0.5,))
        post = m.head.register_forward_post_hook(
            lambda layer, inputs, out: calls.append(type(out).__name__) or out + 1.0)
        x = P.to_tensor(xv)
        y = m(x)
        pre.remove()
        post.remove()
        y2 = m(x)
        loss = (y * y).sum()
        loss.backward()
        names = list(m.state_dict())
        grads = [p.grad.numpy() for p in m.parameters()]
        m.clear_gradients()
        assert all(p.grad is None for p in m.parameters())
        subs = [type(s).__name__ for s in m.sublayers()]
        return names, calls, subs, [y.numpy(), y2.numpy()] + grads

    tn, tc, ts, tv = run(tp)
    jn, jc, js, jv = run(jp)
    assert tn == jn == ["w1", "b1", "head.weight", "head.bias", "scale"]
    assert tc == ["Tensor"] and ts == js == ["Linear"]
    for g, w in zip(tv, jv):
        w = np.asarray(w)
        assert np.max(np.abs(g - w)) <= 1e-5 * np.max(np.abs(w))


def test_layer_to_astype_and_modes():
    m = _mlp(tp)()
    assert m.training
    m.eval()
    assert not m.training and not m.head.training
    m.train()
    assert m.head.training
    m.astype("bfloat16")
    assert m.w1.dtype == torch.bfloat16 and isinstance(m.w1, tp.Parameter)
    m.to(dtype="float32")
    m.to("cpu")
    assert m.head.weight.dtype == torch.float32 and m.w1.place == tp.CPUPlace()
    assert m.full_name().startswith("mlp_")
    assert [n for n, _ in m.named_sublayers()] == ["head"]
    assert len(m.parameters(include_sublayers=False)) == 2


@pytest.mark.parametrize("flag,value", [
    ("FLAGS_pallas_attention_min_seq", 0), ("sdpa_softmax_fp32", False),
    ("eager_jit_ops", False), ("use_pallas_kernels", False),
    ("cudnn_deterministic", True), ("allocator_strategy", "naive_best_fit"),
    ("fraction_of_gpu_memory_to_use", 0.5)])
def test_set_flags_refuses_a_knob_the_port_lacks(flag, value):
    default = tp.get_flags(flag)[flag]
    tp.set_flags({flag: default})  # the default is accepted
    with pytest.raises(tp.errors.UnimplementedError):
        tp.set_flags({flag: value})
    assert tp.get_flags(flag)[flag] == default


def test_flags_that_act():
    tp.set_flags({"benchmark": True})
    try:
        assert float(tp.add(tp.to_tensor(1.0), 2.0)) == 3.0
    finally:
        tp.set_flags({"benchmark": False})
    tp.set_default_dtype("float32")
    assert tp.get_flags("default_dtype")["default_dtype"] == "float32"
    with pytest.raises(KeyError):
        tp.set_flags({"no_such_flag": 1})
