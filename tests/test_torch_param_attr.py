"""ParamAttr and the three repairs that came with the layer zoo, against
the JAX package where it has the same call:

- ``paddle.get_rng_state``/``set_rng_state`` save and restore the key
  stream and the initializers' generator both, so a restored state
  repeats the weights and the draws (the reference's one Generator feeds
  both);
- the ported layers take the reference's parameters (``weight_attr``,
  ``bias_attr``, the RNN cells' ``*_attr``, ``sparse``, ``Dropout``'s
  ``axis``/``mode``, ``F.gelu(approximate=)``, ``F.softmax``'s ``dtype``,
  ``BertModel(initializer_range=, pad_token_id=)``) in its positional
  order, and a ParamAttr acts as in the reference;
- every layer builds on the current place (``paddle.set_device``) unless
  given ``device=``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.text.models import BertModel

TINY_BERT = dict(vocab_size=16, hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=8)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


@pytest.mark.parametrize("P", [jp, tp], ids=["reference", "port"])
def test_set_rng_state_repeats_the_weights_and_the_draws(P):
    P.seed(1)
    state = P.get_rng_state()
    runs = []
    for _ in range(2):
        P.set_rng_state(state)
        lin = P.nn.Linear(3, 3)
        runs.append((np.array(lin.weight.numpy()), np.array(P.rand([3]).numpy())))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    fresh = np.array(P.nn.Linear(3, 3).weight.numpy())
    assert not np.array_equal(fresh, runs[0][0])


def test_the_reference_calls_are_accepted():
    nn, F = tp.nn, tp.nn.functional
    attr = tp.ParamAttr(initializer=nn.initializer.Constant(0.5))
    lin = nn.Linear(3, 2, attr, False)
    assert lin.bias is None and torch.equal(lin.weight.detach(), torch.full((3, 2), 0.5))
    assert nn.Linear(3, 2, weight_attr=attr).bias is not None
    emb = nn.Embedding(5, 3, None, True, attr)
    assert torch.equal(emb.weight.detach(), torch.full((5, 3), 0.5))
    ln = nn.LayerNorm(4, 1e-5, nn.initializer.Constant(2.0), False)
    assert ln.bias is None and torch.equal(ln.weight.detach(), torch.full((4,), 2.0))
    mha = nn.MultiHeadAttention(4, 2, 0.0, None, None, False, attr)
    assert torch.equal(mha.q_proj.weight.detach(), torch.full((4, 4), 0.5))
    for cls in (nn.TransformerEncoderLayer, nn.TransformerDecoderLayer):
        layer = cls(4, 2, 8, 0.1, "relu", None, None, False, attr, False)
        assert torch.equal(layer.linear1.weight.detach(), torch.full((4, 8), 0.5))
        assert layer.linear1.bias is None
    tr = nn.Transformer(4, 2, 1, 1, 8, 0.1, "relu", None, None, False, attr)
    assert torch.equal(tr.encoder.layers[0].linear2.weight.detach(), torch.full((8, 4), 0.5))
    for cell, extra in ((nn.SimpleRNNCell, ("tanh",)), (nn.LSTMCell, ()), (nn.GRUCell, ())):
        c = cell(3, 4, *extra, attr, None, nn.initializer.Constant(0.1), None)
        assert torch.equal(c.weight_ih.detach(), torch.full(tuple(c.weight_ih.shape), 0.5))
        assert torch.equal(c.bias_ih.detach(), torch.full(tuple(c.bias_ih.shape), 0.1))
    lstm = nn.LSTM(3, 4, 1, "forward", False, 0.0, attr)
    assert torch.equal(lstm.weight_ih_l0.detach(), torch.full((16, 3), 0.5))
    drop = nn.Dropout(0.5, axis=1, mode="downscale_in_infer").eval()
    x = tp.to_tensor(np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(drop(x).numpy(), np.full((2, 3), 0.5, np.float32))
    ref = jp.nn.Dropout(0.5, axis=1, mode="upscale_in_train")
    got = nn.Dropout(0.5, axis=1, mode="upscale_in_train")
    jp.seed(3)
    tp.seed(3)
    xs = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(got(tp.to_tensor(xs)).numpy(),
                                  ref(jp.to_tensor(xs)).numpy())
    v = tp.to_tensor(np.linspace(-2, 2, 6).astype(np.float32))
    jv = jp.to_tensor(np.linspace(-2, 2, 6).astype(np.float32))
    np.testing.assert_allclose(F.gelu(v, approximate=True).numpy(),
                               jp.nn.functional.gelu(jv, approximate=True).numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(F.softmax(v, dtype="float32").numpy(),
                               jp.nn.functional.softmax(jv, dtype="float32").numpy(), rtol=1e-6)
    F.log_softmax(v, dtype="float32")
    F.embedding(tp.to_tensor(np.array([1, 0])), emb.weight, sparse=True)
    bert = BertModel(**TINY_BERT, initializer_range=0.05, pad_token_id=1)
    assert bert.pooler is not None
    # with_pool is the 13th positional argument again, as in the reference
    args = (16, 8, 1, 2, 8, "gelu", 0.1, 0.1, 32, 2, 0.02, 0, False)
    assert BertModel(*args).pooler is None


def test_param_attr_acts_as_the_reference():
    """initializer, learning_rate and trainable=False of a weight_attr, a
    name, and bias_attr=False, in both packages."""
    got = {}
    for P in (jp, tp):
        I = P.nn.initializer
        w = np.arange(6, dtype=np.float32).reshape(2, 3) / 10
        attr = P.ParamAttr(name="w_frozen", initializer=I.Assign(w), learning_rate=0.25,
                           trainable=False)
        lin = P.nn.Linear(2, 3, weight_attr=attr, bias_attr=P.ParamAttr(
            initializer=I.Constant(0.3), learning_rate=2.0))
        conv = P.nn.Conv2D(2, 4, 3, weight_attr=I.Constant(0.1), bias_attr=False)
        got[P] = dict(weight=np.array(lin.weight.numpy()), bias=np.array(lin.bias.numpy()),
                      name=lin.weight.name, sg=lin.weight.stop_gradient,
                      bias_sg=lin.bias.stop_gradient,
                      lr=(lin.weight.optimize_attr["learning_rate"],
                          lin.bias.optimize_attr["learning_rate"]),
                      conv=np.array(conv.weight.numpy()), conv_bias=conv.bias is None)
    j, t = got[jp], got[tp]
    for k in j:
        if isinstance(j[k], np.ndarray):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            assert t[k] == j[k], k
    assert t["sg"] and not t["bias_sg"] and t["name"] == "w_frozen" and t["conv_bias"]


def test_trainable_false_is_left_by_the_optimizer():
    lin = tp.nn.Linear(2, 2, weight_attr=tp.ParamAttr(trainable=False))
    before = lin.weight.detach().clone()
    opt = tp.optimizer.SGD(0.1, parameters=lin.parameters())
    lin(tp.to_tensor(np.ones((1, 2), np.float32))).sum().backward()
    opt.step()
    assert torch.equal(lin.weight.detach(), before)
    assert not torch.equal(lin.bias.detach(), torch.zeros(2))


def test_layers_follow_the_current_place():
    """After set_device("cpu") the layers, a vision model and BERT build on
    the CPU with no device given; an explicit device still wins."""
    assert tp.nn.Linear(3, 3).weight.device.type == "cpu"
    m = tp.vision.models.resnet18()
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    assert {b.device.type for b in m.buffers()} == {"cpu"}
    bert = BertModel(**TINY_BERT)
    assert {p.device.type for p in bert.parameters()} == {"cpu"}
    for layer in (tp.nn.LayerNorm(4), tp.nn.Embedding(4, 2), tp.nn.LSTM(2, 3),
                  tp.nn.TransformerEncoderLayer(4, 2, 8), tp.nn.Conv2D(2, 2, 3),
                  tp.nn.BatchNorm2D(2)):
        assert {t.device.type for t in (*layer.parameters(), *layer.buffers())} == {"cpu"}
    assert tp.nn.Linear(3, 3, device="cpu").weight.device.type == "cpu"
    mask = tp.nn.Transformer.generate_square_subsequent_mask(3)
    assert mask.device.type == "cpu"
