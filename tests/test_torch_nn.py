"""The port's layers (paddle_tpu_torch/nn) against the JAX package's, with
the weights carried across by paddle_tpu_torch/convert.py. Inputs come
from a numpy seed; tolerance 1e-5 in float32."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)

TOL = 1e-5


def _state(jlayer):
    return {n: np.asarray(p.numpy()) for n, p in jlayer.named_parameters()}


def _pair(jlayer, tlayer):
    """Carry jlayer's weights into tlayer; both in eval mode."""
    jlayer.eval()
    tlayer.eval()
    assert list(_state(jlayer)) == [n for n, _ in tlayer.named_parameters()]
    load_numpy_state(tlayer, _state(jlayer))
    return jlayer, tlayer


def _run(jlayer, tlayer, *arrays):
    jout = jlayer(*[None if a is None else paddle.to_tensor(a) for a in arrays])
    with torch.inference_mode():
        tout = tlayer(*[None if a is None else torch.from_numpy(a) for a in arrays])
    return np.asarray(jout.numpy()), tout.numpy()


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_linear_weight_layout_and_output():
    j, t = _pair(jnn.Linear(16, 24), tnn.Linear(16, 24, device="cpu"))
    assert tuple(t.weight.shape) == (16, 24)  # [in, out] as in Paddle
    a, b = _run(j, t, _x(3, 5, 16))
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("padding_idx", [None, 2])
def test_embedding(padding_idx):
    # the JAX Embedding(padding_idx=...) constructor cannot zero its row on
    # this jax (read-only view), so the padded case is held against the
    # JAX functional with the same weight
    j, t = _pair(jnn.Embedding(10, 8), tnn.Embedding(10, 8, device="cpu"))
    t._padding_idx = padding_idx
    ids = np.array([[0, 2, 9], [2, 5, 1]], np.int32)
    a = np.asarray(JF.embedding(paddle.to_tensor(ids), j.weight,
                                padding_idx=padding_idx).numpy())
    with torch.inference_mode():
        b = t(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    if padding_idx is not None:
        assert np.all(b[ids == padding_idx] == 0.0)
        row = tnn.Embedding(10, 8, padding_idx=padding_idx, device="cpu").weight
        assert torch.all(row[padding_idx] == 0.0)


def test_layer_norm():
    j, t = _pair(jnn.LayerNorm(32), tnn.LayerNorm(32, device="cpu"))
    # non-trivial affine parameters, carried across
    j.weight.set_value(_x(32, seed=1))
    j.bias.set_value(_x(32, seed=2))
    load_numpy_state(t, _state(j))
    a, b = _run(j, t, 3.0 * _x(4, 7, 32) + 1.0)
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["gelu", "tanh", "relu"])
def test_activations(name):
    x = 4.0 * _x(5, 33)
    a = np.asarray(getattr(JF, name)(paddle.to_tensor(x)).numpy())
    b = getattr(TF, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_dropout_eval_is_identity_and_training_raises():
    layer = tnn.Dropout(0.1)
    x = torch.randn(3, 4)
    assert torch.equal(layer.eval()(x), x)
    assert torch.equal(tnn.Dropout(0.0)(x), x)
    with pytest.raises(NotImplementedError, match="training slice"):
        layer.train()(x)


def _mha_mask(kind, b=2, s=12):
    if kind is None:
        return None
    keep = np.ones((b, 1, 1, s), bool)
    keep[1, ..., 8:] = False
    if kind == "bool":
        return keep
    return np.where(keep, 0.0, -1e4).astype(np.float32)


@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_multi_head_attention_fused_qkv(mask):
    j, t = _pair(jnn.MultiHeadAttention(32, 4), tnn.MultiHeadAttention(32, 4, device="cpu"))
    x = _x(2, 12, 32)
    m = _mha_mask(mask)
    a = np.asarray(j(paddle.to_tensor(x), attn_mask=None if m is None
                     else paddle.to_tensor(m)).numpy())
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        b = t(xt, attn_mask=None if m is None else torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_multi_head_attention_cross():
    j, t = _pair(jnn.MultiHeadAttention(32, 4), tnn.MultiHeadAttention(32, 4, device="cpu"))
    x, mem = _x(2, 6, 32), _x(2, 10, 32, seed=1)
    a = np.asarray(j(paddle.to_tensor(x), paddle.to_tensor(mem),
                     paddle.to_tensor(mem)).numpy())
    with torch.inference_mode():
        b = t(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(mem)).numpy()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_transformer_encoder_layer(normalize_before, activation):
    kw = dict(activation=activation, normalize_before=normalize_before)
    j, t = _pair(jnn.TransformerEncoderLayer(32, 4, 64, **kw),
                 tnn.TransformerEncoderLayer(32, 4, 64, device="cpu", **kw))
    a, b = _run(j, t, _x(2, 12, 32), _mha_mask("float"))
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_transformer_encoder_layers_are_independent_copies():
    j = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(32, 4, 64), 3)
    t = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(32, 4, 64, device="cpu"), 3)
    # give each JAX layer its own weights, then carry them across
    for i, layer in enumerate(j.layers):
        layer.linear1.weight.set_value(_x(32, 64, seed=10 + i))
    j, t = _pair(j, t)
    w = [layer.linear1.weight for layer in t.layers]
    assert w[0].data_ptr() != w[1].data_ptr() and not torch.equal(w[0], w[1])
    a, b = _run(j, t, _x(2, 12, 32))
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_convert_is_a_checked_copy():
    t = tnn.Linear(4, 3, device="cpu")
    good = {"weight": _x(4, 3), "bias": _x(3)}
    load_numpy_state(t, good)
    np.testing.assert_array_equal(t.weight.detach().numpy(), good["weight"])
    before = t.weight.detach().clone()
    with pytest.raises(KeyError):
        load_numpy_state(t, {"weight": good["weight"]})
    with pytest.raises(KeyError):
        load_numpy_state(t, {**good, "extra": good["bias"]})
    with pytest.raises(ValueError):
        load_numpy_state(t, {**good, "weight": _x(3, 4)})
    with pytest.raises(TypeError):
        load_numpy_state(t, {**good, "weight": good["weight"].astype(np.float64)})
    assert torch.equal(t.weight.detach(), before)  # nothing copied on failure
