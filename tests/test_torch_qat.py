"""The port's quantization-aware training and int8 conv
(paddle_tpu_torch/quantization: imperative.py, post_training.py) against
the JAX package's, on the CPU, inputs from a numpy seed and weights carried
across by ``convert.load_state_dict``.

Tolerances:
- ``fake_quant``, the int8 weights and their scales: bitwise (the port
  rounds as the reference's compiled op does);
- ``QuantedLinear``/``QuantedConv2D`` forward outputs and gradients: 1e-5
  of their max magnitude (float32 products summed in another order by XLA
  and by ATen); ``act_scale`` after each train step and in eval: 1e-6
  relative (an abs-max of those outputs);
- ``Int8Conv2D`` and the int8 models: 1e-5 of the output's max.
The cases of the reference's tests/test_quantization.py on ``SmallConvNet``
that need no ``jit.save`` are ported as they are, with their own bounds.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import quantization as jq
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core import place as tplace

torch.set_num_threads(2)
TOL = 1e-5
TOL_SCALE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _np(v):
    v = getattr(v, "_value", v)
    return np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)


def _state(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


def close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{what}: {err:.3e}"


class JNet(jp.nn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = jp.nn.Conv2D(1, 4, 3, padding=1)
        self.fc = jp.nn.Linear(4 * 8 * 8, 10)

    def forward(self, x):
        h = jp.nn.functional.relu(self.conv(x))
        return self.fc(h.reshape((h.shape[0], -1)))


class TNet(tp.nn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = tp.nn.Conv2D(1, 4, 3, padding=1)
        self.fc = tp.nn.Linear(4 * 8 * 8, 10)

    def forward(self, x):
        h = tp.nn.functional.relu(self.conv(x))
        return self.fc(h.reshape((h.shape[0], -1)))


def pair(seed=0, qat=False):
    """The reference's SmallConvNet (seed) and the port's with its state,
    QAT-wrapped in both when ``qat``."""
    jp.seed(seed)
    jm, tm = JNet(), TNet()
    if qat:
        jq.ImperativeQuantAware().quantize(jm)
        tq.ImperativeQuantAware().quantize(tm)
    load_state_dict(tm, _state(jm))
    return jm, tm


def images(b=4, seed=0):
    return np.random.RandomState(seed).randn(b, 1, 8, 8).astype(np.float32)


# ------------------------------------------------------------ fake_quant
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_fake_quant_bitwise(axis):
    rng = np.random.RandomState(3)
    for scale_mul in (0.4, 1.0):
        x = (rng.randn(37, 19) * rng.choice([0.01, 3.0])).astype(np.float32)
        amax = np.abs(x).max() if axis is None else np.abs(x).max(axis=1 - axis)
        scale = (np.asarray(amax) * scale_mul).astype(np.float32)
        import jax.numpy as jnp

        want = _np(jq.fake_quant(jp.to_tensor(x), jnp.asarray(scale), per_channel_axis=axis))
        got = tq.fake_quant(torch.from_numpy(x), torch.from_numpy(np.asarray(scale)),
                            per_channel_axis=axis).numpy()
        assert np.array_equal(got, want), (axis, scale_mul)


def test_values_on_grid():
    x = tp.to_tensor(np.linspace(-1, 1, 11).astype(np.float32))
    out = tq.fake_quant(x, 1.0, bits=8)
    step = 1.0 / 127
    grid = np.round(out.numpy() / step) * step
    np.testing.assert_allclose(out.numpy(), grid, atol=1e-7)


def test_ste_gradient_identity():
    x = tp.to_tensor(np.array([0.3, -0.7, 5.0], np.float32), stop_gradient=False)
    y = tq.fake_quant(x, 1.0)
    (y * tp.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, 2.0, 3.0])
    xb = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
    tq.fake_quant(xb, 1.0).sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and torch.equal(xb.grad, torch.ones_like(xb))


def test_per_channel():
    w = tp.to_tensor(np.array([[0.5, 100.0], [-0.25, -50.0]], np.float32))
    out = tq.fake_quant(w, np.array([0.5, 100.0], np.float32), per_channel_axis=1).numpy()
    assert abs(out[1, 0] + 0.25) < 0.5 / 127 + 1e-6
    assert abs(out[1, 1] + 50.0) < 100.0 / 127 + 1e-6


# ------------------------------------------------------------ QAT layers
def _layer_pair(kind):
    jp.seed(5)
    if kind == "linear":
        jl, tl = jp.nn.Linear(12, 6), tp.nn.Linear(12, 6)
        wrap_j, wrap_t, shape = jq.QuantedLinear, tq.QuantedLinear, (5, 12)
    else:
        jl, tl = jp.nn.Conv2D(3, 4, 3, stride=2, padding=1), tp.nn.Conv2D(3, 4, 3, stride=2,
                                                                          padding=1)
        wrap_j, wrap_t, shape = jq.QuantedConv2D, tq.QuantedConv2D, (2, 3, 9, 9)
    jw, tw = wrap_j(jl), wrap_t(tl)
    load_state_dict(tw, _state(jw))
    return jw, tw, shape


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_quanted_layer_forward_gradients_and_act_scale(kind):
    jw, tw, shape = _layer_pair(kind)
    assert sorted(tw.state_dict()) == sorted(jw.state_dict())
    rng = np.random.RandomState(7)
    for k in range(3):  # k train steps: the moving-average scale
        x = (rng.randn(*shape) * (1 + k)).astype(np.float32)
        jx, tx = jp.to_tensor(x, stop_gradient=False), tp.to_tensor(x, stop_gradient=False)
        jo, to = jw(jx), tw(tx)
        close(to, jo, TOL, f"{kind} forward, step {k}")
        r = rng.randn(*jo.shape).astype(np.float32)
        (jo * jp.to_tensor(r)).sum().backward()
        (to * tp.to_tensor(r)).sum().backward()
        close(tx.grad, jx.grad, TOL, "input gradient")
        close(tw.inner.weight.grad, jw.inner.weight.grad, TOL, "weight gradient")
        close(tw.inner.bias.grad, jw.inner.bias.grad, TOL, "bias gradient")
        close(tw.act_scale, jw.act_scale, TOL_SCALE, f"act_scale after step {k}")
        for layer in (jw.inner, tw.inner):
            layer.clear_gradients()
    scale = float(tw.act_scale)
    jw.eval()
    tw.eval()
    x = (rng.randn(*shape) * 9).astype(np.float32)  # beyond the calibrated range
    close(tw(tp.to_tensor(x)), jw(jp.to_tensor(x)), TOL, "eval forward")
    assert float(tw.act_scale) == scale  # frozen in eval
    close(tw.act_scale, jw.act_scale, TOL_SCALE, "eval act_scale")


def test_uncalibrated_eval_falls_back_to_the_live_abs_max():
    jw, tw, shape = _layer_pair("linear")
    jw.eval()
    tw.eval()
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    close(tw(tp.to_tensor(x)), jw(jp.to_tensor(x)), TOL, "uncalibrated eval")
    assert float(tw.act_scale) == 0.0


def test_quantize_nested_layers_names_the_reference():
    def build(nn, q):
        net = nn.Sequential(nn.Conv2D(1, 2, 3), nn.Sequential(nn.Linear(4, 4), nn.ReLU()),
                            nn.Linear(4, 2))
        q.ImperativeQuantAware(quantizable_layer_type=("Linear", "Conv2D")).quantize(net)
        return net

    jp.seed(0)
    jm = build(jp.nn, jq)
    tm = build(tp.nn, tq)
    assert isinstance(tm[0], tq.QuantedConv2D)
    assert isinstance(tm[1][0], tq.QuantedLinear) and isinstance(tm[2], tq.QuantedLinear)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert "1.0.inner.weight" in tm.state_dict() and "0.act_scale" in tm.state_dict()
    tq.ImperativeQuantAware().quantize(tm)  # again: wrappers are not wrapped twice
    assert isinstance(tm[0].inner, tp.nn.Conv2D)
    only_linear = tq.ImperativeQuantAware(quantizable_layer_type=("Linear",)).quantize(
        tp.nn.Sequential(tp.nn.Conv2D(1, 2, 3), tp.nn.Linear(2, 2)))
    assert isinstance(only_linear[0], tp.nn.Conv2D)
    assert isinstance(only_linear[1], tq.QuantedLinear)


def test_qat_model_state_and_steps_match_the_reference():
    """A reference QAT SmallConvNet's state dict (inner.* and act_scale)
    loads into the port's QAT model; three Adam steps then agree."""
    jm, tm = pair(seed=4, qat=True)
    jopt = jp.optimizer.Adam(1e-3, parameters=jm.parameters())
    topt = tp.optimizer.Adam(1e-3, parameters=tm.parameters())
    rng = np.random.RandomState(2)
    for k in range(3):
        x, y = images(8, k), rng.randint(0, 10, (8,))
        jl = jp.nn.functional.cross_entropy(jm(jp.to_tensor(x)), jp.to_tensor(y))
        tl = tp.nn.functional.cross_entropy(tm(tp.to_tensor(x)), tp.to_tensor(y))
        assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
        jl.backward()
        tl.backward()
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        for name in ("conv.act_scale", "fc.act_scale"):
            close(tm.state_dict()[name], jm.state_dict()[name], TOL_SCALE, name)
    for name, v in _state(jm).items():
        close(tm.state_dict()[name], v, 1e-4, name)


# ------------------------------------------------------------ int8 conv, PTQ
def test_int8_conv_and_quantize_weights_match_the_reference():
    jm, tm = pair(seed=3)
    x = images(4, 0)
    _, jstats = jq.quantize_weights(jm)
    _, tstats = tq.quantize_weights(tm)
    assert sorted(tstats) == sorted(jstats) == ["conv", "fc"]
    assert isinstance(tm.conv, tq.Int8Conv2D) and isinstance(tm.fc, tq.Int8Linear)
    assert tm.conv.qweight.dtype == torch.int8
    for name in ("conv", "fc"):
        tl, jl = getattr(tm, name), getattr(jm, name)
        assert np.array_equal(tl.qweight.numpy(), _np(jl.qweight)), name
        assert np.array_equal(tl.w_scale.numpy(), _np(jl.w_scale)), name
        assert np.array_equal(tstats[name].numpy(), jstats[name]), name
    close(tm(tp.to_tensor(x)), jm(jp.to_tensor(x)), TOL, "int8 SmallConvNet")
    # a quantize_weights'd reference model's state (int8 qweight, w_scale)
    # loads into the port's
    _, fresh = pair(seed=9)
    tq.quantize_weights(fresh)
    state = _state(jm)
    assert state["conv.qweight"].dtype == np.int8
    load_state_dict(fresh, state)
    close(fresh(tp.to_tensor(x)), jm(jp.to_tensor(x)), TOL, "loaded int8 model")


@pytest.mark.parametrize("act_quant", [False, True])
def test_ptq_calibrates_the_conv(act_quant):
    jm, tm = pair(seed=4)

    def samples():
        rng = np.random.RandomState(5)
        for _ in range(4):
            yield rng.randn(2, 1, 8, 8).astype(np.float32)

    jptq = jq.PostTrainingQuantization(jm, samples, batch_nums=3)
    tptq = tq.PostTrainingQuantization(tm, samples, batch_nums=3)
    jptq.quantize(act_quant=act_quant)
    tptq.quantize(act_quant=act_quant)
    assert sorted(tptq.activation_scales) == sorted(jptq.activation_scales) == ["conv", "fc"]
    for name, v in jptq.activation_scales.items():
        assert abs(tptq.activation_scales[name] - v) <= TOL_SCALE * v, name
    assert np.array_equal(tptq.weight_scales["conv"].numpy(), jptq.weight_scales["conv"])
    assert (tm.conv.act_scale is None) == (not act_quant)
    x = images(2, 6)
    close(tm(tp.to_tensor(x)), jm(jp.to_tensor(x)), TOL, "PTQ model")
    # it saves through jit.save, which needs an input spec (the reference's too)
    with pytest.raises(ValueError, match="input_spec"):
        tptq.save_quantized_model("nowhere")


# ------------------------------------- the reference's SmallConvNet cases
def test_quantize_swaps_layers():
    tp.seed(0)
    m = TNet()
    tq.ImperativeQuantAware().quantize(m)
    assert isinstance(m.conv, tq.QuantedConv2D)
    assert isinstance(m.fc, tq.QuantedLinear)


def test_qat_trains():
    tp.seed(0)
    m = TNet()
    tq.ImperativeQuantAware().quantize(m)
    opt = tp.optimizer.Adam(1e-3, parameters=m.parameters())
    rng = np.random.RandomState(0)
    x = tp.to_tensor(rng.randn(16, 1, 8, 8).astype(np.float32))
    y = tp.to_tensor(rng.randint(0, 10, (16,)))
    losses = []
    for _ in range(15):
        loss = tp.nn.functional.cross_entropy(m(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses
    assert float(m.conv.act_scale) > 0


def test_eval_close_to_fp32():
    tp.seed(1)
    m = TNet()
    x = tp.to_tensor(images(4, 1))
    ref = m(x).numpy()
    tq.ImperativeQuantAware().quantize(m)
    m.eval()
    out = m(x).numpy()
    assert np.max(np.abs(out - ref)) < 0.15 * np.max(np.abs(ref))


def test_weight_only_int8():
    tp.seed(3)
    m = TNet()
    x = tp.to_tensor(images(4, 0))
    ref = m(x).numpy()
    _, stats = tq.quantize_weights(m)
    assert set(stats) == {"conv", "fc"}
    assert m.conv.qweight.dtype == torch.int8
    out = m(x).numpy()
    assert np.max(np.abs(out - ref)) < 0.1 * np.max(np.abs(ref))


def test_save_quantized_model_raises():
    tp.seed(2)
    m = TNet()
    q = tq.ImperativeQuantAware()
    q.quantize(m)
    # it saves through jit.save, which needs an input spec (the reference's too)
    with pytest.raises(ValueError, match="input_spec"):
        q.save_quantized_model(m, "nowhere")
