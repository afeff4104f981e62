"""paddle_tpu_torch.distribution against paddle_tpu.distribution on the
CPU: the same seed gives the same key stream in both packages, so
``sample`` is held against the reference's samples: ``Categorical``'s
indices bitwise, ``Uniform``'s and ``Normal``'s within ``TOL_SAMPLE`` of
their max (XLA fuses ``u * (high - low) + low`` into an FMA, and
``torch.erfinv`` is not XLA's polynomial). ``log_prob``, ``probs``,
``entropy`` and ``kl_divergence`` within ``TOL`` of each output's max
(log, exp and the softmaxes round a last bit apart)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import distribution as jd
from paddle_tpu_torch import distribution as td
from paddle_tpu_torch.core import place as tplace

torch.set_num_threads(1)

TOL_SAMPLE = 1e-6  # an FMA (uniform) or erfinv (normal): a few ulp
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def both(seed=5):
    jp.seed(seed)
    tp.seed(seed)


def np_(t):
    return np.asarray(t.numpy())


RNG = np.random.RandomState(0)
LOW = RNG.rand(3).astype(np.float32)
HIGH = LOW + 1 + RNG.rand(3).astype(np.float32)
LOC = RNG.randn(2, 3).astype(np.float32)
SCALE = (RNG.rand(2, 3) + 0.5).astype(np.float32)
LOGITS = RNG.randn(4, 6).astype(np.float32)


def test_uniform():
    both()
    jdist, tdist = jd.Uniform(LOW, HIGH), td.Uniform(LOW, HIGH)
    for shape in ((), (5,), (2, 4)):
        js, ts = jdist.sample(shape), tdist.sample(shape)
        assert type(ts) is tp.Tensor and ts.dtype == torch.float32
        assert rel(np_(ts), np_(js)) <= TOL_SAMPLE
    v = np.stack([LOW - 0.1, (LOW + HIGH) / 2, HIGH + 0.1]).astype(np.float32)
    assert np.array_equal(np.isinf(np_(tdist.log_prob(v))), np.isinf(np_(jdist.log_prob(v))))
    fin = np.isfinite(np_(jdist.log_prob(v)))
    assert rel(np_(tdist.log_prob(v))[fin], np_(jdist.log_prob(v))[fin]) <= TOL
    assert rel(np_(tdist.probs(v)), np_(jdist.probs(v))) <= TOL
    assert rel(np_(tdist.entropy()), np_(jdist.entropy())) <= TOL


def test_normal():
    both(6)
    jdist, tdist = jd.Normal(LOC, SCALE), td.Normal(LOC, SCALE)
    for shape in ((), (7,)):
        assert rel(np_(tdist.sample(shape)), np_(jdist.sample(shape))) <= TOL_SAMPLE
    v = RNG.randn(2, 3).astype(np.float32)
    for m in ("log_prob", "probs"):
        assert rel(np_(getattr(tdist, m)(v)), np_(getattr(jdist, m)(v))) <= TOL, m
    assert rel(np_(tdist.entropy()), np_(jdist.entropy())) <= TOL
    other = (LOC[::-1].copy(), SCALE * 1.5)
    assert rel(np_(tdist.kl_divergence(td.Normal(*other))),
               np_(jdist.kl_divergence(jd.Normal(*other)))) <= TOL
    # parameters given as tensors keep their tensors' device
    assert td.Normal(torch.zeros(3), 1.0).scale.device.type == "cpu"


def test_categorical():
    both(7)
    jdist, tdist = jd.Categorical(LOGITS), td.Categorical(LOGITS)
    for shape in ((), (3,), (2, 5)):
        js, ts = jdist.sample(shape), tdist.sample(shape)
        assert ts.dtype == torch.int32 and tuple(ts.shape) == tuple(js.shape)
        np.testing.assert_array_equal(np_(ts), np_(js))
    idx = np.array([0, 5, 2, 3], np.int64)
    assert rel(np_(tdist.probs()), np_(jdist.probs())) <= TOL
    for m in ("probs", "log_prob"):
        assert rel(np_(getattr(tdist, m)(idx)), np_(getattr(jdist, m)(idx))) <= TOL, m
    assert rel(np_(tdist.entropy()), np_(jdist.entropy())) <= TOL
    other = LOGITS[::-1].copy()
    assert rel(np_(tdist.kl_divergence(td.Categorical(other))),
               np_(jdist.kl_divergence(jd.Categorical(other)))) <= TOL


def test_samples_follow_the_key_stream():
    """Two draws in a row take two keys, as in the reference: the second
    differs from the first and both match the reference's."""
    both(8)
    jdist, tdist = jd.Uniform(0.0, 1.0), td.Uniform(0.0, 1.0)
    a, b = tdist.sample((4,)), tdist.sample((4,))
    ja, jb = jdist.sample((4,)), jdist.sample((4,))
    assert not np.array_equal(np_(a), np_(b))
    assert rel(np_(a), np_(ja)) <= TOL_SAMPLE and rel(np_(b), np_(jb)) <= TOL_SAMPLE
