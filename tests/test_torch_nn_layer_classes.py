"""The port's nn layer classes (paddle_tpu_torch/nn/layers/: activation,
common, container, conv, pooling, norm, loss, distance; nn/utils'
spectral_norm) against the JAX package's, class by class, on the CPU:
each built in both packages with the same parameters and buffers (drawn
from a seed by sorted name), the cases and their tolerances in
tests/nn_layer_cases.py. The initializers are held here too: the
deterministic ones bitwise, the random ones by their law."""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from nn_layer_cases import LAYER_ALIASES, LAYERS
from paddle_tpu_torch.core import place as tplace
from test_torch_api_cases import _run
from test_torch_api_cases import check as check_runs

MODULES = ["activation", "common", "container", "conv", "distance", "loss", "norm", "pooling"]


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def reference_classes():
    import importlib

    names = set()
    for m in MODULES:
        mod = importlib.import_module("paddle_tpu.nn.layers." + m)
        names |= {n for n, c in vars(mod).items() if isinstance(c, type) and not n.startswith("_")
                  and c.__module__ == mod.__name__}
    return sorted(names)


def test_every_layer_class_is_ported_with_its_signature():
    for name in reference_classes():
        got = getattr(tp.nn, name, None)
        assert isinstance(got, type), f"paddle_tpu_torch.nn lacks {name}"
        want = [p for p in inspect.signature(getattr(jp.nn, name).__init__).parameters
                if p != "self"]
        have = [p for p, v in inspect.signature(got.__init__).parameters.items()
                if p != "self" and v.kind != v.KEYWORD_ONLY]
        assert have == want, name


def test_every_layer_class_has_a_case():
    missing = set(reference_classes()) - set(LAYERS) - set(LAYER_ALIASES)
    assert not missing, sorted(missing)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    check_runs(name, LAYERS[name], lambda c, s: _run(tp, c, s), lambda c, s: _run(jp, c, s))


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.25,), (3, 4)),
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), (3, 4)),
    ("Dirac", (), (4, 2, 3, 3)),
    ("Dirac", (2,), (6, 3, 3)),
    ("Bilinear", (), (2, 2, 4, 4)),
])
def test_deterministic_initializers_equal_the_reference(name, args, shape):
    want = getattr(jp.nn.initializer, name)(*args)._generate(shape, np.float32)
    got = getattr(tp.nn.initializer, name)(*args)(shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_initializers_follow_their_laws():
    g = torch.Generator().manual_seed(0)
    I = tp.nn.initializer
    shape = (64, 32, 3, 3)
    fan_in, fan_out = 32 * 9, 64 * 9
    tn = I.TruncatedNormal(0.5, 2.0)((4000,), g)
    assert tn.min() >= 0.5 - 4.0 and tn.max() <= 0.5 + 4.0 and abs(float(tn.mean()) - 0.5) < 0.1
    xu = I.XavierUniform()(shape, g)
    assert float(xu.abs().max()) <= np.sqrt(6.0 / (fan_in + fan_out))
    kn = I.KaimingNormal()(shape, g)
    assert abs(float(kn.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.05
    ku = I.KaimingUniform(fan_in=10, negative_slope=np.sqrt(5.0), nonlinearity="leaky_relu")
    assert float(ku((100, 100), g).abs().max()) <= np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / 10)
    for shape in ((5, 3), (3, 5), (4, 2, 3)):
        q = I.Orthogonal(gain=2.0)(shape, g).reshape(-1, shape[-1])
        gram = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
        torch.testing.assert_close(gram, 4.0 * torch.eye(gram.shape[0]), atol=1e-5, rtol=0)
    p = tp.create_parameter([2, 3], "float32")
    I.Constant(1.5)(p)  # an initializer re-initializes a parameter in place
    assert torch.equal(p.detach(), torch.full((2, 3), 1.5))


def test_set_global_initializer_as_the_reference():
    """The global initializers fill what neither the ParamAttr nor the layer
    initializes (a Bilinear's weight, every bias); Linear's XavierNormal
    default still wins."""
    got = {}
    for P in (jp, tp):
        P.nn.initializer.set_global_initializer(P.nn.initializer.Constant(0.3),
                                                P.nn.initializer.Constant(0.7))
        try:
            lin, bil = P.nn.Linear(3, 2), P.nn.Bilinear(2, 2, 3)
        finally:
            P.nn.initializer.set_global_initializer(None, None)
        got[P] = (np.asarray(lin.bias.numpy()), np.asarray(bil.weight.numpy()),
                  np.asarray(lin.weight.numpy()))
    for a, b in zip(got[tp][:2], got[jp][:2]):
        np.testing.assert_array_equal(a, b)
    assert not np.all(got[tp][2] == 0.3)
    assert float(tp.nn.Linear(3, 2).bias.detach().sum()) == 0.0
