"""The port's paddle.nn.functional (paddle_tpu_torch/nn/functional/)
against the JAX package's, op by op, on the CPU: the cases of
tests/nn_layer_cases.py (their inputs made with numpy from a seed, their
tolerances stated there) through both packages, outputs, dtypes and the
gradients of a seeded weighted sum compared by tests/test_torch_api_cases.py's
harness. This file holds the activation, common and norm ops; the conv,
pooling and loss ops are in tests/test_torch_nn_conv_pool_loss.py and the
layer classes in tests/test_torch_nn_layer_classes.py, so that
``--dist loadfile`` spreads them."""
import inspect

import numpy as np

import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from nn_layer_cases import ACTIVATION, COMMON, FUNCTIONAL, FUNCTIONAL_ELSEWHERE, NORM
from paddle_tpu_torch.core import place as tplace
from test_torch_api_cases import _run
from test_torch_api_cases import check as check_runs


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def reference_functional_names():
    mod = jp.nn.functional
    return sorted(n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n))
                  and getattr(getattr(mod, n), "__module__", "") == mod.__name__)


def test_every_functional_name_is_ported_with_its_signature():
    for name in reference_functional_names():
        got = getattr(tp.nn.functional, name, None)
        assert callable(got), f"paddle_tpu_torch.nn.functional lacks {name}"
        want = list(inspect.signature(getattr(jp.nn.functional, name)).parameters)
        assert list(inspect.signature(got).parameters) == want, name


def test_every_functional_name_has_a_case():
    missing = set(reference_functional_names()) - set(FUNCTIONAL) - set(FUNCTIONAL_ELSEWHERE)
    assert not missing, sorted(missing)


HERE = {**ACTIVATION, **COMMON, **NORM}


@pytest.mark.parametrize("name", sorted(HERE))
def test_functional(name):
    check_runs(name, HERE[name], lambda c, s: _run(tp, c, s), lambda c, s: _run(jp, c, s))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_casts_as_the_reference(level):
    """Under auto_cast each op takes the reference's dtype: conv and its
    transposes on the white list (bf16), the norms on the black list (f32),
    pooling and activations their input's dtype under O1 and bf16 under
    O2; a conv -> BatchNorm -> ReLU -> max pool chain as ResNet's stem."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    wt = rng.standard_normal((3, 2, 2, 2)).astype(np.float32)
    got = {}
    for P in (jp, tp):
        F = P.nn.functional
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            y = F.conv2d(P.to_tensor(x), P.to_tensor(w), padding=1)
            z = F.batch_norm(y, P.to_tensor(np.zeros(4, np.float32)),
                             P.to_tensor(np.ones(4, np.float32)), training=True)
            r = F.relu(z)
            m = F.max_pool2d(r, 2)
            t = F.conv2d_transpose(P.to_tensor(x), P.to_tensor(wt), stride=2)
            g = F.group_norm(y, 2)
            a = F.adaptive_avg_pool2d(y, 1)
        got[P] = [str(v.dtype).split(".")[-1].replace("paddle_tpu_", "")
                  for v in (y, z, r, m, t, g, a)]
    want = [np.dtype(d).name if not isinstance(d, str) else d for d in got[jp]]
    assert [d.lower() for d in got[tp]] == [d.lower() for d in want], (got[tp], want)
    assert want[:2] == ["bfloat16", "float32"], want
