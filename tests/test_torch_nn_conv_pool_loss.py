"""The port's conv, pooling and loss ops (paddle_tpu_torch/nn/functional/
conv.py, pooling.py, loss.py) against the JAX package's on the CPU: the
cases of tests/nn_layer_cases.py (inputs made with numpy from a seed,
tolerances stated there) through both packages, compared by
tests/test_torch_api_cases.py's harness. tests/test_torch_nn_layers.py
holds the other sections and the name checks."""
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from nn_layer_cases import CONV, LOSS, POOLING
from paddle_tpu_torch.core import place as tplace
from test_torch_api_cases import _run
from test_torch_api_cases import check as check_runs

HERE = {**CONV, **POOLING, **LOSS}


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


@pytest.mark.parametrize("name", sorted(HERE))
def test_functional(name):
    check_runs(name, HERE[name], lambda c, s: _run(tp, c, s), lambda c, s: _run(jp, c, s))
