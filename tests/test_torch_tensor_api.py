"""The port's ``paddle.*`` tensor namespace (paddle_tpu_torch/tensor/)
against the JAX package's (paddle_tpu/tensor/), op by op: one case per
public function of each reference module, the same numpy-seeded inputs
through both, the value and the dtype compared, and ``paddle.grad`` of a
seeded weighted sum of the float outputs where the op is differentiable.

The cases, the harness and the tolerances are in
tests/test_torch_api_cases.py (chip_smoke.py runs the same cases on the
card). This file holds the name check and the creation and math cases;
test_torch_tensor_api_shape.py (manipulation, logic, search) and
test_torch_tensor_api_linalg.py (linalg, stat, random, einsum,
attribute, to_string) hold the rest, so ``--dist loadfile`` spreads them.
"""
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as tplace
from test_torch_api_cases import CREATION, MATH, _run
from test_torch_api_cases import check as check_runs

MODULES = ["creation", "math", "manipulation", "logic", "search", "stat", "linalg",
           "random", "einsum", "attribute", "to_string"]


def reference_names(module):
    """The public functions of paddle_tpu.tensor.<module>, as the
    reference's own module defines them."""
    import importlib

    mod = importlib.import_module("paddle_tpu.tensor." + module)
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and callable(getattr(mod, n)) and not isinstance(getattr(mod, n), type)
                  and (getattr(getattr(mod, n), "__module__", "") or "")
                  .startswith("paddle_tpu.tensor"))


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev




@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def check(name, case):
    """The port against the JAX package, both on the CPU."""
    check_runs(name, case, lambda c, s: _run(tp, c, s), lambda c, s: _run(jp, c, s))


@pytest.mark.parametrize("module", MODULES)
def test_port_has_every_public_function(module):
    import importlib

    port = importlib.import_module("paddle_tpu_torch.tensor." + module)
    missing = [n for n in reference_names(module) if not callable(getattr(port, n, None))]
    assert not missing, f"paddle_tpu_torch.tensor.{module} lacks {missing}"
    top = [n for n in reference_names(module) if not callable(getattr(tp, n, None))
           and callable(getattr(jp, n, None))]
    assert not top, f"paddle_tpu_torch lacks the top-level {top}"


def covered(cases, modules):
    """Every reference name of ``modules`` has a case (the name check's
    partner: a function without a case would go untested)."""
    names = set()
    for m in modules:
        names |= set(reference_names(m))
    return sorted(names - set(cases))


def test_every_creation_and_math_function_has_a_case():
    assert covered({**CREATION, **MATH}, ["creation", "math"]) == []


@pytest.mark.parametrize("name", sorted(CREATION))
def test_creation(name):
    check(name, CREATION[name])


@pytest.mark.parametrize("name", sorted(MATH))
def test_math(name):
    check(name, MATH[name])
