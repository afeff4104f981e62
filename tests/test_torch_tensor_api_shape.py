"""The port's manipulation, logic and search ops against the JAX
package's, op by op (the harness and tolerances are
test_torch_tensor_api.py's). Index arguments are int32, the reference's
index dtype; results are held bitwise, values and dtypes."""
import pytest

from test_torch_api_cases import LOGIC, MANIPULATION, SEARCH
from test_torch_tensor_api import _on_the_cpu, check, covered  # noqa: F401


def test_every_manipulation_logic_and_search_function_has_a_case():
    assert covered({**MANIPULATION, **LOGIC, **SEARCH},
                   ["manipulation", "logic", "search"]) == []


@pytest.mark.parametrize("name", sorted(MANIPULATION))
def test_manipulation(name):
    check(name, MANIPULATION[name])


@pytest.mark.parametrize("name", sorted(LOGIC))
def test_logic(name):
    check(name, LOGIC[name])


@pytest.mark.parametrize("name", sorted(SEARCH))
def test_search(name):
    check(name, SEARCH[name])
