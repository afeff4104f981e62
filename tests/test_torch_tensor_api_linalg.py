"""The port's linalg, stat, random, einsum, attribute and to_string ops
against the JAX package's, op by op (cases, harness and tolerances:
tests/test_torch_api_cases.py), and the Poisson sampler's rejection
branch, which its case (rates below 10) does not reach.
"""
import numpy as np
import pytest

from test_torch_api_cases import LINALG, OTHER, POISSON_OFF, RANDOM, STAT
from test_torch_tensor_api import _on_the_cpu, check, covered  # noqa: F401


def test_poisson_rejection_branch_from_rate_10():
    """Rates from 10 run the transformed-rejection loop: its counts agree
    with the reference's but for a share POISSON_OFF (a log or lgamma
    rounding flips an acceptance), and every count is the same where both
    accepted on the same draw."""
    import paddle_tpu as jp
    import paddle_tpu_torch as tp

    lam = np.random.RandomState(3).uniform(10.0, 60.0, (40, 25)).astype(np.float32)
    tp.seed(5)
    jp.seed(5)
    got = tp.poisson(tp.to_tensor(lam)).numpy()
    want = jp.poisson(jp.to_tensor(lam)).numpy()
    assert got.dtype == want.dtype == np.float32
    off = float(np.mean(got != want))
    assert off <= POISSON_OFF, f"{off:.3f} of the counts differ"
    assert abs(float(got.mean()) - float(lam.mean())) < 1.0


def test_every_linalg_stat_random_and_attribute_function_has_a_case():
    assert covered({**LINALG, **STAT, **RANDOM, **OTHER},
                   ["linalg", "stat", "random", "einsum", "attribute", "to_string"]) == []


@pytest.mark.parametrize("name", sorted(LINALG))
def test_linalg(name):
    check(name, LINALG[name])


@pytest.mark.parametrize("name", sorted(STAT))
def test_stat(name):
    check(name, STAT[name])


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random(name):
    check(name, RANDOM[name])


@pytest.mark.parametrize("name", sorted(OTHER))
def test_einsum_attribute_and_print_options(name):
    check(name, OTHER[name])
