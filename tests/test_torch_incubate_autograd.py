"""paddle_tpu_torch.incubate.autograd (vjp, jvp, jacobian, hessian over
torch.func) against paddle_tpu.incubate.autograd (jax transforms) on the
CPU, single and list inputs, with the reference's return structures
(``hessian`` of a list: the nested H[i][j]). Values within 1e-5 of each
result's max (the two differentiate through tanh and matmul in their own
orders)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.incubate import autograd as jag
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.incubate import autograd as tag

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


RNG = np.random.RandomState(0)
X = RNG.randn(4).astype(np.float32)
W = (RNG.randn(4, 3) * 0.5).astype(np.float32)
V = RNG.randn(3).astype(np.float32)


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= TOL * (np.max(np.abs(want)) + 1e-30)


def mlp(p):
    def f(x, w):
        return p.tanh(p.matmul(x[None], w))[0]
    return f


def loss(p):
    def f(x, w):
        return (p.tanh(p.matmul(x[None], w)) ** 2).sum()
    return f


def pair(p):
    return p.to_tensor(X), p.to_tensor(W)


def test_vjp_single_and_list():
    (jx, jw), (tx, tw) = pair(jp), pair(tp)
    jo, jg = jag.vjp(lambda x: jp.tanh(x) * 3, jx)
    to, tg = tag.vjp(lambda x: tp.tanh(x) * 3, tx)
    assert type(to) is tp.Tensor and isinstance(tg, list) and len(tg) == 1
    close(to, jo)
    close(tg[0], jg[0])
    jo, jg = jag.vjp(mlp(jp), [jx, jw], jp.to_tensor(V))
    to, tg = tag.vjp(mlp(tp), [tx, tw], tp.to_tensor(V))
    close(to, jo)
    assert len(tg) == 2
    for t, j in zip(tg, jg):
        close(t, j)


def test_jvp_single_and_list():
    (jx, jw), (tx, tw) = pair(jp), pair(tp)
    jo, jt = jag.jvp(lambda x: jp.tanh(x) * x, jx)
    to, tt = tag.jvp(lambda x: tp.tanh(x) * x, tx)
    close(to, jo)
    close(tt, jt)
    tang = [RNG.randn(4).astype(np.float32), RNG.randn(4, 3).astype(np.float32)]
    jo, jt = jag.jvp(mlp(jp), [jx, jw], [jp.to_tensor(t) for t in tang])
    to, tt = tag.jvp(mlp(tp), [tx, tw], [tp.to_tensor(t) for t in tang])
    assert type(tt) is tp.Tensor
    close(to, jo)
    close(tt, jt)


def test_jacobian_single_and_list():
    (jx, jw), (tx, tw) = pair(jp), pair(tp)
    want = jag.jacobian(lambda x: jp.tanh(x) * 2, jx)
    got = tag.jacobian(lambda x: tp.tanh(x) * 2, tx)
    assert type(got) is tp.Tensor
    close(got, want)
    want = jag.jacobian(mlp(jp), [jx, jw])
    got = tag.jacobian(mlp(tp), [tx, tw])
    assert isinstance(got, list) and len(got) == 2
    for g, w in zip(got, want):
        close(g, w)


def test_hessian_single_and_list_nested():
    (jx, jw), (tx, tw) = pair(jp), pair(tp)
    want = jag.hessian(lambda x: (jp.tanh(x) ** 3).sum(), jx)
    got = tag.hessian(lambda x: (tp.tanh(x) ** 3).sum(), tx)
    assert type(got) is tp.Tensor and got.shape == [4, 4]
    close(got, want)
    want = jag.hessian(loss(jp), [jx, jw])
    got = tag.hessian(loss(tp), [tx, tw])
    assert len(got) == len(want) == 2
    for i in range(2):
        assert len(got[i]) == len(want[i]) == 2
        for j in range(2):
            close(got[i][j], want[i][j])
    assert tuple(got[0][1].shape) == (4, 4, 3) and tuple(got[1][1].shape) == (4, 3, 4, 3)
