"""paddle_tpu_torch.metric against paddle_tpu.metric on the same predictions
(numpy from a seed, on the CPU): ``Accuracy`` (top-1 and top-k, its
compute/update/accumulate and names), ``Precision``, ``Recall``, ``Auc`` and
the functional ``accuracy``. Both compute in numpy on the host, so every
result is held exactly (float equality)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as tplace


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _batches(n=3, b=16, classes=7, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        pred = rng.rand(b, classes).astype(np.float32)
        pred[0, :2] = 0.5  # a tie, broken by argsort's order in both
        yield pred, rng.randint(0, classes, (b, 1)).astype(np.int64)


@pytest.mark.parametrize("topk", [(1,), (1, 3), 2])
def test_accuracy(topk):
    jm, tm = jp.metric.Accuracy(topk=topk), tp.metric.Accuracy(topk=topk)
    assert tm.name() == jm.name()
    for pred, label in _batches():
        jc = jm.compute(jp.to_tensor(pred), jp.to_tensor(label))
        tc = tm.compute(tp.to_tensor(pred), tp.to_tensor(label))
        assert isinstance(tc, tp.Tensor)
        assert np.array_equal(tc.numpy(), np.asarray(jc._value))
        assert tm.update(tc) == jm.update(jc)
    assert tm.accumulate() == jm.accumulate()
    tm.reset()
    assert tm.accumulate() == (0.0 if len(tm.topk) == 1 else [0.0] * len(tm.topk))


def test_accuracy_takes_torch_tensors_and_bfloat16():
    m = tp.metric.Accuracy()
    pred = torch.tensor([[0.1, 0.9], [0.8, 0.2]], dtype=torch.bfloat16)
    m.update(m.compute(pred, torch.tensor([1, 1])))
    assert m.accumulate() == 0.5


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics(cls):
    jm, tm = getattr(jp.metric, cls)(), getattr(tp.metric, cls)()
    rng = np.random.RandomState(1)
    for _ in range(3):
        preds = rng.rand(32, 2 if cls == "Auc" else 1).astype(np.float32)
        labels = rng.randint(0, 2, (32, 1)).astype(np.int64)
        jm.update(jp.to_tensor(preds), jp.to_tensor(labels))
        tm.update(tp.to_tensor(preds), tp.to_tensor(labels))
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name()


@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy(k):
    pred, label = next(_batches(1, 20, 5, seed=4))
    want = jp.metric.accuracy(jp.to_tensor(pred), jp.to_tensor(label), k=k)
    got = tp.metric.accuracy(tp.to_tensor(pred), tp.to_tensor(label), k=k)
    assert np.array_equal(got.numpy(), np.asarray(want._value))
    assert tp.metric.metrics is tp.metric
