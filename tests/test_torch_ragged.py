"""paddle_tpu_torch.text.ragged (the sequence ops of static.nn, dense
tensors plus lengths) against paddle_tpu.text.ragged on the CPU: one case
per op and pooling type, numpy inputs from a seed, float outputs within
1e-6 and integer outputs bitwise. The static.nn namespace exposes the
same functions."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.text import ragged as jr
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.text import ragged as tr

torch.set_num_threads(1)

RNG = np.random.RandomState(0)
X3 = RNG.randn(3, 5, 4).astype(np.float32)
X2 = RNG.randn(3, 5).astype(np.float32)
LENS = np.asarray([5, 2, 3], np.int32)
LENS_B = np.asarray([1, 3, 2], np.int32)
ROWS = RNG.randn(int(LENS.sum()), 4).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _t(pkg, a):
    return pkg.to_tensor(a)


CASES = {
    "length_mask": lambda r, p: r.length_mask(_t(p, LENS), 6),
    "attention_mask_from_lengths": lambda r, p: r.attention_mask_from_lengths(_t(p, LENS), 5),
    "sequence_reverse_3d": lambda r, p: r.sequence_reverse(_t(p, X3), _t(p, LENS)),
    "sequence_reverse_2d": lambda r, p: r.sequence_reverse(_t(p, X2), _t(p, LENS)),
    "sequence_softmax": lambda r, p: r.sequence_softmax(_t(p, X2), _t(p, LENS)),
    "sequence_expand": lambda r, p: r.sequence_expand(_t(p, X2[:, :2]), None, _t(p, LENS_B)),
    "sequence_concat": lambda r, p: r.sequence_concat([_t(p, X3), _t(p, X3 * 2)],
                                                      [_t(p, LENS), _t(p, LENS_B)]),
    "sequence_pad": lambda r, p: r.sequence_pad(_t(p, ROWS), _t(p, LENS), maxlen=6,
                                                pad_value=-1.0),
    "sequence_unpad": lambda r, p: r.sequence_unpad(_t(p, X3), _t(p, LENS)),
    "pad_sequences": lambda r, p: r.pad_sequences([[1, 2, 3], [4], [5, 6]], maxlen=4),
}
for _pool in ("sum", "average", "max", "sqrt", "last", "first"):
    CASES[f"sequence_pool_{_pool}"] = (
        lambda pool: lambda r, p: r.sequence_pool(_t(p, X3), _t(p, LENS), pool))(_pool)
CASES["sequence_pool_2d_average"] = lambda r, p: r.sequence_pool(_t(p, X2), _t(p, LENS),
                                                                 "average")


def _np(out):
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [np.asarray(o.numpy()) for o in outs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_op_matches_reference(case):
    want = _np(CASES[case](jr, jp))
    got = _np(CASES[case](tr, tp))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def test_static_nn_exposes_the_sequence_ops():
    for name in ("sequence_softmax", "sequence_reverse", "sequence_pad", "sequence_unpad",
                 "sequence_expand", "sequence_concat"):
        assert getattr(tp.static.nn, name) is getattr(tr, name)
        assert hasattr(jp.static.nn, name)


def test_unknown_pool_type_raises():
    with pytest.raises(ValueError):
        tr.sequence_pool(tp.to_tensor(X3), tp.to_tensor(LENS), "median")
