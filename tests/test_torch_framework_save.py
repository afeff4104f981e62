"""``paddle_tpu_torch.save``/``load`` (paddle_tpu_torch/framework) against the
JAX package's, on the CPU: nested objects round-trip, a failing write
leaves the previous file, and files pass between the two packages bitwise
for float32 and integer data (a LeNet's ``.pdparams`` and its Adam
``.pdopt``, either way); bfloat16 round-trips bitwise in the port.
Everything here is bitwise: the format stores the arrays' bytes."""
import os
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core import place as tplace

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _np(v):
    v = getattr(v, "_value", v)
    return np.array(v.detach() if isinstance(v, torch.Tensor) else v)


def test_nested_save_and_load(tmp_path):
    p = tp.create_parameter([2, 3], "float32")
    obj = {"w": tp.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3)),
           "p": p, "buf": torch.arange(4, dtype=torch.int32),
           "nested": [tp.to_tensor(np.array([1, 2], np.int32)), (3, "x", None)],
           "n": 7, "s": "text", "arr": np.ones(3, np.float64)}
    path = str(tmp_path / "sub" / "obj.pdparams")
    tp.save(obj, path)
    back = tp.load(path)
    assert isinstance(back["w"], tp.Tensor) and back["w"].place == tp.CPUPlace()
    assert np.array_equal(back["w"].numpy(), obj["w"].numpy())
    assert back["p"].name == p.name and back["p"].stop_gradient is False
    assert isinstance(back["buf"], np.ndarray) and back["buf"].dtype == np.int32
    assert np.array_equal(back["nested"][0].numpy(), [1, 2])
    assert back["nested"][1] == (3, "x", None) and back["n"] == 7 and back["s"] == "text"
    assert back["arr"].dtype == np.float64
    flat = tp.load(path, return_numpy=True)
    assert isinstance(flat["w"], np.ndarray) and np.array_equal(flat["w"], obj["w"].numpy())
    with open(path, "rb") as f:  # the reference's dict form of a Tensor
        raw = pickle.load(f)
    assert raw["w"]["__tensor__"] and set(raw["w"]) == {"__tensor__", "data", "name",
                                                         "stop_gradient"}


def test_a_failing_save_leaves_the_old_file(tmp_path):
    path = str(tmp_path / "state.pdparams")
    tp.save({"a": tp.to_tensor(np.ones(2, np.float32))}, path)
    before = open(path, "rb").read()
    with pytest.raises(Exception):
        tp.save({"a": tp.to_tensor(np.zeros(2, np.float32)), "bad": lambda: 0}, path)
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["state.pdparams"]  # no temp file left behind


def test_bfloat16_round_trips_in_the_port(tmp_path):
    words = np.random.RandomState(0).randint(0, 2 ** 16, (5, 7)).astype(np.uint16)
    t = torch.from_numpy(words.astype(np.int16)).view(torch.bfloat16)
    t = t.masked_fill(torch.isnan(t), 1.0)
    path = str(tmp_path / "bf16.pdparams")
    tp.save({"t": tp.to_tensor(t), "plain": t.clone()}, path)
    back = tp.load(path)
    for k in ("t", "plain"):
        got = torch.Tensor.as_subclass(back[k], torch.Tensor)
        assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                           t.view(torch.int16)), k
    assert np.array_equal(tp.load(path, return_numpy=True)["t"], t.float().numpy())
    # a bfloat16 array the reference wrote (ml_dtypes) loads through its words
    ref_path = str(tmp_path / "ref_bf16.pdparams")
    arr = words.view(ml_dtypes.bfloat16)
    jp.save({"t": jp.to_tensor(arr)}, ref_path)
    got = torch.Tensor.as_subclass(tp.load(ref_path)["t"], torch.Tensor)
    assert torch.equal(got.view(torch.int16), torch.from_numpy(words.astype(np.int16)))


def _lenet_pair():
    jp.seed(0)
    jm = jp.vision.models.LeNet()
    tm = tp.vision.models.LeNet()
    load_state_dict(tm, {k: _np(v) for k, v in jm.state_dict().items()})
    return jm, tm


def _adam_steps(paddle, model, steps=2):
    opt = paddle.optimizer.Adam(1e-3, parameters=model.parameters())
    rng = np.random.RandomState(1)
    for _ in range(steps):
        x = paddle.to_tensor(rng.rand(4, 1, 28, 28).astype(np.float32))
        y = paddle.to_tensor(rng.randint(0, 10, (4,)))
        loss = paddle.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    return opt


def _accumulators(opt):
    return [[_np(a) for a in opt._accumulators[id(p)]] for p in opt._params]


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_files_pass_between_the_packages_bitwise(tmp_path, direction):
    jm, tm = _lenet_pair()
    jopt, topt = _adam_steps(jp, jm), _adam_steps(tp, tm)
    src, dst = (jp, tp) if direction == "reference_to_port" else (tp, jp)
    src_m, dst_m = (jm, tm) if src is jp else (tm, jm)
    src_opt, dst_opt = (jopt, topt) if src is jp else (topt, jopt)
    dst.seed(3)
    fresh = dst.vision.models.LeNet()
    # the optimizer's state maps by parameter name (by position only when no
    # name matches): the fresh model takes the saved model's names
    for q, p in zip(fresh.parameters(), src_m.parameters()):
        q.name = p.name
    fresh_opt = dst.optimizer.Adam(1e-3, parameters=fresh.parameters())
    src.save(src_m.state_dict(), str(tmp_path / "m.pdparams"))
    src.save(src_opt.state_dict(), str(tmp_path / "m.pdopt"))
    fresh.set_state_dict(dst.load(str(tmp_path / "m.pdparams")))
    fresh_opt.set_state_dict(dst.load(str(tmp_path / "m.pdopt")))
    want = {k: _np(v) for k, v in src_m.state_dict().items()}
    got = {k: _np(v) for k, v in fresh.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for g, w in zip(_accumulators(fresh_opt), _accumulators(src_opt)):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert fresh_opt._step_count == src_opt._step_count
    # integer data: an int64 label array and an int32 tensor, either way
    ints = {"labels": np.arange(-3, 9, dtype=np.int64),
            "idx": src.to_tensor(np.array([[1, -2], [3, 2 ** 30]], np.int32))}
    src.save(ints, str(tmp_path / "ints.pdparams"))
    back = dst.load(str(tmp_path / "ints.pdparams"))
    assert back["labels"].dtype == np.int64 and np.array_equal(back["labels"], ints["labels"])
    assert np.array_equal(_np(back["idx"]), [[1, -2], [3, 2 ** 30]])


def test_in_dygraph_mode_and_default_dtype():
    assert tp.in_dygraph_mode() and tp.framework.in_dygraph_mode()
    assert tp.framework.get_default_dtype() == "float32"
    for name in ("float16", "float64"):
        tp.framework.set_default_dtype(name)
        jp.framework.set_default_dtype(name)
        try:
            assert tp.get_default_dtype() == jp.get_default_dtype()
        finally:
            tp.framework.set_default_dtype("float32")
            jp.framework.set_default_dtype("float32")
