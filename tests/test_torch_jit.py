"""paddle_tpu_torch.jit (to_static, save, load) and the custom ops under
it, against the JAX package on the CPU, at a tiny size: BERT of 2 layers
and width 64, resnet18 at 32 x 32, GPT of 2 layers. The same weights
(carried across with ``convert.load_numpy_state``) and inputs (numpy,
seeded) go through both packages.

- ``jit.save`` -> ``jit.load`` outputs within 1e-5 of the reference's
  ``jit.save`` -> ``jit.load``; ``.pdiparams`` arrays bitwise the
  reference's under the same keys; ``.pdmeta.json`` the same keys (and
  the same input specs); the fingerprint the same across two saves; a
  reference save refused by its format's name.
- (``to_static`` of whole models: tests/test_torch_dy2static.py.)
- The kernels' custom ops: fake shapes (a symbolic batch included) and
  ``torch.library.opcheck`` on CPU tensors.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.text.models import BertModel as JaxBert
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import quant_matmul as tqm
from paddle_tpu_torch.serialize import export as texport
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.text.models import BertModel

torch.set_num_threads(1)

TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128)
SEQ = 16
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


@pytest.fixture(scope="module")
def bert_pair():
    jp.seed(0)
    jm = JaxBert(**TINY)
    jm.eval()
    tm = BertModel(**TINY, device="cpu").eval()
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    return jm, tm


def _ids(rows, seed=0):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"],
                                               (rows, SEQ)).astype(np.int32)


# the reference's BERT does not export with a symbolic batch (its save
# pins the dim to 1), so the two packages are compared at a fixed batch
ROWS = 3


@pytest.fixture(scope="module")
def saves(bert_pair, tmp_path_factory):
    """(the reference's save, the port's batch-polymorphic save, the port's
    save at the reference's fixed spec)."""
    jm, tm = bert_pair
    d = tmp_path_factory.mktemp("saves")
    ref, port, fixed = str(d / "ref"), str(d / "port"), str(d / "fixed")
    jp.jit.save(jm, ref, input_spec=[jp.static.InputSpec([ROWS, SEQ], "int32")])
    tjit.save(tm, port, input_spec=[InputSpec([None, SEQ], "int32")])
    tjit.save(tm, fixed, input_spec=[InputSpec([ROWS, SEQ], "int32")])
    return ref, port, fixed


def test_save_load_outputs_match_the_reference(saves):
    ref, port, fixed = saves
    ids = _ids(ROWS, 1)
    want = [np.asarray(o.numpy()) for o in jp.jit.load(ref)(jp.to_tensor(ids))]
    for path in (port, fixed):
        got = [o.numpy() for o in tjit.load(path)(ids)]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    tl = tjit.load(port)
    for rows in (1, 8):  # any batch through the polymorphic save
        ids = _ids(rows, rows)
        want = [np.asarray(o.numpy()) for o in jp.jit.load(ref)(jp.to_tensor(
            np.resize(ids, (ROWS, SEQ))))]
        for g, w in zip(tl(ids), want):
            assert g.shape[0] == rows
            np.testing.assert_allclose(g.numpy()[:min(rows, ROWS)], w[:min(rows, ROWS)],
                                       rtol=0, atol=TOL)


def test_pdiparams_arrays_are_the_references_under_the_same_keys(saves):
    ref, port, _ = saves
    with np.load(ref + ".pdiparams") as a, np.load(port + ".pdiparams") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_pdmeta_has_the_references_keys(saves):
    ref, port, fixed = saves
    a, b, c = (json.load(open(p + ".pdmeta.json")) for p in (ref, port, fixed))
    assert set(a) == set(b) == set(c)
    assert a["format"] == "stablehlo" and b["format"] == c["format"] == "torch.export"
    assert a["input_specs"] == c["input_specs"] == [[[ROWS, SEQ], "int32"]]
    assert b["input_specs"] == [[[None, SEQ], "int32"]]
    assert b["polymorphic"] and not c["polymorphic"]
    assert b["op_versions"] == a["op_versions"] and b["quant"] is None


def test_fingerprint_is_stable_across_two_saves(bert_pair, saves, tmp_path):
    _, tm = bert_pair
    _, port, _ = saves
    again = str(tmp_path / "again")
    tjit.save(tm, again, input_spec=[InputSpec([None, SEQ], "int32")])
    assert open(again + ".pdmodel", "rb").read() == open(port + ".pdmodel", "rb").read()
    first = json.load(open(port + ".pdmeta.json"))["fingerprint"]
    assert json.load(open(again + ".pdmeta.json"))["fingerprint"] == first
    assert tjit.load(again)._model_fingerprint == first
    # the weights are runtime inputs: other values, the same program
    other = BertModel(**TINY, device="cpu", generator=torch.Generator().manual_seed(5)).eval()
    tjit.save(other, str(tmp_path / "other"), input_spec=[InputSpec([None, SEQ], "int32")])
    assert json.load(open(str(tmp_path / "other.pdmeta.json")))["fingerprint"] == first
    assert texport.model_fingerprint(b"x", quant="w8") != texport.model_fingerprint(b"x")
    assert texport.model_fingerprint(b"x", quant="f32") == texport.model_fingerprint(b"x")


def test_a_reference_save_is_refused_by_name(saves):
    ref, _, _ = saves
    with pytest.raises(RuntimeError, match="stablehlo"):
        tjit.load(ref)


def test_a_fixed_shape_save_and_the_params_only_fallback(bert_pair, tmp_path):
    _, tm = bert_pair
    fixed = str(tmp_path / "fixed")
    tjit.save(tm, fixed, input_spec=[InputSpec([2, SEQ], "int32")])
    meta = json.load(open(fixed + ".pdmeta.json"))
    assert meta["polymorphic"] is False and meta["input_specs"] == [[[2, SEQ], "int32"]]
    ids = _ids(2)
    with torch.no_grad():
        want = tm(torch.from_numpy(ids))
    for g, w in zip(tjit.load(fixed)(ids), want):
        assert torch.equal(g, w)

    class Opaque(tp.nn.Layer):
        def forward(self, x):
            return torch.from_numpy(x.numpy() * 2)  # a host round trip: no program

    broken = str(tmp_path / "broken")
    tjit.save(Opaque(), broken, input_spec=[InputSpec([None, 4], "float32")])
    meta = json.load(open(broken + ".pdmeta.json"))
    assert meta["format"] == "params-only" and meta["export_error"]
    assert not os.path.exists(broken + ".pdmodel")
    with pytest.raises(RuntimeError, match="without a serialized program"):
        tjit.load(broken)


def test_save_rejects_a_mesh_and_needs_a_spec(bert_pair):
    _, tm = bert_pair
    with pytest.raises(ValueError, match="input_spec"):
        tjit.save(tm, "nowhere")
    # a mesh is recorded (tests/test_torch_serving_mesh.py); a bad one raises
    with pytest.raises(ValueError, match="descriptor"):
        tjit.save(tm, "nowhere", input_spec=[InputSpec([None, SEQ], "int32")], mesh="tp2x")


@pytest.mark.parametrize("mode", ["w8", "bf16w"])
def test_quantized_saves_match_the_reference(mode, tmp_path):
    jp.seed(3)
    jm = JaxBert(**TINY)
    jm.eval()
    tm = BertModel(**TINY, device="cpu").eval()
    state = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    load_numpy_state(tm, state)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    jp.jit.save(jm, ref, input_spec=[jp.static.InputSpec([ROWS, SEQ], "int32")], quant=mode)
    tjit.save(tm, port, input_spec=[InputSpec([None, SEQ], "int32")], quant=mode)
    a, b = (json.load(open(p + ".pdmeta.json")) for p in (ref, port))
    assert a["quant"] == b["quant"] == mode
    with np.load(ref + ".pdiparams") as x, np.load(port + ".pdiparams") as y:
        if mode == "bf16w":
            assert sorted(x.files) == sorted(y.files)
        else:
            # the reference's w8 save lists a bias once where two layers'
            # zero biases share one array; the port lists each layer's
            assert set(x.files) <= set(y.files)
        for k in x.files:  # the stored weights (int8, scales, bf16 words): bitwise
            assert np.array_equal(x[k], y[k]), k
    tl = tjit.load(port)
    assert tl._quant_mode == mode
    ids = _ids(ROWS, 7)
    got = [o.numpy() for o in tl(ids)]
    if mode == "w8":
        # the reference's w8 BERT does not export (its fused QKV reads the
        # quantized layers' .weight): its save is params-only. The port's
        # program is held to the port's in-place quantized model, and to
        # the f32 model within the mode's accuracy bound
        from paddle_tpu_torch.quantization.serving import ACCURACY_BOUNDS

        assert a["format"] == "params-only"
        with torch.no_grad():
            want = [o.numpy() for o in tm(torch.from_numpy(ids))]
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        with torch.no_grad():
            f32 = BertModel(**TINY, device="cpu").eval()
            load_numpy_state(f32, state)
            ref32 = f32(torch.from_numpy(ids))[0].numpy()
        assert np.abs(got[0] - ref32).max() / np.abs(ref32).max() < ACCURACY_BOUNDS["w8"]
        return
    want = [np.asarray(o.numpy()) for o in jp.jit.load(ref)(jp.to_tensor(ids))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_save_quantized_model_writes_a_w8_save(tmp_path):
    from paddle_tpu_torch.quantization import PostTrainingQuantization

    tm = BertModel(**TINY, device="cpu", generator=torch.Generator().manual_seed(1)).eval()
    ptq = PostTrainingQuantization(tm)
    path = str(tmp_path / "ptq")
    ptq.save_quantized_model(path, input_spec=[InputSpec([None, SEQ], "int32")])
    loaded = tjit.load(path)
    assert loaded._quant_mode == "w8"
    ids = _ids(2, 4)
    with torch.no_grad():
        want = tm(torch.from_numpy(ids))
    for g, w in zip(loaded(ids), want):
        assert torch.equal(g, w)


def test_translated_layer_slabs_keep_the_bits(saves):
    _, port, _ = saves
    tl = tjit.load(port, slab_rows=2)
    ids = _ids(5, 9)
    whole = [o.numpy() for o in tl(ids)]
    assert whole[0].shape == (5, SEQ, TINY["hidden_size"])
    for rows in range(1, 6):
        part = [o.numpy() for o in tl(ids[:rows])]
        for p, w in zip(part, whole):
            assert np.array_equal(p, w[:rows])
    tl.set_slab_rows(8)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(tl(ids), whole))
    with pytest.raises(ValueError):
        tl.set_slab_rows(0)


# ------------------------------------------------------------ custom ops


def test_custom_ops_fake_shapes_take_a_symbolic_batch():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    with FakeTensorMode(shape_env=ShapeEnv()):
        q, k = torch.empty(6, 16, 64), torch.empty(6, 24, 64)
        o, lse = torch.ops.paddle_tpu_torch.flash_attention_fwd(q, k, k, None, 0.125, False, 0.0)
        assert tuple(o.shape) == (6, 16, 64) and tuple(lse.shape) == (6, 16, 1)
        assert lse.dtype == torch.float32
        dq, dk, dv = torch.ops.paddle_tpu_torch.flash_attention_bwd(q, k, k, o, lse, o, None,
                                                                   0.125, False, 0.0)
        assert tuple(dq.shape) == (6, 16, 64) and tuple(dk.shape) == tuple(dv.shape) == (6, 24, 64)
        w = torch.empty(64, 32, dtype=torch.int8)
        y = torch.ops.paddle_tpu_torch.wq_matmul(torch.empty(3, 5, 64), w, torch.empty(32))
        assert tuple(y.shape) == (3, 5, 32) and y.dtype == torch.float32

    class M(torch.nn.Module):
        def forward(self, q, k):
            return tfa.mha(q, k, k)

    b = torch.export.Dim("b", min=1)
    ep = torch.export.export(M(), (torch.randn(2, 2, 16, 64), torch.randn(2, 2, 16, 64)),
                             dynamic_shapes=({0: b}, {0: b}), strict=False)
    assert "paddle_tpu_torch.flash_attention_fwd" in ep.graph_module.code
    q = torch.randn(5, 2, 16, 64)
    assert torch.equal(ep.module()(q, q), tfa.mha(q, q, q))


@pytest.mark.parametrize("grad", [False, True])
def test_custom_ops_pass_opcheck(grad):
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).requires_grad_(grad)

    q, k, v = t(4, 16, 64), t(4, 24, 64), t(4, 24, 64)
    for causal, p in ((False, 0.0), (True, 0.1)):
        torch.library.opcheck(torch.ops.paddle_tpu_torch.flash_attention_fwd.default,
                              (q, k, v, torch.tensor(7), 0.125, causal, p))
    o, lse = tfa.mha_reference(q.detach(), k.detach(), v.detach(), 7, 0.125, True, 0.1)
    torch.library.opcheck(torch.ops.paddle_tpu_torch.flash_attention_bwd.default,
                          (q.detach(), k.detach(), v.detach(), o, lse, torch.randn(4, 16, 64),
                           torch.tensor(7), 0.125, True, 0.1))
    w = torch.from_numpy(rng.randint(-127, 128, (64, 32)).astype(np.int8))
    torch.library.opcheck(torch.ops.paddle_tpu_torch.wq_matmul.default,
                          (t(3, 64).detach(), w, torch.rand(32)))
    torch.library.opcheck(torch.ops.paddle_tpu_torch.ieee_convolution.default,
                          (t(2, 3, 8, 8), t(4, 3, 3, 3), [1, 1], [1, 1], [1, 1], False, [0, 0],
                           1))


def test_k1_gradient_through_the_op_is_k2_k3_plain_version():
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 8, 64).astype(np.float32)).requires_grad_()
               for _ in range(3))
    o = tfa.mha(q, k, v, causal=True, dropout_p=0.2, seed=11)
    do = torch.from_numpy(rng.randn(1, 2, 8, 64).astype(np.float32))
    o.backward(do)
    q3, k3, v3 = (t.detach().reshape(2, 8, 64) for t in (q, k, v))
    o3, lse = tfa.mha_reference(q3, k3, v3, 11, 0.125, True, 0.2)
    want = tfa.mha_bwd_reference(q3, k3, v3, o3, lse, do.reshape(2, 8, 64), 11, 0.125, True,
                                 0.2)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g.reshape(2, 8, 64), w)
    assert torch.equal(tqm.wq_matmul(torch.ones(2, 4), torch.ones(4, 8, dtype=torch.bfloat16)),
                       torch.full((2, 8), 4.0))


def test_input_spec_and_op_version():
    from paddle_tpu.framework import op_version as jov
    from paddle_tpu_torch.framework import op_version as tov

    s = InputSpec([None, 8], torch.int32, "ids")
    assert (s.shape, s.dtype, s.name) == ([None, 8], "int32", "ids")
    assert InputSpec.from_tensor(torch.zeros(2, 3)).shape == [2, 3]
    assert InputSpec.from_numpy(np.zeros((4,), np.int64)).dtype == "int64"
    assert s.batch(2).shape == [2, None, 8] and s.unbatch().shape == [8]
    assert tov.all_op_versions() == jov.all_op_versions()
    with pytest.warns(RuntimeWarning):
        assert tov.check_compat({"batch_norm_train": 1}) == {"batch_norm_train": (1, 2)}


def test_a_w8a8_save_bakes_the_calibrated_scales(tmp_path):
    """jit.save(quant="w8a8") calibrates activation scales over the sample
    generator, records them in the sidecar, and the loaded program gives
    the in-place quantized model's bits."""
    tp.seed(6)
    net = tp.nn.Sequential(tp.nn.Linear(16, 32), tp.nn.ReLU(), tp.nn.Linear(32, 8))

    def calib():
        rng = np.random.RandomState(1)
        for _ in range(4):
            yield rng.randn(3, 16).astype(np.float32)

    path = str(tmp_path / "w8a8")
    tjit.save(net, path, input_spec=[InputSpec([None, 16], "float32")], quant="w8a8",
              quant_calib=calib)
    meta = json.load(open(path + ".pdmeta.json"))
    assert meta["quant"] == "w8a8" and sorted(meta["quant_meta"]["act_scales"]) == ["0", "2"]
    loaded = tjit.load(path)
    assert loaded._quant_mode == "w8a8"
    x = np.random.RandomState(2).randn(5, 16).astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(x))
    assert torch.equal(loaded(x), want)
