"""paddle_tpu_torch.onnx against paddle_tpu.onnx on the CPU, on the
reference's tests/test_onnx_export.py models at its sizes and tolerances
(MLP, LeNet, a transformer block, BERT tiny, resnet18, MobileNetV2, the
GPT decoder). For each model, built in both packages from seed 0:

- the port's file run by the port's runner matches the port's forward;
- the port's file run by the reference's runner matches it too;
- the reference's file run by the port's runner matches the reference's
  forward.

Then the reference's contract: the file, opset 12 and IR 7, the
required ``input_spec``, the opsets it refuses, every node input
resolvable, depthwise convolutions' group, ``UnsupportedOp`` where the
reference raises, and the port's own kernels lowered (K1 causal and not,
``wq_matmul``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import onnx as jonnx
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu_torch import onnx as tonnx
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.static import InputSpec as TSpec

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _mlp(p):
    nn = p.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4), nn.Softmax())


def _block(p):
    nn = p.nn
    return nn.Sequential(nn.Linear(8, 8), nn.GELU(), nn.LayerNorm(8))


def _bert(p):
    return p.text.models.BertModel(
        vocab_size=64, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=16, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)


def _gpt(p):
    return p.text.models.GPTModel(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                                  intermediate_size=64, max_seq_len=32, dropout=0.0)


MODELS = {
    "mlp": (_mlp, {"x": np.random.RandomState(0).randn(3, 8).astype(np.float32)},
            1e-4, 1e-5),
    "lenet": (lambda p: p.vision.models.LeNet(),
              {"image": np.random.RandomState(1).rand(2, 1, 28, 28).astype(np.float32)},
              1e-3, 1e-4),
    "transformer_block": (_block,
                          {"x": np.random.RandomState(2).randn(2, 5, 8).astype(np.float32)},
                          1e-3, 1e-4),
    "bert_tiny": (_bert, {"ids": np.random.RandomState(3).randint(0, 64, (2, 12))
                          .astype(np.int32)}, 1e-3, 1e-4),
    "resnet18": (lambda p: p.vision.models.resnet18(num_classes=10),
                 {"img": np.random.RandomState(0).rand(1, 3, 32, 32).astype(np.float32)},
                 1e-2, 1e-3),
    "mobilenetv2": (lambda p: p.vision.models.MobileNetV2(num_classes=10),
                    {"img": np.random.RandomState(0).rand(1, 3, 32, 32).astype(np.float32)},
                    1e-3, 1e-4),
    "gpt_decoder": (_gpt, {"ids": np.random.RandomState(1).randint(0, 64, (1, 10))
                           .astype(np.int32)}, 1e-3, 1e-4),
}


def _export(p, onnx_mod, spec_cls, net, feeds):
    net.eval()
    specs = [spec_cls(list(v.shape), str(v.dtype), name=k) for k, v in feeds.items()]
    return onnx_mod.export_bytes(net, specs)


def _forward(p, net, feeds):
    out = net(*[p.to_tensor(v) for v in feeds.values()])
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [np.asarray(o.numpy()) for o in outs]


def _check(got, want, rtol, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_export_runs_in_both_runners(name):
    make, feeds, rtol, atol = MODELS[name]
    tp.seed(0)
    tnet = make(tp)
    tblob = _export(tp, tonnx, TSpec, tnet, feeds)
    twant = _forward(tp, tnet, feeds)
    _check(tonnx.run(tonnx.load(tblob), feeds), twant, rtol, atol)
    _check(jonnx.run(jonnx.load(tblob), feeds), twant, rtol, atol)
    jp.seed(0)
    jnet = make(jp)
    jblob = _export(jp, jonnx, JSpec, jnet, feeds)
    _check(tonnx.run(tonnx.load(jblob), feeds), _forward(jp, jnet, feeds), rtol, atol)


def test_export_writes_file(tmp_path):
    tp.seed(0)
    net = tp.nn.Linear(4, 2)
    path = tonnx.export(net, str(tmp_path / "lin"), input_spec=[TSpec([1, 4], "float32")])
    assert path.endswith(".onnx")
    model = tonnx.load(path)
    assert model["opset"] == 12 and model["ir_version"] == 7
    assert model["graph"]["outputs"]
    assert {n["op_type"] for n in model["graph"]["nodes"]} >= {"MatMul"}


def test_requires_input_spec_and_a_known_opset():
    with pytest.raises(ValueError):
        tonnx.export(tp.nn.Linear(2, 2), "unused")
    with pytest.raises(ValueError, match="opset_version"):
        tonnx.export_bytes(tp.nn.Linear(2, 2), [TSpec([1, 2])], opset_version=13)
    with pytest.raises(ValueError, match="dynamic"):
        tonnx.export_bytes(tp.nn.Linear(2, 2), [TSpec([None, 2])])


def test_value_names_resolve():
    tp.seed(0)
    net = tp.nn.Sequential(tp.nn.Linear(6, 6), tp.nn.Sigmoid())
    g = tonnx.load(tonnx.export_bytes(net, [TSpec([2, 6], "float32", "x")]))["graph"]
    known = set(g["initializers"]) | {i["name"] for i in g["inputs"]}
    for node in g["nodes"]:
        for nm in node["input"]:
            assert nm in known, f"{node['op_type']} uses unknown {nm}"
        known.update(node["output"])
    assert {o["name"] for o in g["outputs"]} <= known
    emitted = {n["op_type"] for n in g["nodes"]}
    assert emitted <= set(tonnx.runner._OPS)


def test_depthwise_convs_keep_their_group():
    tp.seed(0)
    net = tp.vision.models.MobileNetV2(num_classes=10)
    blob = _export(tp, tonnx, TSpec, net, {"img": np.zeros((1, 3, 32, 32), np.float32)})
    groups = [n["attrs"].get("group", 1) for n in tonnx.load(blob)["graph"]["nodes"]
              if n["op_type"] == "Conv"]
    assert any(g > 1 for g in groups)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_transposed_conv_is_unsupported_in_both(pkg):
    p, mod, spec = (jp, jonnx, JSpec) if pkg == "reference" else (tp, tonnx, TSpec)
    net = p.nn.Conv2DTranspose(2, 3, 2, stride=2)
    net.eval()
    with pytest.raises(mod.UnsupportedOp):
        mod.export_bytes(net, [spec([1, 2, 4, 4], "float32")])


@pytest.mark.parametrize("causal", [False, True])
def test_k1_lowers_to_the_attention_chain(causal):
    from paddle_tpu_torch.core.tensor import plain
    from paddle_tpu_torch.ops import flash_attention as fa

    class Attn(tp.nn.Layer):
        def forward(self, q, k, v):
            return fa.mha(plain(q), plain(k), plain(v), causal=causal)

    rng = np.random.RandomState(4)
    feeds = {n: rng.randn(2, 2, s, 8).astype(np.float32) for n, s in (("q", 6), ("k", 9),
                                                                        ("v", 9))}
    blob = tonnx.export_bytes(Attn(), [TSpec(list(v.shape), "float32", n)
                                       for n, v in feeds.items()])
    ops = [n["op_type"] for n in tonnx.load(blob)["graph"]["nodes"]]
    assert "ReduceMax" in ops and "Exp" in ops and ("Where" in ops) == causal
    want = [fa.mha(*[torch.from_numpy(v) for v in feeds.values()], causal=causal).numpy()]
    _check(jonnx.run(jonnx.load(blob), feeds), want, 1e-5, 1e-6)


def test_wq_matmul_lowers_to_dequantize_then_matmul():
    from paddle_tpu_torch import quantization

    tp.seed(0)
    net = tp.nn.Sequential(tp.nn.Linear(16, 32), tp.nn.ReLU(), tp.nn.Linear(32, 16))
    quantization.quantize_weights(net)
    feeds = {"x": np.random.RandomState(5).randn(3, 16).astype(np.float32)}
    blob = _export(tp, tonnx, TSpec, net, feeds)
    _check(tonnx.run(tonnx.load(blob), feeds), _forward(tp, net, feeds), 1e-5, 1e-5)
