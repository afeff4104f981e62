"""The port stands alone: nothing in paddle_tpu_torch/ or chip_smoke.py
(or the op cases it runs, tests/test_torch_api_cases.py) imports jax or
the JAX package, and its entry points run on the card
unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace, resolve_device
from paddle_tpu_torch.core.random import fast_keep_mask
from paddle_tpu_torch.text.models import BertForPretraining, BertModel, GPTModel, LlamaModel

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    # chip_smoke.py runs tests/test_torch_api_cases.py's op cases on the
    # card, where there is no jax
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "tests" / "test_torch_api_cases.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.relative_to(REPO)} imports {name}"


@pytest.mark.parametrize("sub", ["obs", "resilience", "quantization", "jit", "static",
                                 "serialize", "inference", "framework", "distributed",
                                 "distributed/fleet", "distributed/fleet/utils"])
def test_telemetry_and_chaos_subpackages_are_checked(sub):
    """The port keeps its own copies of the reference's stdlib-only obs
    and chaos modules, of its quantization modules, of the deployment
    path (jit, static, serialize, inference, framework's op_version) and
    of the collective tier of distributed (its p2p transport, launcher,
    fleet strategy and role makers among them): both tests above and below
    cover them."""
    names = {p.name for p in _port_files() if p.parent == PKG / sub}
    want = {"obs": {"__init__.py", "metrics.py", "prometheus.py", "tracing.py", "httpd.py"},
            "resilience": {"__init__.py", "chaos.py"},
            "quantization": {"__init__.py", "post_training.py", "serving.py"},
            "jit": {"__init__.py", "dy2static.py", "save_load.py", "static_function.py",
                    "translator.py"},
            "static": {"__init__.py", "input_spec.py"},
            "serialize": {"__init__.py", "export.py", "artifact_store.py"},
            "inference": {"__init__.py", "batching.py", "config.py", "predictor.py",
                          "server.py", "prefix_cache.py", "registry.py", "router.py",
                          "fleet.py"},
            "framework": {"__init__.py", "op_version.py"},
            "distributed": {"__init__.py", "collective.py", "launch.py", "launch_mod.py",
                            "p2p.py", "parallel.py", "spmd.py", "topology.py"},
            "distributed/fleet": {"__init__.py", "distributed_strategy.py", "fleet_base.py",
                                  "launch.py", "metrics.py", "role_maker.py", "util.py"},
            "distributed/fleet/utils": {"__init__.py", "fs.py", "hybrid_parallel_util.py",
                                        "recompute.py"}}[sub]
    assert want <= names


_LOAD = """
import sys
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.static import InputSpec
paddle.set_device("cpu")
net = paddle.nn.Linear(4, 2)
jit.save(net, sys.argv[1], input_spec=[InputSpec([None, 4], "float32")])
cfg = inference.Config(sys.argv[1])
cfg.disable_gpu()
out = inference.create_predictor(cfg).run([np.ones((3, 4), np.float32)])[0]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert out.shape == (3, 2) and not bad, bad
print("ok")
"""


def test_loading_a_pdmodel_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A save and its load through the Predictor, in a fresh interpreter:
    neither jax nor paddle_tpu is imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _LOAD, str(tmp_path / "model")], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_quant_kernel_module_is_checked_and_builds_nothing_at_import():
    """ops/quant_matmul.py (the dequantizing kernel's wrapper) is one of
    the files checked above, its CUDA source ships beside the others, and
    importing it (with the quantization package) builds nothing."""
    from paddle_tpu_torch import quantization  # noqa: F401
    from paddle_tpu_torch.ops import quant_matmul

    assert PKG / "ops" / "quant_matmul.py" in _port_files()
    assert (PKG / "csrc" / "quant_matmul.cu").is_file()
    assert quant_matmul._lib is None


def test_importing_every_port_module_loads_no_jax():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour is not observable")


def test_default_device_raises_without_a_card(no_card):
    for fn in (resolve_device, lambda: resolve_device("gpu:0"),
               lambda: CUDAPlace(0).torch_device(), lambda: tnn.Linear(2, 2),
               lambda: tnn.LayerNorm(4), lambda: BertModel(vocab_size=8, hidden_size=8,
                                                           num_hidden_layers=1,
                                                           num_attention_heads=2,
                                                           intermediate_size=8),
               lambda: BertForPretraining(vocab_size=8, hidden_size=8, num_hidden_layers=1,
                                          num_attention_heads=2, intermediate_size=8),
               lambda: fast_keep_mask((0, 1), 0.9, (2, 3)),
               lambda: LlamaModel(vocab_size=8, hidden_size=8, num_layers=1, num_heads=2,
                                  intermediate_size=8),
               lambda: GPTModel(vocab_size=8, hidden_size=8, num_layers=1, num_heads=2),
               lambda: tnn.Transformer.generate_square_subsequent_mask(4)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn()


def test_explicit_cpu_works():
    assert resolve_device("cpu") == torch.device("cpu")
    assert CPUPlace().torch_device() == torch.device("cpu")
    m = BertModel(vocab_size=8, hidden_size=8, num_hidden_layers=1,
                  num_attention_heads=2, intermediate_size=8, device="cpu").eval()
    with torch.inference_mode():
        seq, pooled = m(torch.zeros((1, 4), dtype=torch.int32))
    assert seq.device.type == "cpu" and tuple(pooled.shape) == (1, 8)
    with pytest.raises(ValueError):
        resolve_device("meta")


_TENSOR_API = """
import numpy as np
import paddle_tpu_torch as paddle
x = np.arange(6, dtype=np.float32).reshape(2, 3)
for fn in (lambda: paddle.to_tensor(x), lambda: paddle.zeros([2]), lambda: paddle.randn([2]),
           lambda: paddle.create_parameter([2], "float32"), lambda: paddle.set_device("gpu")):
    try:
        fn()
    except RuntimeError as e:
        assert "no CUDA card" in str(e), e
    else:
        raise AssertionError("ran without a card and without the CPU asked for")
assert paddle.get_device() == "gpu:0"
t = paddle.to_tensor(x, place=paddle.CPUPlace())
assert t.place == paddle.CPUPlace() and t.shape == [2, 3]
paddle.set_device("cpu")
assert paddle.get_device() == "cpu"
y = paddle.to_tensor(x, stop_gradient=False)
(paddle.tanh(y) * 2).sum().backward()
assert y.grad.place == paddle.CPUPlace() and paddle.zeros([2]).place == paddle.CPUPlace()
print("ok")
"""


def test_to_tensor_needs_a_card_unless_the_cpu_is_asked_for(no_card):
    """The Tensor API's entry points (to_tensor, the creation and random
    ops, create_parameter, set_device("gpu")) raise without a card; they
    run on the CPU after set_device("cpu") or with place=CPUPlace(). A
    fresh interpreter, so no other test's set_device is seen."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _TENSOR_API], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


_LAYERS = """
import paddle_tpu_torch as paddle
from paddle_tpu_torch.text.models import BertModel
assert paddle.get_device() == "gpu:0"
nn = paddle.nn
for fn in (lambda: nn.Linear(3, 3), lambda: nn.Conv2D(2, 2, 3), lambda: nn.BatchNorm2D(2),
           lambda: nn.LSTM(2, 2), lambda: nn.MultiHeadAttention(4, 2),
           lambda: paddle.vision.models.resnet18(), lambda: paddle.vision.models.LeNet(),
           lambda: BertModel(vocab_size=8, hidden_size=8, num_hidden_layers=1,
                             num_attention_heads=2, intermediate_size=8)):
    try:
        fn()
    except RuntimeError as e:
        assert "no CUDA card" in str(e), e
    else:
        raise AssertionError("a layer was built without a card and without the CPU asked for")
paddle.set_device("cpu")
assert nn.Conv2D(2, 2, 3).weight.device.type == "cpu"
print("ok")
"""


def test_layers_default_to_the_card(no_card):
    """Every layer, the vision models included, builds on the current place,
    which is the card until set_device says otherwise: without a card they
    raise. A fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _LAYERS], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
