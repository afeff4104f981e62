"""The port stands alone: nothing in paddle_tpu_torch/ or chip_smoke.py
imports jax or the JAX package, and its entry points run on the card
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
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


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
