"""The port's Llama (paddle_tpu_torch/text/models.py) against the JAX
package's, module by module, at a small config (vocab 97, hidden 128, 2
heads of head_dim 64, FFN 256, 2 layers; a GQA case with 1 KV head), with
the JAX model's weights carried across by ``convert.load_numpy_state``
and inputs from a numpy seed. On the CPU the JAX side runs its XLA path;
the port's causal attention runs K1's plain version. Tolerances: float32
within 1e-5 abs; bfloat16 (both models cast by ``to``) within 2e-2 of the
output's max magnitude (the two sides round bf16 chains at other points,
and K1 keeps the scores in float32 where the reference rounds them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text import models as tmodels

torch.set_num_threads(1)

CFG = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)
TOL_F32 = 1e-5
TOL_BF16 = 2e-2  # of the max magnitude


def _state(jm):
    return {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}


def _carry(jm, tm):
    load_numpy_state(tm, _state(jm))
    jm.eval()
    return tm.eval()


def _build(num_kv_heads, dtype="float32"):
    """The JAX model from seed 3 and the port's with its weights, both cast
    to ``dtype`` (a bf16 pair is built fresh: casting back would not
    restore the float32 weights)."""
    paddle.seed(3)
    jm = jmodels.LlamaModel(**CFG, num_kv_heads=num_kv_heads)
    tm = _carry(jm, tmodels.LlamaModel(**CFG, num_kv_heads=num_kv_heads, device="cpu"))
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
        tm.to(torch.bfloat16)
    return jm, tm


@pytest.fixture(scope="module", params=[None, 1], ids=["mha", "gqa1"])
def kv_heads(request):
    return request.param


@pytest.fixture(scope="module")
def llama(kv_heads):
    return _build(kv_heads)


def _pair(llama, kv_heads, dtype):
    return llama if dtype == "float32" else _build(kv_heads, dtype)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_j(fn, x, dtype):
    return np.asarray(fn(paddle.to_tensor(x).astype(dtype)).astype("float32").numpy())


def _run_t(fn, x, dtype):
    with torch.inference_mode():
        return fn(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)
    else:
        assert np.abs(got - want).max() <= TOL_BF16 * np.abs(want).max()


def test_parameter_names_and_shapes_match(llama):
    jm, tm = llama
    jp = dict(jm.named_parameters())
    tp = dict(tm.named_parameters())
    assert list(jp) == list(tp)
    assert "layers.0.self_attn.q_proj.weight" in tp
    assert not any(n.endswith(".bias") for n in tp)  # bias_attr=False: no bias at all
    for n in jp:
        assert tuple(jp[n].shape) == tuple(tp[n].shape), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    x = _x((2, 5, 128)) * 3.0
    w = _x((128,), seed=1)
    want = np.asarray(jmodels.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
                      .astype(jnp.float32))
    td = getattr(torch, dtype)
    got = tmodels.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td)).float().numpy()
    _close(got, want, dtype)
    layer = tmodels.RMSNorm(128, device="cpu")
    assert torch.equal(layer.weight.detach(), torch.ones(128))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", [None, [130], [5, 6, 7, 8, 9, 10]])
def test_rope_matches(dtype, positions):
    t = 6 if positions is None else len(positions)
    x = _x((2, 3, t, 64))
    jpos = None if positions is None else jnp.asarray(positions)
    want = np.asarray(jmodels._rope(jnp.asarray(x, dtype), positions=jpos)
                      .astype(jnp.float32))
    tpos = None if positions is None else torch.tensor(positions)
    got = tmodels._rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        positions=tpos).float().numpy()
    _close(got, want, dtype)


def test_silu_matches():
    import jax

    x = _x((4, 33)) * 4
    want = np.asarray(jax.nn.silu(jnp.asarray(x)))
    np.testing.assert_allclose(TF.silu(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("part", ["attention", "mlp", "layer"])
def test_llama_parts_match(llama, kv_heads, dtype, part):
    jm, tm = _pair(llama, kv_heads, dtype)
    pick = {"attention": lambda m: m.layers[0].self_attn,
            "mlp": lambda m: m.layers[1].mlp,
            "layer": lambda m: m.layers[1]}[part]
    x = _x((2, 9, 128), seed=2)
    before = tfa.launches
    _close(_run_t(pick(tm), x, dtype), _run_j(pick(jm), x, dtype), dtype)
    assert tfa.launches == before  # CPU tensors run K1's plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_forward_matches(llama, kv_heads, dtype):
    jm, tm = _pair(llama, kv_heads, dtype)
    ids = np.random.RandomState(1).randint(0, CFG["vocab_size"], (2, 11)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).astype("float32").numpy())
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).float().numpy()
    assert got.shape == (2, 11, CFG["vocab_size"])
    _close(got, want, dtype)


def test_linear_bias_attr_false_has_no_bias():
    lin = tnn.Linear(4, 3, bias_attr=False, device="cpu")
    assert lin.bias is None and [n for n, _ in lin.named_parameters()] == ["weight"]
    x = torch.randn(2, 4)
    torch.testing.assert_close(lin(x), x @ lin.weight.detach())
    assert [n for n, _ in tnn.Linear(4, 3, device="cpu").named_parameters()] == ["weight", "bias"]


def test_initializer_draws_on_the_generator_device():
    """A generator given by the caller draws on its own device (a CUDA one
    on the card); a CPU generator gives the same values as before: the
    draw then a move, so a seed gives the same weights everywhere."""
    g = torch.Generator().manual_seed(7)
    p = I.create_parameter([3, 5], I.XavierNormal(), torch.device("cpu"), g)
    want = torch.randn(3, 5, generator=torch.Generator().manual_seed(7)) * (2.0 / 8) ** 0.5
    torch.testing.assert_close(p.detach(), want, rtol=0, atol=0)
    c = I.create_parameter([4], I.Constant(1.5), torch.device("cpu"))
    assert torch.equal(c.detach(), torch.full((4,), 1.5))


def test_tensor_parallel_raises():
    """``tensor_parallel=True`` stamps the reference's mp specs, and outside
    a tensor-parallel scope the stamped model is the plain one: its logits
    are the reference's stamped model's. A step over an mp mesh needs the
    mp ranks' process group, so in one process outside a job it raises
    (tests/test_torch_dist_model_parallel.py trains it over gloo ranks)."""
    from paddle_tpu_torch.distributed import spmd as tspmd, topology as ttopology
    from paddle_tpu_torch import optimizer as topt

    paddle.seed(3)
    jm = jmodels.LlamaModel(**CFG, num_kv_heads=1, tensor_parallel=True)
    tm = _carry(jm, tmodels.LlamaModel(**CFG, num_kv_heads=1, tensor_parallel=True,
                                       device="cpu"))
    for n, p in jm.named_parameters():
        spec = getattr(p, "mp_spec", None)
        assert getattr(dict(tm.named_parameters())[n], "mp_spec", None) == \
            (None if spec is None else tuple(spec)), n
    ids = np.random.RandomState(1).randint(0, CFG["vocab_size"], (2, 9)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)
    with pytest.raises(RuntimeError, match="no group"):
        tspmd.build_train_step(tm, lambda out, y: out.sum(),
                               topt.AdamW(parameters=tm.parameters()),
                               mesh=ttopology.Mesh((1,) * 5 + (2,)))
