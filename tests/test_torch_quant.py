"""The port's quantized serving (paddle_tpu_torch/quantization/, the
dequantizing kernel's plain version in ops/quant_matmul.py, the decode
engine's ``quant``) against the JAX package's, on the CPU.

- ``_quantize_array`` and ``_quant_act``: bitwise the reference's.
- ``Int8Linear`` / ``quantize_weights``: the int8 buffers bitwise, a small
  MLP within 1e-6 of the JAX layers (the same dequantize-then-matmul in
  float32), a 2-layer BERT within 1e-4 of the JAX BERT (its f32 parity
  tolerance, tests/test_torch_bert.py) and within ``ACCURACY_BOUNDS`` of
  its own f32 output; ``PostTrainingQuantization``'s activation scales
  equal the reference's; a JAX ``Int8Linear``'s buffers load into the
  port's (``load_numpy_state``).
- ``quantize_decode_model`` over the toy twin, per mode: params bitwise
  the JAX ones, the weights digest the JAX engine's, engine tokens the JAX
  engine's, solo = batch (the reference's ``TestQuantDecode``); the mode
  knob (the engine reads no environment), the mismatch error, the w8a8
  rejection, and the refusal of a flat-list model on the card.
- A 2-layer Llama at head_dim 128 (7B's): the w8 and bf16w engines give
  the JAX ``llama_generate``'s tokens over the same dequantized weights,
  their prompt logits within 1e-5 relative of the JAX forward's and
  within ``ACCURACY_BOUNDS`` of the f32 model's; the weights digest is
  the reference's recipe over the reference's flat w8/bf16w params; a
  snapshot of one mode is refused by the others.
"""
import threading
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.inference.decode import DecodeModel as JaxDecodeModel
from paddle_tpu.inference.decode import _Programs as JaxPrograms
from paddle_tpu.quantization import post_training as ref_pt
from paddle_tpu.quantization import serving as ref_serving
from paddle_tpu.text import generation as jgen
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import obs
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.inference import batching
from paddle_tpu_torch.inference.decode import DecodeEngine, SnapshotRefused
from paddle_tpu_torch.inference import wire_spec as ws
from paddle_tpu_torch.ops import quant_matmul as tqm
from paddle_tpu_torch.quantization import (ACCURACY_BOUNDS, QUANT_MODES, Int8Linear,
                                           PostTrainingQuantization, quantize_decode_model,
                                           quantize_weights)
from paddle_tpu_torch.quantization import post_training as tpt
from paddle_tpu_torch.quantization import serving as tserving
from paddle_tpu_torch.text import generation as tgen
from paddle_tpu_torch.text import models as tmodels

from decode_worker import toy_decode_model
from test_torch_decode import HID, PROMPTS, VOCAB, make_engine, torch_toy_model

torch.set_num_threads(1)

MODES = ("w8", "bf16w")
TOL_LAYER = 1e-6  # one Int8Linear / the MLP, port vs JAX, relative to the max |output|
TOL_BERT = 1e-4   # the BERT parity tolerance of tests/test_torch_bert.py
TOL_LOGITS = 1e-5  # Llama prompt logits vs the JAX forward over the same weights


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _np(t):
    """A torch tensor as numpy, bf16 as ml_dtypes' bfloat16 (jax's)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ------------------------------------------------------- the quantizers
@pytest.mark.parametrize("shape,axis", [((37, 24), 1), ((24, 37), 1), ((5, 3, 16), 2),
                                        ((8, 4, 3, 3), 0), ((37, 24), None)])
def test_quantize_array_bitwise(shape, axis):
    rng = np.random.RandomState(sum(shape))
    w = (rng.randn(*shape) * rng.uniform(0.01, 3.0, shape[-1])).astype(np.float32)
    w.flat[::7] = 0.0
    w.flat[3] = 127.5 * float(np.abs(w).max()) / 127.0  # a half on the grid
    q, s = tpt._quantize_array(torch.from_numpy(w), channel_axis=axis)
    rq, rs = ref_pt._quantize_array(w, channel_axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), rq)
    assert np.asarray(s.numpy()).tobytes() == np.asarray(rs, np.float32).tobytes()


def test_quant_act_bitwise():
    import jax.numpy as jnp

    x = (np.random.RandomState(3).randn(6, 40) * 2).astype(np.float32)
    for scale in (0.0, 1.7, 5.25):
        got = tpt._quant_act(torch.from_numpy(x), scale)
        want = ref_pt._quant_act(jnp.asarray(x), scale)
        assert got.numpy().tobytes() == np.asarray(want._value).tobytes()


def test_plain_version_and_wmatmul():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32))
    w = torch.from_numpy((rng.randn(32, 48)).astype(np.float32))
    q, s = tpt._quantize_array(w, channel_axis=1)
    out = tqm.wq_matmul(x, q, s)
    assert out.shape == (3, 5, 48) and tqm.launches == 0
    assert torch.equal(out, torch.matmul(x, q.float() * s))
    wb = w.to(torch.bfloat16)
    assert torch.equal(tqm.wmatmul(x, tqm.QuantWeight(wb)), torch.matmul(x, wb.float()))
    assert torch.equal(tqm.wmatmul(x, w), torch.matmul(x, w))
    qw = tqm.QuantWeight(q, s)
    idx = torch.tensor([3, 0, 3])
    assert torch.equal(qw.rows(idx), (q.float() * s)[idx])
    assert [n for n, _ in qw.tensors("m")] == ["m", "m.scale"]


# ------------------------------------- the kernel's exact split and sum order
TOL_WQ = 1e-4  # wq_matmul against its plain version, relative to the output's max


def _bf16_rne_bits(x):
    """numpy reference of float32 -> bf16 rounding to nearest even, as the
    f32 bit pattern with the low half cleared (finite inputs)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)


def _split_inputs():
    rng = np.random.RandomState(12)
    act = (rng.randn(4096) * rng.choice([1e-3, 0.1, 1.0, 30.0], 4096)).astype(np.float32)
    # at 1e+-30 (the split is exact for |x| in [2^-103, bf16's largest])
    sign = rng.choice([-1.0, 1.0], (2, 512))
    huge = (sign[0] * rng.uniform(1.0, 10.0, 512) * 1e30).astype(np.float32)
    tiny = (sign[1] * rng.uniform(1.0, 10.0, 512) * 1e-30).astype(np.float32)
    # near ties: the bits below hi's (and below mid's) half-way points
    top = rng.randint(0x3C000000, 0x42000000, 1024).astype(np.uint32) & 0xFFFF0000
    top |= rng.randint(0, 2, 1024).astype(np.uint32) << 31
    low = np.array([0x8000, 0x7FFF, 0x8001, 0x18000, 0x0080, 0x007F, 0x0081, 0x8080,
                    0x7F80, 0x80FF, 0x0000, 0xFFFF], np.uint32)
    ties = (top[:, None] | low[None, :]).ravel().view(np.float32)
    return np.concatenate([act, huge, tiny, ties, np.float32([0.0, -0.0, 1.0, -2.5])])


def test_split_bf16_is_exact():
    """hi + mid + lo == x bitwise at activation scale, at 1e+-30 and at
    bf16 rounding ties, each piece rounded to nearest even (the device's
    cvt.rn) from what the one before left."""
    x = _split_inputs()
    hi, mid, lo = tqm.split_bf16(torch.from_numpy(x))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    h, m, lw = (t.float().numpy().astype(np.float64) for t in (hi, mid, lo))
    assert np.array_equal(h + m + lw, x.astype(np.float64))
    assert np.array_equal(hi.float().numpy().view(np.uint32), _bf16_rne_bits(x))
    r = (x.astype(np.float64) - h).astype(np.float32)
    assert np.array_equal(r.astype(np.float64), x.astype(np.float64) - h)  # exact in f32
    assert np.array_equal(mid.float().numpy().view(np.uint32), _bf16_rne_bits(r))
    # lo is what is left, exactly: the three pieces carry 8 + 8 + 8 bits
    assert np.array_equal(lw, r.astype(np.float64) - m)


def _emulate_wq_matmul(x, w, scale):
    """The kernel's arithmetic on the CPU: x split by ``split_bf16``; K cut
    into ``splits(K, N)`` ranges of whole ``KC`` chunks; within a range,
    per k-step of 16, the passes lo, mid and hi each add their 16 exact
    products to one f32 accumulator with one rounding (the MMA's); the
    ranges' partials summed in split order, then times the scale."""
    k, n = w.shape
    wd = w.double()
    pieces = [p.double() for p in reversed(tqm.split_bf16(x))]  # lo, mid, hi
    chunks, s = -(-k // tqm.KC), tqm.splits(k, n)
    out = None
    for i in range(s):
        acc = torch.zeros(x.shape[0], n, dtype=torch.float32)
        for k0 in range(i * chunks // s * tqm.KC, min(k, (i + 1) * chunks // s * tqm.KC), 16):
            for p in pieces:
                acc = (acc.double() + p[:, k0:k0 + 16] @ wd[k0:k0 + 16]).float()
        out = acc if out is None else out + acc
    return out if scale is None else out * scale


@pytest.mark.parametrize("form", MODES)
def test_three_pass_emulation_matches_the_plain_version(form):
    """The kernel's split and sum order, emulated, within TOL_WQ of the
    plain version (dequantize, then matmul) and of the JAX reference's
    ``q.astype(f32) * s`` product, at the 7B down projection's K."""
    import jax.numpy as jnp

    rng = np.random.RandomState(7)
    m, k, n = 16, 11008, 256
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.02).astype(np.float32)
    if form == "w8":
        q, s = tpt._quantize_array(torch.from_numpy(w), channel_axis=1)
        rq, rs = ref_pt._quantize_array(w, channel_axis=1)
        jax_ref = np.asarray(jnp.matmul(x, jnp.asarray(rq).astype(jnp.float32) * rs))
    else:
        q, s = torch.from_numpy(w).to(torch.bfloat16), None
        jax_ref = np.asarray(jnp.matmul(x, jnp.asarray(_np(q)).astype(jnp.float32)))
    got = _emulate_wq_matmul(torch.from_numpy(x), q.float(), s)
    ref = tqm.wq_matmul_reference(torch.from_numpy(x), q, s)
    assert tqm.splits(k, n) > 1  # the emulation crosses split boundaries
    assert _rel(got, ref) <= TOL_WQ and _rel(got, jax_ref) <= TOL_WQ


def test_split_count_depends_on_k_and_n_only():
    """The twin of the kernel's split count: enough blocks at the decode
    step's shapes, at most MAX_SPLITS, at least MIN_SPLIT_CHUNKS chunks a
    split, and never a function of M (it takes none)."""
    import inspect

    assert list(inspect.signature(tqm.splits).parameters) == ["k", "n"]
    for k in (64, 260, 768, 3072, 4096, 11008):
        for n in (16, 208, 768, 3072, 4096, 11008, 32000):
            s, chunks = tqm.splits(k, n), -(-k // tqm.KC)
            assert 1 <= s <= tqm.MAX_SPLITS
            assert s == 1 or chunks // s >= tqm.MIN_SPLIT_CHUNKS
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
        assert tqm.splits(k, n) * -(-n // tqm.NT) >= 250


# ------------------------------------------------------ Int8Linear, PTQ
class _JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 24)
        self.fc2 = jnn.Linear(24, 16)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(16, 24, device="cpu")
        self.fc2 = tnn.Linear(24, 16, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _mlps():
    paddle.seed(0)
    jm = _JaxMLP()
    jm.eval()
    tm = _MLP()
    state = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    state["fc1.bias"] = np.linspace(-0.5, 0.5, 24).astype(np.float32)
    jm.fc1.bias.set_value(state["fc1.bias"])
    load_numpy_state(tm, state)
    return jm, tm.eval()


def _calib():
    rng = np.random.RandomState(1)
    for _ in range(4):
        yield rng.randn(3, 16).astype(np.float32)


X = np.random.RandomState(0).randn(5, 16).astype(np.float32)


def _run(jm, tm, x=X):
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    return got, np.asarray(jm(paddle.to_tensor(x)).numpy())


@pytest.mark.parametrize("act_quant", [False, True], ids=["w8", "w8a8"])
@pytest.mark.parametrize("algo", ["abs_max", "avg"])
def test_ptq_and_int8_linear_match_the_reference(act_quant, algo):
    jm, tm = _mlps()
    f32, _ = _run(jm, tm)
    tptq = PostTrainingQuantization(tm, sample_generator=_calib, algo=algo)
    jptq = ref_pt.PostTrainingQuantization(jm, sample_generator=_calib, algo=algo)
    tptq.quantize(act_quant=act_quant)
    jptq.quantize(act_quant=act_quant)
    assert tptq.activation_scales == pytest.approx(jptq.activation_scales, rel=0, abs=0)
    assert sorted(tptq.activation_scales) == ["fc1", "fc2"]
    for name in ("fc1", "fc2"):
        tl, jl = getattr(tm, name), getattr(jm, name)
        assert isinstance(tl, Int8Linear)
        assert np.array_equal(tl.qweight.numpy(), np.asarray(jl.qweight))
        assert np.array_equal(tl.w_scale.numpy(), np.asarray(jl.w_scale))
        assert np.array_equal(tptq.weight_scales[name].numpy(), jptq.weight_scales[name])
        assert (tl.act_scale is None) == (not act_quant)
    got, want = _run(jm, tm)
    assert _rel(got, want) < TOL_LAYER
    mode = "w8a8" if act_quant else "w8"
    assert 0 < _rel(got, f32) < ACCURACY_BOUNDS[mode]
    assert tserving.detect_mode(tm) == ref_serving.detect_mode(jm) == mode
    with pytest.raises(NotImplementedError, match="jit"):
        tptq.save_quantized_model("nowhere")


def test_jax_int8_buffers_load_into_the_port():
    jm, tm = _mlps()
    ref_pt.quantize_weights(jm)
    quantize_weights(tm)
    for layer in (tm.fc1, tm.fc2):  # scramble, then load the reference's
        layer.qweight.zero_()
        layer.w_scale.fill_(1.0)
    state = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    state.update({n: np.asarray(b) for n, b in jm.named_buffers()})
    assert state["fc1.qweight"].dtype == np.int8
    load_numpy_state(tm, state)
    got, want = _run(jm, tm)
    assert _rel(got, want) < TOL_LAYER
    with pytest.raises(TypeError, match="dtype"):
        load_numpy_state(tm, {**state, "fc1.qweight": state["fc1.qweight"].astype(np.int16)})


def test_quantize_for_serving_in_place():
    for mode in ("w8", "w8a8", "bf16w", None):
        jm, tm = _mlps()
        got = tserving.quantize_for_serving(tm, mode, calib=_calib)[1]
        want = ref_serving.quantize_for_serving(jm, mode, calib=_calib)[1]
        assert got == want, mode
    _, tm = _mlps()
    quantize_weights(tm)
    assert tserving.quantize_for_serving(tm, None)[1] == {"mode": "w8", "detected": True}
    with pytest.raises(ValueError, match="already carries"):
        tserving.quantize_for_serving(tm, "bf16w")
    with pytest.raises(ValueError, match="unknown quant mode"):
        tserving.check_mode("int4")
    assert tserving.check_mode("f32") is None and QUANT_MODES == ref_serving.QUANT_MODES
    assert ACCURACY_BOUNDS == ref_serving.ACCURACY_BOUNDS


def test_quantize_weights_refuses_a_conv_and_skips_qat_wrappers():
    class QuantedLinear(torch.nn.Module):  # the reference's QAT wrapper, by name
        def __init__(self):
            super().__init__()
            self.inner = tnn.Linear(4, 4, device="cpu")

    m = torch.nn.Sequential(QuantedLinear(), tnn.Linear(4, 8, device="cpu"))
    _, stats = quantize_weights(m)
    assert sorted(stats) == ["1"] and isinstance(m[0].inner, tnn.Linear)
    with pytest.raises(NotImplementedError, match="not one of the port's layers"):
        quantize_weights(torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3)))
    from paddle_tpu_torch.core import place as tplace
    from paddle_tpu_torch.quantization import Int8Conv2D

    prev = tplace._CURRENT
    tplace._CURRENT = tplace.CPUPlace()
    try:
        convs = torch.nn.Sequential(tnn.Conv2D(3, 4, 3), tnn.Conv1D(2, 2, 3))
    finally:
        tplace._CURRENT = prev
    _, stats = quantize_weights(convs)  # the port's Conv2D converts, as in the reference
    assert sorted(stats) == ["0"] and isinstance(convs[0], Int8Conv2D)
    assert isinstance(convs[1], tnn.Conv1D)


def test_bert_quantized_matches_the_reference():
    """quantize_weights over a 2-layer BERT: the int8 weights and scales of
    every Linear bitwise the reference's, every Int8Linear within 1e-6 of
    the JAX one on the same input, and the whole model within 1e-4 of the
    JAX BERT over the same dequantized weights (the reference's own
    quantized BERT does not run: its fused QKV reads the projections'
    ``.weight``) and within ``ACCURACY_BOUNDS`` of its f32 output."""
    from paddle_tpu.text.models import BertModel as JaxBert
    from paddle_tpu_torch.text.models import BertModel

    cfg = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=256)
    paddle.seed(0)
    jm = JaxBert(**cfg)
    jm.eval()
    state = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    tm = BertModel(**cfg, device="cpu").eval()
    load_numpy_state(tm, state)
    ids = np.random.RandomState(0).randint(0, 1024, (2, 64)).astype(np.int32)
    with torch.inference_mode():
        f32 = tm(torch.from_numpy(ids))[0].numpy()
    _, jstats = ref_pt.quantize_weights(jm)
    _, tstats = quantize_weights(tm)
    assert sorted(tstats) == sorted(jstats) and len(tstats) == 6 * 2 + 1
    x = np.random.RandomState(1).randn(3, 256).astype(np.float32)
    for name in tstats:
        assert np.array_equal(tstats[name].numpy(), jstats[name]), name
        tl, jl = tm.get_submodule(name), dict(jm.named_sublayers())[name]
        assert np.array_equal(tl.qweight.numpy(), np.asarray(jl.qweight)), name
        xin = x[:, :tl.qweight.shape[0]]
        with torch.no_grad():
            got = tl(torch.from_numpy(xin)).numpy()
        assert _rel(got, np.asarray(jl(paddle.to_tensor(xin)).numpy())) < TOL_LAYER, name
    for name in tstats:  # the JAX BERT over the dequantized weights
        tl = tm.get_submodule(name)
        state[name + ".weight"] = (tl.qweight.float() * tl.w_scale).numpy()
    paddle.seed(0)
    jdq = JaxBert(**cfg)
    jdq.eval()
    for name, p in jdq.named_parameters():
        p.set_value(state[name])
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids))[0].numpy()
    want = np.asarray(jdq(paddle.to_tensor(ids))[0].numpy())
    assert np.max(np.abs(got - want)) < TOL_BERT
    assert 0 < _rel(got, f32) < ACCURACY_BOUNDS["w8"]


def test_batching_quant_label_reads_the_layer():
    """The compiles' ``quant`` label and ``stats()["quant"]`` read "f32"
    for a plain layer and for one quantized in place by
    ``quantize_weights``, as in the reference (whose label is the layer's
    ``_quant_mode``, set only by ``jit.save(quant=)``)."""
    layers = [_mlps()[1], quantize_weights(_mlps()[1])[0]]
    assert tserving.detect_mode(layers[0]) is None
    assert tserving.detect_mode(layers[1]) == "w8"

    def runner(layer):
        def fn(x):
            with torch.no_grad():
                return layer(torch.from_numpy(x))
        return fn

    engines = [batching.BatchingEngine.for_callable(runner(layer), name=n, watchdog_interval=0)
               for layer, n in zip(layers, ("q-label-f32", "q-label-w8"))]
    try:
        for eng in engines:
            eng.warmup(signature=[("float32", (16,))])
        assert [e.stats()["quant"] for e in engines] == ["f32", "f32"]
        text = obs.render()
        for name, mode in (("q-label-f32", "f32"), ("q-label-w8", "f32")):
            line = next(ln for ln in text.splitlines()
                        if ln.startswith("paddle_serving_compiles_total{")
                        and f'engine="{name}"' in ln)
            assert f'quant="{mode}"' in line
    finally:
        for eng in engines:
            eng.close()


# -------------------------------------------------------- the toy twin
def _ref_params(mode):
    return [np.asarray(p) for p in ref_serving.quantize_decode_model(
        toy_decode_model(hidden=HID, vocab=VOCAB, seed=0), mode).params]


@pytest.mark.parametrize("mode", MODES)
def test_toy_params_digest_and_tokens_equal_the_jax_engine(mode):
    qm = quantize_decode_model(torch_toy_model(), mode)
    assert qm.quant == mode
    want = _ref_params(mode)
    assert len(qm.params) == len(want) == (12 if mode == "w8" else 6)
    for got, ref in zip(qm.params, want):
        assert _np(got).dtype == ref.dtype and _np(got).tobytes() == ref.tobytes()
    jm = ref_serving.quantize_decode_model(toy_decode_model(hidden=HID, vocab=VOCAB, seed=0),
                                           mode)
    jeng = JaxEngine(jm, max_slots=4, max_seq_len=32, min_seq_bucket=8, watchdog_interval=0,
                     prefix=False, name=f"jq-{mode}")
    try:
        jreqs = [jeng.submit(p, max_new_tokens=8) for p in PROMPTS]
        jtoks = [r.result(timeout=120).tolist() for r in jreqs]
        jdigest = jeng._programs._weights_digest()
        assert jeng.stats()["quant"] == mode
    finally:
        jeng.close()
    assert qm.weights_digest()[0] == jdigest
    with make_engine(qm, name=f"tq-{mode}") as eng:
        toks = [r.result(timeout=60).tolist()
                for r in [eng.submit(p, max_new_tokens=8) for p in PROMPTS]]
        st = eng.stats()
    assert toks == jtoks
    assert st["quant"] == mode
    assert tserving.weight_bytes(qm.params) == sum(a.nbytes for a in want)


@pytest.mark.parametrize("mode", MODES)
def test_toy_solo_vs_batch_bitwise(mode):
    """The reference's TestQuantDecode.test_solo_vs_batch_bitwise: staggered
    joins and neighbours of other lengths, per mode."""
    qm = quantize_decode_model(torch_toy_model(), mode)
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    short = np.array([9, 2], np.int32)
    solos = []
    for p, n in ((prompt, 10), (short, 4)):
        with make_engine(qm, name=f"solo-{mode}") as eng:
            solos.append(eng.generate(p, max_new_tokens=n, timeout=60).tolist())
    with make_engine(qm, name=f"batch-{mode}") as eng:
        reqs = [eng.submit(prompt, max_new_tokens=10), eng.submit(short, max_new_tokens=4),
                eng.submit(prompt, max_new_tokens=10)]
        outs = [r.result(timeout=60).tolist() for r in reqs]
        assert eng.stats()["quant"] == mode
        assert f'quant="{mode}"' in obs.render()
    assert outs == [solos[0], solos[1], solos[0]]


def test_engine_quant_knobs(monkeypatch):
    """``quant=`` is the engine's one mode setting: the reference's
    ``PADDLE_TPU_SERVING_QUANT`` is not read (the port reads no
    environment)."""
    model = torch_toy_model()
    monkeypatch.setenv("PADDLE_TPU_SERVING_QUANT", "w8")
    with make_engine(model, name="q-env") as eng:
        assert eng.stats()["quant"] == "f32" and eng._model is model
    with make_engine(model, name="q-w8", quant="w8") as eng:
        assert eng.stats()["quant"] == "w8" and eng._model.quant == "w8"
        assert eng._model is not model and model.quant is None
    monkeypatch.delenv("PADDLE_TPU_SERVING_QUANT")
    with make_engine(model, name="q-f32", quant="f32") as eng:
        assert eng.stats()["quant"] == "f32" and eng._model is model
    qm = quantize_decode_model(model, "w8")
    with pytest.raises(ValueError, match="quantized as 'w8'"):
        make_engine(qm, quant="bf16w")
    with make_engine(qm, name="q-same", quant="w8") as eng:
        assert eng._model is qm
    with pytest.raises(ValueError, match="already quantized"):
        quantize_decode_model(qm, "bf16w")
    with pytest.raises(ValueError, match="w8a8"):
        make_engine(model, quant="w8a8")
    with pytest.raises(ValueError, match="unknown quant mode"):
        make_engine(model, quant="int4")
    assert quantize_decode_model(model, "f32") is model


@pytest.mark.parametrize("mode", MODES)
def test_flat_list_model_on_the_card_is_refused(mode):
    """A flat-list ``DecodeModel`` quantizes only on the CPU: its wrapped
    functions dequantize every param at every call (the plain path), which
    on the card would write an f32 copy of the model per step. One marked
    as on the card raises; Llama's weights are the card's quantized path."""
    model = torch_toy_model()
    model.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="flat param list"):
        quantize_decode_model(model, mode)
    model.device = torch.device("cpu")
    assert quantize_decode_model(model, mode).quant == mode


def test_draft_follows_the_target_mode():
    draft = torch_toy_model(hidden=8, seed=1, anchor=4.0)
    target = torch_toy_model(seed=0, anchor=4.0, draft=draft)
    with make_engine(target, name="q-spec", spec_k=4, quant="bf16w") as eng:
        assert eng._model.quant == eng._model.draft.quant == "bf16w"
        assert eng.spec_enabled
        p = np.array([1, 2, 3], np.int32)
        spec = eng.generate(p, max_new_tokens=8, speculative=True, timeout=60)
        plain = eng.generate(p, max_new_tokens=8, timeout=60)
    assert spec.tolist() == plain.tolist()
    own = quantize_decode_model(torch_toy_model(hidden=8, seed=1, anchor=4.0), "w8")
    target = torch_toy_model(seed=0, anchor=4.0, draft=own)
    with make_engine(target, name="q-spec-own", spec_k=4, quant="bf16w") as eng:
        assert eng._model.draft is own


# ------------------------------------------------------------ Llama
LLAMA = dict(vocab_size=128, hidden_size=256, num_layers=2, num_heads=2, intermediate_size=512)
LLAMA_PROMPTS = [np.random.RandomState(s).randint(0, 128, (7,)).astype(np.int32)
                 for s in range(3)]
N_NEW = 6


@pytest.fixture(scope="module")
def llama():
    paddle.seed(7)
    jm = jmodels.LlamaModel(**LLAMA)
    tm = tmodels.LlamaModel(**LLAMA, device="cpu")
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    assert tm.layers[0].self_attn.head_dim == 128
    return jm, tm.eval()


def _dequantized_jax(jm, dm):
    """The JAX Llama with the port's quantized weights, dequantized to f32."""
    w = dm.params
    state = {}
    for name, t in w.named_tensors():
        if name.endswith(".scale"):
            continue
        scale = dict(w.named_tensors()).get(name + ".scale")
        state[name] = tqm.dequantize(t, scale).numpy()
    for name, p in jm.named_parameters():
        p.set_value(state[name])
    return jm


def _jax_digest(jm, mode):
    """The reference's weights digest over the reference's flat params of
    ``mode`` (its quantize_decode_model over the Llama's params)."""
    params = [p._value for _, p in jm.named_parameters()]
    flat = JaxDecodeModel(params, None, None, kv_spec=[], vocab_size=LLAMA["vocab_size"])
    qm = ref_serving.quantize_decode_model(flat, mode)
    prog = types.SimpleNamespace(_weights_digest_cached=None, _fp_lock=threading.Lock(),
                                 _model=qm)
    return JaxPrograms._weights_digest(prog)


@pytest.mark.parametrize("mode", MODES)
def test_llama_engine_matches_jax_over_the_dequantized_weights(llama, mode):
    jm, tm = llama
    f32_dm = tgen.llama_decode_model(tm, 4, 32)
    f32_logits = [tgen.llama_prompt_logits(f32_dm, p).numpy() for p in LLAMA_PROMPTS]
    digest = _jax_digest(jm, mode)
    with DecodeEngine(f32_dm, device="cpu", max_prompt_len=16, quant=mode,
                      name=f"llama-{mode}") as eng:
        dm = eng._model
        reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in LLAMA_PROMPTS]
        got = [r.result(timeout=60).tolist() for r in reqs]
        assert eng.stats()["quant"] == mode and eng._identity()[1] == digest
    assert dm.kv_spec == f32_dm.kv_spec and dm.kv_spec[0][1] == torch.float32
    kinds = {type(v).__name__ for v in dm.params.params["layers"][0].values()}
    assert kinds == {"QuantWeight", "Tensor"}
    jq = _dequantized_jax(jmodels.LlamaModel(**LLAMA), dm)
    want = jgen.llama_generate(jq, np.stack(LLAMA_PROMPTS), max_new_tokens=N_NEW)
    assert got == want[:, 7:].tolist()
    for p, ref in zip(LLAMA_PROMPTS, f32_logits):
        logits = tgen.llama_prompt_logits(dm, p).numpy()
        jl = np.asarray(jq(paddle.to_tensor(p[None]))._value)[0, -1]
        assert _rel(logits, jl) < TOL_LOGITS
        assert 0 < _rel(logits, ref) < ACCURACY_BOUNDS[mode]


def test_llama_snapshot_of_one_mode_is_refused_by_the_others(llama):
    _, tm = llama
    dm = tgen.llama_decode_model(tm, 4, 32)
    engines = {m: DecodeEngine(dm, device="cpu", max_prompt_len=16, quant=m,
                               name=f"snap-{m}") for m in ("f32", "w8", "bf16w")}
    try:
        req = engines["w8"].submit(LLAMA_PROMPTS[0], max_new_tokens=4, snapshot_every=2)
        req.result(timeout=60)
        snap = req.latest_snapshot()
        assert ws.decode_kv_snapshot_header(snap)["quant"] == "w8"
        engines["w8"].check_snapshot(snap)
        for m in ("f32", "bf16w"):
            with pytest.raises(SnapshotRefused) as err:
                engines[m].check_snapshot(snap)
            assert err.value.status_code == 2
        fps = {m: e._identity()[0] for m, e in engines.items()}
        assert len(set(fps.values())) == 3
    finally:
        for e in engines.values():
            e.close()
