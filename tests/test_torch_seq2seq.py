"""The decoder side of the port's nn against the JAX package's:
MultiHeadAttention's Cache / StaticCache / gen_cache (with kdim, vdim and
no bias), TransformerDecoderLayer, TransformerDecoder and Transformer
(masks, normalize_before, gradients), incremental = full decoding,
gather_tree, and BeamSearchDecoder + dynamic_decode over a GRUCell, an
LSTMCell and chip_smoke.py's Transformer-decoder cell (TranslationCell,
held against a JAX twin). Weights are carried across by
convert.load_numpy_state, inputs come from a numpy seed; small widths
(d_model 16, 4 heads, 2 + 2 layers, vocab 11). Tolerance 1e-5 in
float32; ids, parents and gather_tree bitwise."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.nn import decode as tdecode

torch.set_num_threads(1)

TOL = 1e-5
# one target length and one source length throughout: the JAX side
# compiles each op once per shape
D, HEADS, FFN, VOCAB, SRC, TGT = 16, 4, 32, 11, 6, 4


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.numpy())


def _state(jlayer):
    return {n: np.asarray(p.numpy()) for n, p in jlayer.named_parameters()}


def _pair(jlayer, tlayer, seed=100):
    """Give every JAX parameter its own seeded values at an initializer's
    scale, 0.25 (the stacks start as copies of one layer), carry them into
    tlayer; both in eval mode."""
    for i, (_, p) in enumerate(jlayer.named_parameters()):
        p.set_value(0.25 * _x(*p.shape, seed=seed + i))
    jlayer.eval()
    tlayer.eval()
    assert list(_state(jlayer)) == [n for n, _ in tlayer.named_parameters()]
    load_numpy_state(tlayer, _state(jlayer))
    return jlayer, tlayer


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def J(a):
    return None if a is None else paddle.to_tensor(a)


def T(a):
    return None if a is None else torch.from_numpy(a)


def _mha_pair(**kw):
    return _pair(jnn.MultiHeadAttention(D, HEADS, **kw),
                 tnn.MultiHeadAttention(D, HEADS, device="cpu", **kw))


@pytest.mark.parametrize("bias", [True, False])
def test_mha_incremental_cache(bias):
    kw = {} if bias else dict(bias_attr=False)
    j, t = _mha_pair(**kw)
    x1, x2 = _x(2, TGT - 1, D, seed=1), _x(2, 1, D, seed=2)
    jc, tc = j.gen_cache(J(x1)), t.gen_cache(T(x1))
    assert tuple(tc.k.shape) == (2, HEADS, 0, D // HEADS) and isinstance(tc, t.Cache)
    with torch.inference_mode():
        for x in (x1, x2):  # two calls: the cache grows 0 -> TGT - 1 -> TGT
            jout, jc = j(J(x), cache=jc)
            tout, tc = t(T(x), cache=tc)
            _close(tout, jout)
            _close(tc.k, jc.k)
            _close(tc.v, jc.v)
    assert tuple(tc.k.shape) == (2, HEADS, TGT, D // HEADS)
    # gen_cache(key, value) wraps the given tensors as they are
    k, v = T(_x(2, HEADS, SRC, D // HEADS, seed=3)), T(_x(2, HEADS, SRC, D // HEADS, seed=4))
    given = t.gen_cache(k, v)
    assert isinstance(given, t.Cache) and given.k is k and given.v is v


@pytest.mark.parametrize("mask", [False, True])
def test_mha_static_cache_and_need_weights(mask):
    j, t = _mha_pair(need_weights=True)
    x, mem = _x(2, TGT, D, seed=1), _x(2, SRC, D, seed=2)
    m = None
    if mask:
        m = np.ones((2, 1, 1, SRC), bool)
        m[1, ..., 3:] = False
    js = j.gen_cache(J(mem), J(mem), type=jnn.MultiHeadAttention.StaticCache)
    with torch.inference_mode():
        ts = t.gen_cache(T(mem), T(mem), type=tnn.MultiHeadAttention.StaticCache)
        assert isinstance(ts, t.StaticCache)
        _close(ts.k, js.k)
        jout = j(J(x), J(mem), J(mem), J(m), js)
        tout = t(T(x), T(mem), T(mem), T(m), ts)
        # under a static cache key and value are not read
        tnone = t(T(x), None, None, T(m), ts)
        # need_weights: (out, None), and (out, None, cache) under a Cache
        tinc = t(T(x), cache=t.gen_cache(T(x)))
    assert isinstance(jout, tuple) and len(jout) == len(tout) == 2 and tout[1] is None
    _close(tout[0], jout[0])
    _close(tnone[0], jout[0])
    assert len(tinc) == 3 and tinc[1] is None and isinstance(tinc[2], t.Cache)


@pytest.mark.parametrize("bias", [True, False])
def test_mha_kdim_vdim(bias):
    kw = dict(kdim=8, vdim=12) if bias else dict(kdim=8, vdim=12, bias_attr=False)
    j, t = _mha_pair(**kw)
    assert tuple(t.k_proj.weight.shape) == (8, D) and tuple(t.v_proj.weight.shape) == (12, D)
    assert (t.q_proj.bias is None) == (not bias)
    q, k, v = _x(2, TGT, D, seed=1), _x(2, SRC, 8, seed=2), _x(2, SRC, 12, seed=3)
    m = np.where(np.arange(SRC) < 4, 0.0, -1e4).astype(np.float32)[None, None, None]
    for mask in (None, m):
        jout = j(J(q), J(k), J(v), J(mask))
        with torch.inference_mode():
            tout = t(T(q), T(k), T(v), T(mask))
        _close(tout, jout)
    # a static cache projects key and value once, through kdim and vdim
    js = j.gen_cache(J(k), J(v), type=jnn.MultiHeadAttention.StaticCache)
    with torch.inference_mode():
        ts = t.gen_cache(T(k), T(v), type=tnn.MultiHeadAttention.StaticCache)
        _close(t(T(q), cache=ts), j(J(q), cache=js))


def test_mha_fused_self_attention_without_bias():
    j, t = _mha_pair(bias_attr=False)
    x = _x(2, TGT, D, seed=1)
    with torch.inference_mode():
        _close(t(T(x)), j(J(x)))


def _masks(tgt_len, src_len, b=2):
    causal = np.triu(np.full((tgt_len, tgt_len), -np.inf, np.float32), k=1)
    mem = np.ones((b, 1, 1, src_len), bool)
    mem[1, ..., src_len - 2:] = False
    return causal, mem


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_decoder_layer(normalize_before, masked):
    j, t = (m.decoder.layers[0] for m in _transformer_pair(normalize_before))
    tgt, mem = _x(2, TGT, D, seed=1), _x(2, SRC, D, seed=2)
    tm, mm = _masks(TGT, SRC) if masked else (None, None)
    jout = j(J(tgt), J(mem), J(tm), J(mm))
    with torch.inference_mode():
        tout = t(T(tgt), T(mem), T(tm), T(mm))
    _close(tout, jout)


@functools.lru_cache(maxsize=None)
def _transformer_pair(normalize_before):
    """One seeded pair per setting for the whole file (the JAX package
    compiles a draw for every parameter it creates), in eval mode."""
    args = dict(d_model=D, nhead=HEADS, num_encoder_layers=2, num_decoder_layers=2,
                dim_feedforward=FFN, dropout=0.0, normalize_before=normalize_before)
    return _pair(jnn.Transformer(**args), tnn.Transformer(**args, device="cpu"))


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_transformer(normalize_before, masked):
    j, t = _transformer_pair(normalize_before)
    assert (t.encoder.norm is None) == (not normalize_before)
    src, tgt = _x(2, SRC, D, seed=1), _x(2, TGT, D, seed=2)
    tm, mm = _masks(TGT, SRC) if masked else (None, None)
    jout = j(J(src), J(tgt), J(mm), J(tm), J(mm))
    with torch.inference_mode():
        tout = t(T(src), T(tgt), T(mm), T(tm), T(mm))
    _close(tout, jout)
    # the decoder stack alone, and the encoder stack with its caches
    mem = _x(2, SRC, D, seed=3)
    with torch.inference_mode():
        _close(t.decoder(T(tgt), T(mem), T(tm), T(mm)), j.decoder(J(tgt), J(mem), J(tm), J(mm)))
        jenc, jcache = j.encoder(J(src), J(mm), j.encoder.gen_cache(J(src)))
        tenc, tcache = t.encoder(T(src), T(mm), t.encoder.gen_cache(T(src)))
    _close(tenc, jenc)
    for jc, tc in zip(jcache, tcache):
        _close(tc.k, jc.k)


def test_transformer_gradients():
    """d out.mean() / d every parameter, through the flash kernels' plain
    versions (the encoder and the cross-attention, unmasked) and the
    masked softmax (the decoder's causal self-attention), within 1e-5 of
    each gradient's max. The key projections' biases have a zero gradient
    (softmax ignores a constant added to every score of a row): there
    both packages' rounding noise must stay within 1e-5 of the model's
    largest gradient."""
    args = dict(d_model=D, nhead=HEADS, num_encoder_layers=2, num_decoder_layers=2,
                dim_feedforward=FFN, dropout=0.0, normalize_before=True)
    j, t = _pair(jnn.Transformer(**args), tnn.Transformer(**args, device="cpu"))
    j.train()
    t.train()
    src, tgt = _x(2, SRC, D, seed=1), _x(2, TGT, D, seed=2)
    tm, _ = _masks(TGT, SRC)
    j(J(src), J(tgt), None, J(tm)).mean().backward()
    t(T(src), T(tgt), None, T(tm)).mean().backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in j.named_parameters()}
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    for n, p in t.named_parameters():
        got, want = p.grad.numpy(), jgrads[n]
        if n.endswith("k_proj.bias"):
            assert max(np.abs(got).max(), np.abs(want).max()) <= TOL * top, n
            continue
        assert np.abs(got - want).max() <= TOL * float(np.abs(want).max()), n


def test_custom_encoder_and_decoder():
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(D, HEADS, FFN, device="cpu"), 1)
    dec = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(D, HEADS, FFN, device="cpu"), 3)
    t = tnn.Transformer(D, HEADS, custom_encoder=enc, custom_decoder=dec, device="cpu")
    assert t.encoder is enc and t.decoder is dec and len(t.decoder.layers) == 3
    names = [n for n, _ in t.named_parameters()]
    assert names[0].startswith("encoder.layers.0.") and not any("layers.1" in n and
                                                                n.startswith("encoder")
                                                                for n in names)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_incremental_decoding_equals_full(normalize_before):
    """Step by step through gen_cache's caches (the flash kernels' single
    query over the grown cache; the static cache with memory=None) equals
    one forward under the causal mask, in the port and in the JAX
    package, and the two packages' steps agree."""
    j, t = _transformer_pair(normalize_before)
    src, tgt = _x(2, SRC, D, seed=1), _x(2, TGT, D, seed=2)
    causal, _ = _masks(TGT, SRC)
    jmem = j.encoder(J(src))
    with torch.inference_mode():
        tmem = t.encoder(T(src))
        full = t.decoder(T(tgt), tmem, T(causal))
        tcache = t.decoder.gen_cache(tmem)
        jcache = j.decoder.gen_cache(jmem)
        steps = []
        for i in range(TGT):
            out, tcache = t.decoder(T(tgt[:, i:i + 1]), None, None, None, tcache)
            jout, jcache = j.decoder(J(tgt[:, i:i + 1]), None, None, None, jcache)
            _close(out, jout)
            steps.append(out)
        zipped = t.decoder.gen_cache(tmem, do_zip=True)
    _close(torch.cat(steps, dim=1), full)
    assert len(zipped) == 2 and all(isinstance(c, t.decoder.layers[0].self_attn.Cache)
                                    for c in zipped[0])


def test_gather_tree_bitwise():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, (7, 3, 4)).astype(np.int64)
    parents = rng.randint(0, 4, (7, 3, 4)).astype(np.int64)
    want = np.asarray(JF.gather_tree(J(ids), J(parents)).numpy())
    got = tnn.functional.gather_tree(T(ids), T(parents))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's oracle: beam 0 at t=1 came from beam 1
    o = tnn.functional.gather_tree(torch.tensor([[[1, 2]], [[3, 4]]]),
                                   torch.tensor([[[0, 0]], [[1, 0]]]))
    assert o[0, 0, 0] == 2 and o[1, 0, 0] == 3 and o[0, 0, 1] == 1 and o[1, 0, 1] == 4


def _record_logits(fn, store):
    def out(h):
        lg = fn(h)
        store.append(lg)
        return lg
    return out


def _min_gap(logits, batch, beam):
    """The least relative distance between neighbours among a step's beam
    + 1 best candidates, over every step of the JAX run's logits."""
    lg = [torch.from_numpy(np.array(x.numpy())) for x in logits]
    _, _, gaps = chip_smoke.replay_selection(torch, tdecode, lg, batch, beam, 1)
    return float(gaps.min())


def _check_decode(jres, tres, beam, time_major):
    jout, tout = jres[0], tres[0]
    ids = _np(tout.predicted_ids)
    np.testing.assert_array_equal(ids, _np(jout.predicted_ids))
    np.testing.assert_array_equal(_np(tout.parent_ids), _np(jout.parent_ids))
    _close(tout.scores, jout.scores)
    np.testing.assert_array_equal(_np(tres[2]), _np(jres[2]))
    steps = tout.parent_ids.shape[0]
    assert ids.shape == ((steps, 2, beam) if time_major else (2, steps, beam))


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("time_major", [False, True])
def test_dynamic_decode_over_a_cell(kind, time_major):
    hidden, beam = 8, 3
    cell_cls = {"gru": (jnn.GRUCell, tnn.GRUCell), "lstm": (jnn.LSTMCell, tnn.LSTMCell)}[kind]
    jc, tc = _pair(cell_cls[0](hidden, hidden), cell_cls[1](hidden, hidden, device="cpu"))
    je, te = _pair(jnn.Embedding(VOCAB, hidden), tnn.Embedding(VOCAB, hidden, device="cpu"),
                   seed=300)
    jp, tp = _pair(jnn.Linear(hidden, VOCAB), tnn.Linear(hidden, VOCAB, device="cpu"), seed=400)
    h0 = 0.3 * _x(2, hidden, seed=5)
    jinit = J(h0) if kind == "gru" else (J(h0), J(-h0))
    tinit = T(h0) if kind == "gru" else (T(h0), T(-h0))
    logits = []
    jdec = jnn.BeamSearchDecoder(jc, 0, 1, beam, embedding_fn=je,
                                 output_fn=_record_logits(jp, logits))
    tdec = tnn.BeamSearchDecoder(tc, 0, 1, beam, embedding_fn=te, output_fn=tp)
    kw = dict(max_step_num=9, output_time_major=time_major, return_length=True)
    jres = jnn.dynamic_decode(jdec, inits=jinit, **kw)
    with torch.inference_mode():
        tres = tnn.dynamic_decode(tdec, inits=tinit, **kw)
    assert _min_gap(logits, 2, beam) > 1e-5  # no near-tie in this data
    _check_decode(jres, tres, beam, time_major)
    # the final states, reordered by the last step's parents
    jst, tst = jres[1], tres[1]
    for a, b in zip(jst if kind == "lstm" else [jst], tst if kind == "lstm" else [tst]):
        _close(b, a)


class JaxTranslationCell:
    """The JAX twin of chip_smoke.TranslationCell."""

    def __init__(self, decoder, emb, pos, memory_mask=None):
        self.decoder, self.emb, self.pos, self.memory_mask = decoder, emb, pos, memory_mask
        self.scale = decoder.layers[0].self_attn.embed_dim ** 0.5

    def __call__(self, ids, states):
        t = states[0][0][0].shape[2]
        x = JF.embedding(paddle.reshape(ids, [-1, 1]), self.emb) * self.scale + \
            J(self.pos[t])
        mha = jnn.MultiHeadAttention
        caches = [(mha.Cache(*inc), mha.StaticCache(*st)) for inc, st in states]
        out, new = self.decoder(x, None, None, self.memory_mask, caches)
        return out[:, -1], tuple(((c.k, c.v), (s.k, s.v)) for c, s in new)


@pytest.mark.parametrize("padded", [False, True])
def test_dynamic_decode_translation_cell(padded):
    """chip_smoke.py's translation (TranslationCell, translate) against a
    JAX twin at d_model 16: ids and parents bitwise, scores and the final
    caches within 1e-5."""
    beam, steps = 3, TGT
    j, t = _transformer_pair(False)
    je, te = _pair(jnn.Embedding(VOCAB, D), tnn.Embedding(VOCAB, D, device="cpu"), seed=500)
    pos = chip_smoke.sinusoid_table(SRC + steps + 1, D)
    src = np.random.RandomState(7).randint(3, VOCAB, (2, SRC)).astype(np.int64)
    keep = None
    if padded:
        src[1, 4:] = chip_smoke.MT_PAD
        keep = (np.arange(SRC)[None, :] < np.array([SRC, 4])[:, None])[:, None, None, :]
    jmem = j.encoder(JF.embedding(J(src), je.weight) * (D ** 0.5) + J(pos[:SRC]), J(keep))
    jmask = None if keep is None else J(np.repeat(keep, beam, axis=0))
    logits = []
    jdec = jnn.BeamSearchDecoder(
        JaxTranslationCell(j.decoder, je.weight, pos, jmask), chip_smoke.MT_BOS,
        chip_smoke.MT_EOS, beam,
        output_fn=_record_logits(lambda h: paddle.matmul(h, je.weight, transpose_y=True),
                                 logits))
    inits = tuple(((c.k, c.v), (s.k, s.v)) for c, s in j.decoder.gen_cache(jmem))
    jres = jnn.dynamic_decode(jdec, inits=inits, max_step_num=steps, return_length=True)
    with torch.inference_mode():
        tres = chip_smoke.translate(tnn, t, te, torch.from_numpy(pos), T(src), T(keep),
                                    beam=beam, max_steps=steps)
    assert _min_gap(logits, 2, beam) > 1e-5  # no near-tie in this data
    _check_decode(jres, tres, beam, False)
    for (jinc, jst), (tinc, tst) in zip(jres[1], tres[1]):
        for a, b in zip(jinc + jst, tinc + tst):
            _close(b, a)
    assert tres[1][0][0][0].shape[2] == jres[0].parent_ids.shape[0]


def test_translation_checks_of_the_chip_run():
    """The helpers phase 12 checks the card with: the replayed selection
    gives dynamic_decode's beams and the raw tokens each step chose, and a
    step's cost counts its weights, caches, concat and reorder."""
    t = tnn.Transformer(D, HEADS, 2, 2, FFN, dropout=0.0, device="cpu").eval()
    emb = tnn.Embedding(VOCAB, D, device="cpu")
    pos = torch.from_numpy(chip_smoke.sinusoid_table(32, D))
    src = torch.from_numpy(np.random.RandomState(1).randint(3, VOCAB, (2, SRC)))
    fed, logits = [], []
    with torch.inference_mode():
        out, states, lens = chip_smoke.translate(
            tnn, t, emb, pos, src, beam=3, max_steps=8, on_step=fed.append,
            output_fn=_record_logits(lambda h: h @ emb.weight.T, logits))
    toks, parents, gaps = chip_smoke.replay_selection(torch, tdecode, logits, 2, 3, 1)
    assert torch.equal(parents, out.parent_ids)
    assert torch.equal(tnn.functional.gather_tree(toks, parents),
                       out.predicted_ids.transpose(0, 1))
    assert torch.equal(chip_smoke.raw_tokens(torch, fed, out.predicted_ids.transpose(0, 1)),
                       toks)
    assert gaps.shape == (toks.shape[0], 2) and bool((gaps >= 0).all())
    nbytes, ops = chip_smoke.mt_step_cost(64, 10, 64, 6, 512, 2048, 37000)
    w = 6 * (6 * 512 * 512 + 2 * 512 * 2048 + 13 * 512 + 2048) + 37000 * 512
    cache = 6 * 2 * 64 * 512 * 4
    assert nbytes == 4 * w + cache * 74 + cache * 19 + 2 * cache * 74 + 4 * 64 * (512 + 37000)
    assert ops == 2 * 64 * w + 4 * 64 * 6 * 512 * 74


def test_exports():
    for name in ("TransformerDecoderLayer", "TransformerDecoder", "Transformer",
                 "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN", "LSTM", "GRU",
                 "SimpleRNN", "BeamSearchDecoder", "dynamic_decode"):
        assert hasattr(tnn, name) and hasattr(jnn, name), name
    assert callable(tnn.functional.gather_tree)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(tnn.BeamSearchDecoder.tile_beam_merge_with_batch(x, 2),
                       torch.tensor(np.repeat(x.numpy(), 2, axis=0)))
    with pytest.raises(ValueError):
        tnn.dynamic_decode(tnn.BeamSearchDecoder(None, 0, 1, 2), inits=x)


def test_entry_points_default_to_the_card():
    """Without a card, the new layers' default device raises (the port
    never moves to the CPU on its own)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour is not observable")
    for fn in (lambda: tnn.Transformer(D, HEADS, 1, 1, FFN),
               lambda: tnn.TransformerDecoderLayer(D, HEADS, FFN),
               lambda: tnn.MultiHeadAttention(D, HEADS, kdim=8),
               lambda: tnn.LSTM(4, 8), lambda: tnn.GRUCell(4, 8),
               lambda: tnn.SimpleRNNCell(4, 8)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn()
