"""paddle_tpu_torch.static (Program, Executor, the static minimize,
static.nn, the compat surface) against the JAX package on the CPU, at a
tiny size. The same program is built in both packages, the reference's
weights are copied into the port's by position (``convert.set_by_position``:
both record their parameters in first-use order), and numpy feeds made
from a seed go through both Executors.

- Training: a 2-layer BERT at [4, 16] (dropout 0, AdamW with the
  global-norm clip) and a conv2d/batch_norm/fc CNN (Momentum): the losses
  within 1e-5 of the reference's at every run; the final parameters
  within 1e-5 for the CNN, and within 2.5 x lr x runs for BERT, whose
  key-projection bias has a gradient that is rounding noise (softmax does
  not see it), which Adam scales to a step of about lr in either sign.
  The fc regression is tests/test_torch_fluid.py's.
- The reference's four caveats, pinned in both packages: a None dim baked
  as 1, the dropout mask recorded as a constant (and bitwise the
  reference's), ``cond`` picking its branch at build time, ``auto_cast``
  in a program fetching float32.
- Every ``static.nn`` builder against the reference's (one case each),
  the control flow eager, in a program and under ``to_static``.
- Files: ``static.save`` <-> ``static.load`` across the packages bitwise,
  ``save_inference_model`` -> ``jit.load`` / ``create_predictor`` and the
  serialize family against ``Executor.run`` of the test clone.
- The rest of compat: py_func, Print, accuracy, auc, create_global_var,
  CompiledProgram/ParallelExecutor, the names that raise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import place as tplace

torch.set_num_threads(1)

B, S, V, H = 4, 16, 64, 32
BERT = dict(vocab_size=V, hidden_size=H, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


@pytest.fixture(autouse=True)
def dygraph_after():
    """No static-mode flag leaks out of a test."""
    yield
    jp.disable_static()
    tp.disable_static()


def build(paddle, fn):
    """``fn(paddle)`` recorded into a fresh program under static mode ->
    (program, whatever ``fn`` returned)."""
    paddle.enable_static()
    main, startup = paddle.static.Program(), paddle.static.Program()
    with paddle.static.program_guard(main, startup):
        out = fn(paddle)
    paddle.disable_static()
    return main, out


def copy_weights(jmain, tmain):
    convert.set_by_position(tmain, [np.asarray(p.numpy()) for p in jmain.all_parameters()])


def both(fn, seed=0):
    jp.seed(seed)
    jm, jo = build(jp, fn)
    tm, to = build(tp, fn)
    copy_weights(jm, tm)
    return (jm, jo), (tm, to)


def run(paddle, program, feed, fetch):
    return [np.asarray(a) for a in paddle.static.Executor().run(program, feed=feed,
                                                                   fetch_list=fetch)]


# ------------------------------------------------------------------ training


def bert_classifier(paddle):
    static = paddle.static
    ids = static.data("ids", [B, S], "int64")
    lab = static.data("label", [B], "int64")
    seq, pooled = paddle.text.models.BertModel(**BERT)(ids)
    logits = paddle.nn.Linear(H, 2)(pooled)
    loss = paddle.nn.functional.cross_entropy(logits, lab)
    paddle.optimizer.AdamW(learning_rate=1e-3,
                           grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)).minimize(loss)
    return loss, logits


def cnn_classifier(paddle):
    static = paddle.static
    x = static.data("x", [4, 3, 8, 8])
    lab = static.data("label", [4, 1], "int64")
    h = paddle.nn.functional.relu(static.nn.batch_norm(static.nn.conv2d(x, 8, 3, padding=1)))
    logits = static.nn.fc(h, 10)
    loss = paddle.mean(paddle.nn.functional.cross_entropy(logits, lab))
    paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return (loss,)


def train_both(model, feeds):
    (jm, jo), (tm, to) = both(model)
    hist = [[], []]
    for feed in feeds:
        for paddle, prog, outs, h in ((jp, jm, jo, hist[0]), (tp, tm, to, hist[1])):
            h.append(float(run(paddle, prog, feed, [outs[0]])[0]))
    params = [(np.asarray(a.numpy()), np.asarray(b.numpy()))
              for a, b in zip(jm.all_parameters(), tm.all_parameters())]
    return np.asarray(hist), params, tm


def test_bert_program_trains_as_the_reference():
    rng = np.random.RandomState(0)
    feeds = [{"ids": rng.randint(0, V, (B, S)).astype(np.int64),
              "label": rng.randint(0, 2, (B,)).astype(np.int64)} for _ in range(4)]
    hist, params, tm = train_both(bert_classifier, feeds)
    np.testing.assert_allclose(hist[1], hist[0], atol=1e-5)
    assert len(params) == 41 and len(tm.all_parameters()) == 41
    for a, b in params:
        np.testing.assert_allclose(b, a, atol=2.5 * 1e-3 * len(feeds))
    # the flash attention custom op is recorded as one call per layer
    names = [getattr(op.fn, "__name__", "") for op in tm.ops]
    assert names.count("flash_attention_fwd.default") == 2


def test_cnn_program_trains_as_the_reference():
    rng = np.random.RandomState(1)
    feeds = [{"x": rng.randn(4, 3, 8, 8).astype(np.float32),
              "label": rng.randint(0, 10, (4, 1)).astype(np.int64)} for _ in range(5)]
    hist, params, _ = train_both(cnn_classifier, feeds)
    np.testing.assert_allclose(hist[1], hist[0], atol=1e-5)
    assert hist[1][-1] < hist[1][0]
    for a, b in params:
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_clone_for_test_does_not_train():
    (_, _), (tm, (loss, logits)) = both(bert_classifier)
    test = tm.clone(for_test=True)
    assert test.train_attach is None and tm.train_attach is not None
    rng = np.random.RandomState(2)
    feed = {"ids": rng.randint(0, V, (B, S)).astype(np.int64)}
    a, = run(tp, test, feed, [logits])
    b, = run(tp, test, feed, [logits])
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ caveats


def test_none_dim_is_baked_as_one_in_both():
    def fn(paddle):
        ids = paddle.static.data("ids", [None, S], "int64")
        return paddle.text.models.BertModel(**BERT)(ids)

    feed = {"ids": np.zeros((4, S), np.int64)}
    for paddle in (jp, tp):
        jp.seed(0)
        prog, (seq, _) = build(paddle, fn)
        assert list(prog.placeholders["ids"].shape) == [1, S]
        with pytest.raises(Exception, match="reshape|shape"):
            run(paddle, prog, feed, [seq])


def test_dropout_mask_is_a_constant_of_the_program():
    def fn(paddle):
        x = paddle.static.data("x", [4, 8])
        return paddle.nn.functional.dropout(x, 0.5)

    one = {"x": np.ones((4, 8), np.float32)}
    outs = []
    for paddle in (jp, tp):
        paddle.seed(0)
        prog, d = build(paddle, fn)
        a, = run(paddle, prog, one, [d])
        b, = run(paddle, prog, one, [d])
        np.testing.assert_array_equal(a, b)
        outs.append(a)
    np.testing.assert_array_equal(outs[1], outs[0])  # the same key, the same mask


def test_cond_takes_its_branch_at_build_time():
    def fn(paddle):
        x = paddle.static.data("x", [2, 3])
        return paddle.static.nn.cond(paddle.sum(x) > 0, lambda: x * 2, lambda: x - 10)

    for paddle in (jp, tp):
        prog, c = build(paddle, fn)
        pos, = run(paddle, prog, {"x": np.ones((2, 3), np.float32)}, [c])
        neg, = run(paddle, prog, {"x": -np.ones((2, 3), np.float32)}, [c])
        np.testing.assert_array_equal(pos, -9.0)
        np.testing.assert_array_equal(neg, -11.0)


def test_auto_cast_in_a_program_fetches_float32():
    def fn(paddle):
        x = paddle.static.data("x", [2, 8])
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            return paddle.nn.Linear(8, 3)(x)

    for paddle in (jp, tp):
        prog, y = build(paddle, fn)
        out, = run(paddle, prog, {"x": np.ones((2, 8), np.float32)}, [y])
        assert out.dtype == np.float32


# ------------------------------------------------------------------ static.nn


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _data(paddle, name, arr):
    return paddle.static.data(name, list(arr.shape), str(arr.dtype))


TRANS = np.random.RandomState(7).randn(5, 3).astype(np.float32)

BUILDERS = {
    "fc": ({"x": _x([4, 6])}, lambda p, d: p.static.nn.fc(d["x"], 5, activation="relu")),
    "conv2d": ({"x": _x([2, 3, 8, 8])},
               lambda p, d: p.static.nn.conv2d(d["x"], 4, 3, padding=1)),
    "batch_norm": ({"x": _x([4, 3, 5, 5])}, lambda p, d: p.static.nn.batch_norm(d["x"])),
    "embedding": ({"ids": np.random.RandomState(1).randint(0, 32, (4, 6)).astype(np.int64)},
                  lambda p, d: p.static.nn.embedding(d["ids"], size=[32, 8])),
    "sparse_embedding": (
        {"ids": np.random.RandomState(2).randint(0, 32, (4, 6)).astype(np.int64)},
        lambda p, d: p.static.nn.sparse_embedding(d["ids"], size=[32, 8])),
    "conv2d_transpose": ({"x": _x([2, 3, 4, 4])},
                         lambda p, d: p.static.nn.conv2d_transpose(d["x"], 2, 2, stride=2)),
    "conv3d": ({"x": _x([1, 2, 4, 4, 4])},
               lambda p, d: p.static.nn.conv3d(d["x"], 3, 3, padding=1)),
    "conv3d_transpose": ({"x": _x([1, 2, 3, 3, 3])},
                         lambda p, d: p.static.nn.conv3d_transpose(d["x"], 2, 2, stride=2)),
    "layer_norm": ({"x": _x([4, 6, 8])},
                   lambda p, d: p.static.nn.layer_norm(d["x"], begin_norm_axis=2)),
    "group_norm": ({"x": _x([2, 4, 3, 3])}, lambda p, d: p.static.nn.group_norm(d["x"], 2)),
    "instance_norm": ({"x": _x([2, 3, 4, 4])}, lambda p, d: p.static.nn.instance_norm(d["x"])),
    "prelu_all": ({"x": _x([2, 3, 4, 4])}, lambda p, d: p.static.nn.prelu(d["x"], "all")),
    "prelu_channel": ({"x": _x([2, 3, 4, 4])},
                      lambda p, d: p.static.nn.prelu(d["x"], "channel")),
    "prelu_element": ({"x": _x([2, 3, 4, 4])},
                      lambda p, d: p.static.nn.prelu(d["x"], "element")),
    "bilinear_tensor_product": (
        {"x": _x([3, 4]), "y": _x([3, 5], 1)},
        lambda p, d: p.static.nn.bilinear_tensor_product(d["x"], d["y"], size=2)),
    "data_norm": ({"x": _x([3, 4])}, lambda p, d: p.static.nn.data_norm(d["x"])),
    "row_conv": ({"x": _x([2, 6, 4])},
                 lambda p, d: p.static.nn.row_conv(d["x"], future_context_size=2)),
    "crf_decoding": ({"x": _x([2, 5, 3])},
                     lambda p, d: p.static.nn.crf_decoding(d["x"], p.to_tensor(TRANS))),
    "nce": ({"x": _x([4, 8]),
             "label": np.random.RandomState(3).randint(0, 20, (4, 1)).astype(np.int64)},
            lambda p, d: p.static.nn.nce(d["x"], d["label"], 20, num_neg_samples=5, seed=1)),
    "spectral_norm": (
        {"x": _x([4, 6])},
        lambda p, d: p.static.nn.spectral_norm(p.static.nn.fc(d["x"], 6), power_iters=3)),
}


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_static_nn_builder_matches_reference(case):
    feed, fn = BUILDERS[case]

    def make(paddle):
        return fn(paddle, {k: _data(paddle, k, v) for k, v in feed.items()})

    (jm, jy), (tm, ty) = both(make)
    want, = run(jp, jm, feed, [jy])
    got, = run(tp, tm, feed, [ty])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paddle", [jp, tp], ids=["reference", "port"])
def test_builders_that_raise(paddle):
    with pytest.raises(NotImplementedError, match="prior_box"):
        paddle.static.nn.multi_box_head()
    x = paddle.to_tensor(np.zeros((1, 3, 4, 4), np.float32))
    with pytest.raises(NotImplementedError):
        paddle.static.nn.conv2d_transpose(x, 2, 2, data_format="NHWC")


def test_crf_decoding_reads_the_run_shapes():
    """[-1, -1, N] placeholders: the decode is one recorded call, so it
    reads the fed shape (reference: test_static_compat.py)."""
    trans = np.zeros((2, 2), np.float32)
    trans[0, 1] = trans[1, 0] = 3.0
    trans[0, 0] = trans[1, 1] = -3.0

    def fn(paddle):
        pot = paddle.static.data("pot", [-1, -1, 2])
        return paddle.static.nn.crf_decoding(pot, paddle.to_tensor(trans))

    unary = np.zeros((2, 5, 2), np.float32)
    unary[:, 0, 0] = 5.0
    for paddle in (jp, tp):
        prog, path = build(paddle, fn)
        out, = run(paddle, prog, {"pot": unary}, [path])
        np.testing.assert_array_equal(out[0], [0, 1, 0, 1, 0])


# ------------------------------------------------------------------ control flow


def _cf_cases(paddle):
    def cond_fn(x):
        return paddle.static.nn.cond(paddle.sum(x) > 0, lambda: x * 2.0, lambda: x - 1.0)

    def while_fn(x):
        i = paddle.zeros([1], "int32")
        _, out = paddle.static.nn.while_loop(lambda i, v: i < 3, lambda i, v: [i + 1, v * 2.0],
                                             [i, x])
        return out

    def case_fn(x):
        s = paddle.sum(x)
        return paddle.static.nn.case([(s > 10.0, lambda: x + 1.0), (s > 0.0, lambda: x + 2.0)],
                                     default=lambda: x + 3.0)

    def switch_fn(x):
        idx = paddle.cast(paddle.sum(x) > 0, "int32")
        return paddle.static.nn.switch_case(idx, {0: lambda: x - 5.0, 1: lambda: x + 5.0})

    return {"cond": cond_fn, "while_loop": while_fn, "case": case_fn, "switch_case": switch_fn}


@pytest.mark.parametrize("mode", ["eager", "to_static"])
@pytest.mark.parametrize("name", ["cond", "while_loop", "case", "switch_case"])
def test_control_flow_matches_reference(name, mode):
    for sign in (1.0, -1.0):
        x = sign * np.abs(_x([2, 3], 4))
        outs = []
        for paddle in (jp, tp):
            fn = _cf_cases(paddle)[name]
            if mode == "to_static":
                fn = paddle.jit.to_static(fn)
            outs.append(np.asarray(fn(paddle.to_tensor(x)).numpy()))
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)


# ------------------------------------------------------------------ files


def linreg(paddle):
    x = paddle.static.data("x", [None, 3])
    y = paddle.static.data("y", [None, 1])
    pred = paddle.static.nn.fc(x, 1)
    loss = paddle.mean((pred - y) ** 2)
    paddle.optimizer.SGD(0.1).minimize(loss)
    return loss, pred


def test_pdparams_pass_between_the_packages_bitwise(tmp_path):
    (jm, _), (tm, _) = both(linreg)
    for p in tm.all_parameters():  # the port's own values, then the reference's file
        p.set_value(np.zeros(p.shape, np.float32))
    jp.static.save(jm, str(tmp_path / "ref"))
    tp.static.load(tm, str(tmp_path / "ref"))
    for a, b in zip(jm.all_parameters(), tm.all_parameters()):
        np.testing.assert_array_equal(np.asarray(b.numpy()), np.asarray(a.numpy()))
    rng = np.random.RandomState(5)
    for p in tm.all_parameters():
        p.set_value(rng.randn(*p.shape).astype(np.float32))
    tp.static.save(tm, str(tmp_path / "port"))
    jp.static.load(jm, str(tmp_path / "port"))
    for a, b in zip(jm.all_parameters(), tm.all_parameters()):
        np.testing.assert_array_equal(np.asarray(a.numpy()), np.asarray(b.numpy()))
    assert sorted(tp.static.load_program_state(str(tmp_path / "port"))) == ["param_0",
                                                                            "param_1"]
    with pytest.raises(ValueError):
        tp.static.set_program_state(tm, {"nonexistent": np.zeros(2)})


def test_save_vars_round_trip(tmp_path):
    (_, _), (tm, _) = both(linreg)
    before = [np.asarray(p.numpy()) for p in tm.all_parameters()]
    tp.static.save_vars(dirname=str(tmp_path), main_program=tm)
    for p in tm.all_parameters():
        p.set_value(np.zeros(p.shape, np.float32))
    tp.static.load_vars(dirname=str(tmp_path), main_program=tm)
    for p, want in zip(tm.all_parameters(), before):
        np.testing.assert_array_equal(np.asarray(p.numpy()), want)


def test_inference_model_serves_as_the_test_clone(tmp_path):
    (_, _), (tm, (loss, logits)) = both(bert_classifier)
    rng = np.random.RandomState(6)
    ids = rng.randint(0, V, (B, S)).astype(np.int64)
    run(tp, tm, {"ids": ids, "label": np.zeros(B, np.int64)}, [loss])  # one step
    test = tm.clone(for_test=True)
    want, = run(tp, test, {"ids": ids}, [logits])
    prefix = str(tmp_path / "bert")
    exe = tp.static.Executor()
    tp.static.save_inference_model(prefix, [test.placeholders["ids"]], [logits], exe,
                                   program=test)
    layer, feed_names, fetch = tp.static.load_inference_model(prefix, exe)
    assert feed_names == ["x0"] and fetch == []
    np.testing.assert_array_equal(np.asarray(layer(tp.to_tensor(ids)).numpy()), want)
    cfg = tp.inference.Config(prefix)
    cfg.disable_gpu()
    pred = tp.inference.create_predictor(cfg)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(ids.astype(np.int32))
    pred.run()
    np.testing.assert_array_equal(
        pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu(), want)
    # the serialize family: program bytes and weight bytes apart
    feeds, fetches = [test.placeholders["ids"]], [logits]
    prog = tp.static.deserialize_program(tp.static.serialize_program(feeds, fetches,
                                                                     program=test))
    with pytest.raises(RuntimeError):
        prog(tp.to_tensor(ids))
    blob = tp.static.serialize_persistables(feeds, fetches, program=test)
    path = str(tmp_path / "w.bin")
    tp.static.save_to_file(path, blob)
    tp.static.deserialize_persistables(prog, tp.static.load_from_file(path))
    np.testing.assert_array_equal(np.asarray(prog(tp.to_tensor(ids)).numpy()), want)


# ------------------------------------------------------------------ compat


def test_py_func_matches_reference():
    x = _x([2, 3], 8)
    for paddle in (jp, tp):
        def doubler(t):
            return paddle.to_tensor(t.numpy() * 2.0)

        xt = paddle.to_tensor(x, stop_gradient=False)
        res = paddle.static.py_func(doubler, xt, paddle.to_tensor(np.zeros((2, 3), np.float32)),
                                    backward_func=lambda xin, out, dout:
                                    paddle.to_tensor(dout.numpy() * 3.0))
        np.testing.assert_allclose(res.numpy(), 2 * x)
        res.sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), 3.0)

    def fn(paddle):
        xv = paddle.static.data("x", [2, 3])
        out = paddle.to_tensor(np.zeros((2, 3), np.float32))
        return paddle.static.py_func(lambda t: paddle.to_tensor(t.numpy() + 1.0), xv, out)

    # the port records the call, and the host function runs at every run;
    # the reference cannot fetch its result from a program (the template
    # it returns is no recorded value)
    prog, y = build(tp, fn)
    out, = run(tp, prog, {"x": x}, [y])
    np.testing.assert_allclose(out, x + 1.0)
    out, = run(tp, prog, {"x": 2 * x}, [y])
    np.testing.assert_allclose(out, 2 * x + 1.0)
    prog, y = build(jp, fn)
    with pytest.raises(KeyError):
        run(jp, prog, {"x": x}, [y])


def test_print_passes_through_and_prints_at_each_run(capfd):
    x = np.asarray([1.0, 2.0], np.float32)
    np.testing.assert_allclose(tp.static.Print(tp.to_tensor(x), message="dbg").numpy(), x)

    def fn(paddle):
        return paddle.static.Print(paddle.static.data("x", [2]) * 3.0, message="in-program")

    prog, y = build(tp, fn)
    capfd.readouterr()
    out, = run(tp, prog, {"x": x}, [y])
    np.testing.assert_allclose(out, 3 * x)
    assert "in-program" in capfd.readouterr().out


def test_accuracy_and_auc_match_reference():
    rng = np.random.RandomState(9)
    logits = rng.randn(16, 5).astype(np.float32)
    label = rng.randint(0, 5, (16, 1)).astype(np.int64)
    probs = rng.rand(16, 2).astype(np.float32)
    probs[3] = probs[4]  # a tie
    bin_label = rng.randint(0, 2, (16, 1)).astype(np.int64)
    for k in (1, 3):
        want = jp.static.accuracy(jp.to_tensor(logits), jp.to_tensor(label), k=k).numpy()
        got = tp.static.accuracy(tp.to_tensor(logits), tp.to_tensor(label), k=k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    want = jp.static.auc(jp.to_tensor(probs), jp.to_tensor(bin_label)).numpy()
    got = tp.static.auc(tp.to_tensor(probs), tp.to_tensor(bin_label)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_create_global_var():
    tp.enable_static()
    v = tp.static.create_global_var([2, 3], 1.5, "float32", name="gv")
    assert v.persistable and list(v.shape) == [2, 3]
    np.testing.assert_allclose(v.numpy(), 1.5)
    assert tp.static.global_scope().find_var("gv") is v


def test_compiled_program_and_parallel_executor():
    (_, _), (tm, (loss, _)) = both(linreg)
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 3).astype(np.float32)
    feed = {"x": xs, "y": xs @ rng.rand(3, 1).astype(np.float32)}
    compiled = tp.static.CompiledProgram(
        tm, build_strategy=tp.static.BuildStrategy()).with_data_parallel(loss_name="loss")
    exe = tp.static.Executor()
    hist = [float(exe.run(compiled, feed=feed, fetch_list=[loss])[0]) for _ in range(20)]
    assert hist[-1] < hist[0] / 10
    loss.name = "my_loss"
    pe = tp.static.ParallelExecutor(loss_name="my_loss", main_program=tm)
    out, = pe.run(fetch_list=["my_loss"], feed=feed)
    assert np.isfinite(out).all()
    with pytest.raises(KeyError):
        tm.var("nonexistent_var")
    with pytest.warns(UserWarning):
        tp.static.BuildStrategy().reduce_strategy = 1


def test_unported_names_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tp.static.Executor().train_from_dataset()
    with pytest.raises(RuntimeError):
        tp.static.xpu_places()
