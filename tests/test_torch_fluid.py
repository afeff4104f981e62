"""paddle_tpu_torch.fluid, the 1.x namespace, against the JAX package's on
the CPU: the classic fluid training script (``fluid.layers.fc`` on
[None, 3], SGD 0.1, 25 ``exe.run``s) trains as the reference's does
(the losses within 1e-5 at every run, the weights carried across by
``static.save``/``static.load``), the ``fluid.layers`` aliases and
builders, ``fluid.dygraph``, ``fluid.core`` and ``fluid.io``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as tplace

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


@pytest.fixture(autouse=True)
def dygraph_after():
    yield
    jp.disable_static()
    tp.disable_static()


def classic(paddle):
    fluid = paddle.fluid
    paddle.enable_static()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [None, 3])
        y = fluid.layers.data("y", [None, 1])
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.reduce_mean(fluid.layers.square(pred - y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def train(paddle, main, startup, loss, steps=25):
    fluid = paddle.fluid
    exe = fluid.Executor(fluid.CPUPlace())
    assert exe.run(startup) == []
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 3).astype(np.float32)
    w = rng.rand(3, 1).astype(np.float32)
    hist = []
    for _ in range(steps):
        out, = exe.run(main, feed={"x": xs, "y": xs @ w}, fetch_list=[loss])
        hist.append(float(np.asarray(out).mean()))
    return np.asarray(hist)


def test_classic_fluid_training_matches_reference(tmp_path):
    jp.seed(0)
    jm, js, jl = classic(jp)
    jp.static.save(jm, str(tmp_path / "w"))
    tm, ts, tl = classic(tp)
    tp.static.load(tm, str(tmp_path / "w"))
    want = train(jp, jm, js, jl)
    got = train(tp, tm, ts, tl)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[-1] < got[0] / 10
    for a, b in zip(jm.all_parameters(), tm.all_parameters()):
        np.testing.assert_allclose(np.asarray(b.numpy()), np.asarray(a.numpy()), atol=1e-5)


def test_chip_smoke_starts_fluid_where_the_reference_starts():
    """chip_smoke.py phase 19 (a) starts the script from FLUID_W0, which
    must be the reference's seed-0 draw of the fc weight."""
    import chip_smoke

    jp.seed(0)
    jm, _, _ = classic(jp)
    w, b = (np.asarray(p.numpy()) for p in jm.all_parameters())
    np.testing.assert_array_equal(w.ravel(), np.asarray(chip_smoke.FLUID_W0, np.float32))
    np.testing.assert_array_equal(b, 0.0)


def test_layers_namespace_matches_reference():
    x = np.asarray([[1.0, -2.0, 3.0], [0.5, 4.0, -1.0]], np.float32)
    flags = np.asarray([True, False])
    for name, fn in (
            ("relu", lambda p, t: p.fluid.layers.relu(t)),
            ("reduce_sum", lambda p, t: p.fluid.layers.reduce_sum(t, dim=1)),
            ("reduce_mean", lambda p, t: p.fluid.layers.reduce_mean(t, dim=0, keep_dim=True)),
            ("reduce_max", lambda p, t: p.fluid.layers.reduce_max(t, dim=1)),
            ("reduce_min", lambda p, t: p.fluid.layers.reduce_min(t)),
            ("softmax", lambda p, t: p.fluid.layers.softmax(t)),
            ("fill_constant", lambda p, t: p.fluid.layers.fill_constant([2, 2], "float32", 3.0)),
    ):
        want = np.asarray(fn(jp, jp.to_tensor(x)).numpy())
        got = np.asarray(fn(tp, tp.to_tensor(x)).numpy())
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    for p in (jp, tp):
        f = p.to_tensor(flags)
        assert bool(p.fluid.layers.reduce_any(f).numpy())
        assert not bool(p.fluid.layers.reduce_all(f).numpy())


def test_layers_names_are_the_reference_names():
    skip = {"np"}
    want = {n for n in dir(jp.fluid.layers) if not n.startswith("_")} - skip
    got = {n for n in dir(tp.fluid.layers) if not n.startswith("_")}
    assert want <= got, sorted(want - got)


def test_pool2d_legacy_signature():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    for p in (jp, tp):
        t = p.to_tensor(x)
        mx = p.fluid.layers.pool2d(t, 2, "max", pool_stride=2)
        av = p.fluid.layers.pool2d(t, 2, pool_type="avg", pool_stride=2)
        np.testing.assert_allclose(np.asarray(mx.numpy())[0, 0], [[5, 7], [13, 15]])
        np.testing.assert_allclose(np.asarray(av.numpy())[0, 0], [[2.5, 4.5], [10.5, 12.5]])
        g = p.fluid.layers.pool2d(t, global_pooling=True, pool_type="avg")
        assert list(g.shape) == [1, 1, 1, 1]
        with pytest.raises(ValueError):
            p.fluid.layers.pool2d(t, 2, "median")


def test_embedding_builder():
    tp.seed(0)
    ids = tp.to_tensor(np.asarray([[0, 2], [1, 3]], np.int64))
    assert tp.fluid.layers.embedding(ids, size=[8, 4]).shape == [2, 2, 4]


def test_dygraph_guard_to_variable_and_no_grad():
    fluid = tp.fluid
    tp.enable_static()
    with fluid.dygraph.guard():
        assert tp.in_dynamic_mode()
        v = fluid.dygraph.to_variable(np.ones((2, 2), np.float32))
        assert isinstance(v, tp.Tensor)
        assert fluid.dygraph.Linear(2, 3)(v).shape == [2, 3]
    assert not tp.in_dynamic_mode()
    tp.disable_static()

    @fluid.dygraph.no_grad
    def f(x):
        return x * 2

    x = tp.to_tensor(np.ones(2, np.float32))
    x.stop_gradient = False
    assert f(x).stop_gradient
    # fluid.dygraph.DataParallel is the port's distributed DataParallel; in
    # one process its forward is the layer's and its gradients stay as they are
    assert fluid.dygraph.DataParallel is tp.DataParallel is tp.distributed.DataParallel
    inner = fluid.dygraph.Linear(2, 2)
    dp = fluid.dygraph.DataParallel(inner)
    y = tp.to_tensor(np.ones((3, 2), np.float32))
    out = dp(y)
    np.testing.assert_array_equal(out.numpy(), inner(y).numpy())
    out.sum().backward()
    before = inner.weight.grad.numpy().copy()
    dp.apply_collective_grads()
    np.testing.assert_array_equal(inner.weight.grad.numpy(), before)


def test_core_probes_and_io():
    fluid = tp.fluid
    assert fluid.core.is_compiled_with_cuda() == torch.cuda.is_available()
    assert fluid.core.get_cuda_device_count() == torch.cuda.device_count()
    assert fluid.CPUPlace is tp.CPUPlace
    assert fluid.io.save_inference_model is tp.static.save_inference_model
    assert fluid.io.load is tp.static.load
    assert fluid.Variable is tp.Tensor


def test_print_with_braces():
    out = tp.static.Print(tp.to_tensor(np.ones(2, np.float32)), message="step {0} {dict}")
    np.testing.assert_allclose(out.numpy(), 1.0)
