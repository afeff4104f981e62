"""The port's Tensor and autograd (paddle_tpu_torch: Tensor, backward,
grad, hooks, no_grad, stop_gradient, PyLayer, flags, places) against the
JAX package's: the cases of tests/test_core.py and tests/test_double_grad.py,
each run through both packages on the same numpy-seeded inputs.

Tolerances: gradients of float32 arithmetic 1e-6 relative (the same
formulas, rounded by XLA and by torch); double grad and PyLayer 1e-5 of
the largest magnitude; exact where the values are small integers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as tplace

BOTH = [pytest.param(jp, id="jax"), pytest.param(tp, id="port")]


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def both(fn, rtol=1e-6):
    """fn(P) -> list of numpy arrays (or None), run in both packages and
    compared: equal None-ness, shapes, dtypes, values within rtol of the
    largest magnitude."""
    got, want = fn(tp), fn(jp)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), f"value {i}: {g!r} vs {w!r}"
        if w is None:
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, f"value {i}: {g.dtype}{g.shape} " \
                                                          f"vs {w.dtype}{w.shape}"
        scale = max(float(np.max(np.abs(w))) if w.size else 0.0, 1e-30)
        assert np.max(np.abs(g.astype(np.float64) - w), initial=0.0) <= rtol * scale, \
            f"value {i}:\n{g}\n{w}"
    return got


def t(P, x, sg=False):
    return P.to_tensor(np.asarray(x, np.float32), stop_gradient=sg)


# ------------------------------------------------------------------ Tensor


def test_creation_and_dtypes():
    def run(P):
        a = P.to_tensor([[1.0, 2.0], [3.0, 4.0]])
        outs = [a.numpy(), np.asarray(a.shape), P.to_tensor([1, 2, 3]).numpy(),
                P.to_tensor(np.arange(3, dtype=np.int64)).numpy(),
                P.to_tensor([1, 2], dtype="int64").numpy(),
                P.to_tensor([1.0, 2.0], dtype="float64").numpy(),
                P.to_tensor(np.float64(2.5)).numpy(), P.to_tensor([True, False]).numpy(),
                a.astype("int32").numpy(), np.float32(P.to_tensor(3.5).item())]
        assert a.shape == [2, 2] and isinstance(a.shape, list) and a.size == 4
        assert a.stop_gradient and a.is_leaf and a.ndim == 2 and a.dim() == 2
        return outs

    both(run)


def test_numpy_of_bfloat16_is_its_exact_float32_upcast():
    """The port's choice (ROADMAP Queue 3): numpy() of a bfloat16 Tensor is
    float32, each value the reference's bfloat16 value exactly."""
    x = np.random.RandomState(0).standard_normal((3, 5)).astype(np.float32)
    got = tp.to_tensor(x).astype("bfloat16").numpy()
    want = jp.to_tensor(x).astype("bfloat16").numpy()
    assert got.dtype == np.float32 and want.dtype.name == "bfloat16"
    assert np.array_equal(got, want.astype(np.float32))


def test_operators_and_indexing():
    def run(P):
        a, b = P.to_tensor([1.0, 2.0]), P.to_tensor([3.0, 4.0])
        m = P.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
        outs = [(a + b).numpy(), (a - b).numpy(), (a * b).numpy(), (b / a).numpy(),
                (a ** 2).numpy(), (-a).numpy(), (2.0 - a).numpy(), (2.0 * a).numpy(),
                (a < b).all().numpy(), (a == a).numpy(), (b // a).numpy(), (b % a).numpy(),
                abs(-a).numpy(), (~(a > 1)).numpy(), (m @ m.t()).numpy(),
                m[1].numpy(), m[0:2, 1].numpy(), m[:, -1].numpy(), m[..., None].numpy(),
                m[P.to_tensor([0, 2])].numpy(), m[m > 5].numpy(), m[[0, 2], 1].numpy(),
                m.reshape([2, 6]).numpy(), m.sum(axis=0).numpy(), m.mean().numpy(),
                m.transpose([1, 0]).numpy(), m.max().numpy(), m.argmax(axis=1).numpy(),
                m.flatten().numpy()]
        m[0, 0] = 99.0
        m[1] = P.to_tensor([5.0, 6.0, 7.0, 8.0])
        m[2, 1:3] = 0
        outs.append(m.numpy())
        return outs

    both(run)


def test_clone_detach_set_value():
    def run(P):
        x = t(P, [1.0, 2.0])
        d = x.detach()
        c = x.clone()
        assert d.stop_gradient and not c.stop_gradient
        v = P.to_tensor([1.0, 2.0])
        v.set_value(np.array([5.0, 6.0], np.float32))
        (c * c).sum().backward()
        return [d.numpy(), c.numpy(), v.numpy(), x.grad.numpy()]

    both(run)


def test_setitem_reaches_both_the_graph_and_the_value():
    """x (a graph tensor) gets v written into a row; the gradient reaches
    x's inputs (but the overwritten row) and v."""
    def run(P):
        w = t(P, np.arange(6).reshape(2, 3))
        v = t(P, [10.0, 20.0, 30.0])
        x = w * 2
        x[1] = v
        (x * x).sum().backward()
        return [x.numpy(), w.grad.numpy(), v.grad.numpy()]

    both(run)


# ------------------------------------------------------------------ autograd


def test_simple_chain_and_fan_out():
    def run(P):
        x = t(P, [2.0, 3.0])
        (x * x).sum().backward()
        g1 = x.grad.numpy()
        y = t(P, [2.0])
        (y * y * y).backward()
        z = t(P, [1.0])
        w = z * 2
        (w + w).backward()
        return [g1, y.grad.numpy(), z.grad.numpy()]

    both(run)


def test_grad_accumulates_across_backwards():
    def run(P):
        x = t(P, [1.0])
        (x * 2).backward()
        (x * 3).backward()
        g = x.grad.numpy()
        x.clear_grad()
        assert x.grad is None
        return [g]

    both(run)


def test_no_grad_and_stop_gradient():
    def run(P):
        x = t(P, [1.0])
        with P.no_grad():
            y = x * 2
        z = (x * 2).detach() * 3
        u = x * 2
        u.stop_gradient = True
        r = (u * 3 + x).sum()
        r.backward()
        assert y.stop_gradient and z.stop_gradient and u.stop_gradient
        assert P.is_grad_enabled()
        with P.set_grad_enabled(False):
            q = x * 2
        assert q.stop_gradient
        i = P.to_tensor([1, 2])
        assert (i * 2).stop_gradient
        return [x.grad.numpy()]

    both(run)


def test_stop_gradient_propagates_only_when_every_input_has_it():
    def run(P):
        a, b = t(P, [1.0], sg=True), t(P, [2.0], sg=False)
        return [np.asarray((a + a).stop_gradient), np.asarray((a + b).stop_gradient),
                np.asarray(P.matmul(a[None], b[None]).stop_gradient)]

    both(run)


def test_matmul_and_cross_entropy_grads():
    rng = np.random.RandomState(0)
    a_np, b_np = rng.rand(3, 4).astype(np.float32), rng.rand(4, 2).astype(np.float32)

    def run(P):
        a, b = t(P, a_np), t(P, b_np)
        P.matmul(a, b).sum().backward()
        return [a.grad.numpy(), b.grad.numpy()]

    both(run)


def test_grad_api_leaves_dot_grad_alone():
    def run(P):
        x = t(P, [3.0])
        (gx,) = P.grad(x * x, x)
        assert x.grad is None
        return [gx.numpy()]

    both(run)


def test_register_hook():
    def run(P):
        x = t(P, [1.0])
        seen = []

        def hook(g):
            seen.append(g.numpy().copy())
            return g * 2

        h = x.register_hook(hook)
        (x * 3).backward()
        h.remove()
        (x * 3).backward()
        assert len(seen) == 1
        y = t(P, [2.0])
        mid = y * y
        mid.register_hook(lambda g: g * 10)
        mid.sum().backward()
        return [seen[0], x.grad.numpy(), y.grad.numpy()]

    both(run)


def test_multi_output_op_grad():
    def run(P):
        x = t(P, [3.0, 1.0, 2.0])
        vals, idx = P.topk(x, 2)
        vals.sum().backward()
        return [x.grad.numpy(), idx.numpy()]

    both(run)


def test_backward_of_a_non_scalar_needs_its_gradient():
    for P in (tp, jp):
        x = t(P, [1.0, 2.0])
        with pytest.raises(P.errors.InvalidArgumentError):
            (x * 2).backward()

    def run(P):
        x = t(P, [1.0, 2.0])
        (x * 2).backward(P.to_tensor([1.0, 3.0]))
        y = t(P, [1.0, 2.0])
        P.autograd.backward([y * y], [P.to_tensor([2.0, 1.0])])
        return [x.grad.numpy(), y.grad.numpy()]

    both(run)


# ------------------------------------------------------------------ double grad


def test_cubic_second_derivative():
    def run(P):
        x = t(P, [2.0, 3.0])
        (g1,) = P.grad(x * x * x, x, grad_outputs=t(P, np.ones(2), sg=True),
                       create_graph=True)
        (g2,) = P.grad((g1 * g1).sum(), x)
        return [g1.numpy(), g2.numpy()]

    both(run, rtol=1e-5)


def test_tanh_double_grad():
    xv = np.array([[0.3, -1.2], [2.0, 0.5]], np.float32)

    def run(P):
        x = t(P, xv)
        (g1,) = P.grad(P.tanh(x).sum(), x, create_graph=True)
        (g2,) = P.grad((g1 ** 2).sum(), x)
        return [g1.numpy(), g2.numpy()]

    both(run, rtol=1e-5)


def test_backward_through_created_graph():
    def run(P):
        w = t(P, [[1.0, 2.0], [3.0, 4.0]])
        xi = t(P, [[0.5, 1.5]])
        (gx,) = P.grad(P.matmul(xi, w).sum(), xi, create_graph=True)
        (((gx * gx).sum() - 1.0) ** 2).backward()
        return [gx.numpy(), w.grad.numpy()]

    both(run, rtol=1e-5)


def test_unused_input_raises_unless_allowed():
    def run(P):
        x, z = t(P, [1.0]), t(P, [2.0])
        y = (x * x).sum()
        with pytest.raises(P.errors.InvalidArgumentError):
            P.grad(y, [z], create_graph=True, retain_graph=True)
        g = P.grad(y, [z, x], create_graph=True, allow_unused=True)
        assert g[0] is None
        return [g[1].numpy()]

    both(run)


def test_gradient_penalty_training():
    """WGAN-GP-style steps: minimise (||df/dx|| - 1)^2 over a small net's
    parameters, with the JAX net's weights carried across."""
    rng = np.random.RandomState(0)
    xv = rng.rand(8, 4).astype(np.float32)
    w1, b1 = rng.randn(4, 16).astype(np.float32) * 0.5, np.zeros(16, np.float32)
    w2, b2 = rng.randn(16, 1).astype(np.float32) * 0.5, np.zeros(1, np.float32)

    def run(P):
        params = [P.create_parameter(list(a.shape), "float32") for a in (w1, b1, w2, b2)]
        for p, a in zip(params, (w1, b1, w2, b2)):
            p.set_value(a)
        opt = P.optimizer.Adam(0.02, parameters=params)
        losses = []
        for _ in range(5):
            x = P.to_tensor(xv, stop_gradient=False)
            h = P.tanh(P.add(P.matmul(x, params[0]), params[1]))
            out = P.add(P.matmul(h, params[2]), params[3]).sum()
            (gx,) = P.grad(out, x, create_graph=True)
            gp = (((gx * gx).sum(axis=-1) ** 0.5 - 1.0) ** 2).mean()
            opt.clear_grad()
            gp.backward()
            opt.step()
            losses.append(float(gp.numpy()))
        return [np.asarray(losses, np.float32)]

    both(run, rtol=1e-5)


# ------------------------------------------------------------------ PyLayer


def _cube(P):
    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k=3.0):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * (k / 3.0)

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * ctx.k * x * x

    return Cube


def test_pylayer_forward_backward():
    def run(P):
        x = t(P, [2.0, -1.0])
        y = _cube(P).apply(x)
        y.sum().backward()
        z = _cube(P).apply(t(P, [2.0], sg=True))
        assert z.stop_gradient
        return [y.numpy(), x.grad.numpy()]

    both(run)


def test_pylayer_double_grad():
    def run(P):
        class Square(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor()
                return 2.0 * x * dy

        x = t(P, [3.0, -1.5])
        (g1,) = P.grad(Square.apply(x).sum(), x, create_graph=True)
        (g2,) = P.grad((g1 * g1).sum(), x)
        return [g1.numpy(), g2.numpy()]

    both(run, rtol=1e-5)


def test_pylayer_context_surface():
    ctx_cls = tp.autograd.PyLayerContext
    for name in ("save_for_backward", "saved_tensor", "mark_non_differentiable",
                 "set_materialize_grads", "mark_not_inplace"):
        assert callable(getattr(ctx_cls, name))


# ------------------------------------------------------------------ flags, places


def test_flags_and_nan_check():
    for P in (tp, jp):
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            assert P.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
            x = P.to_tensor([1.0, 0.0])
            with pytest.raises(P.errors.PreconditionNotMetError):
                P.log(x * 0 - 1)
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False})
    assert tp.get_flags(["default_dtype", "seed"]) == jp.get_flags(["default_dtype", "seed"])


def test_places_and_default_dtype():
    tp.set_device("cpu")
    assert tp.get_device() == "cpu"
    assert tp.get_default_dtype() == jp.get_default_dtype() == "float32"
    assert str(tp.to_tensor([1.5]).dtype) == "torch.float32"
    assert tp.CPUPlace() == tp.CPUPlace() and tp.CUDAPlace(0) != tp.CPUPlace()
    assert tp.to_tensor([1.0], place=tp.CPUPlace()).place == tp.CPUPlace()


def test_seed_reproducible():
    def run(P):
        P.seed(42)
        a = P.randn([4]).numpy()
        P.seed(42)
        b = P.randn([4]).numpy()
        assert np.array_equal(a, b)
        P.seed(42)
        return [P.randint(0, 100, [6]).numpy()]

    both(run)


def test_tensor_is_a_torch_tensor_and_parameter_a_torch_parameter():
    x = tp.to_tensor([1.0])
    assert isinstance(x, torch.Tensor) and type(torch.add(x, x)) is torch.Tensor
    p = tp.create_parameter([2], "float32")
    assert isinstance(p, torch.nn.Parameter) and not p.stop_gradient and p.trainable
    p.stop_gradient = True
    assert not p.requires_grad
