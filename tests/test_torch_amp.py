"""The port's paddle.amp (paddle_tpu_torch/amp) against the JAX package's:
the loss scaler's state machine (GradScaler/AmpScaler), the op lists,
``amp_guard`` and ``decorate``.

The scaler runs in both packages over one seeded sequence of gradients,
some holding an inf or a NaN, with weights and gradients made by numpy:
after every step the scale, the good/bad counters, the found-inf flag
and ``state_dict`` are equal and the unscaled gradients bitwise equal; a
skipped step leaves the parameters bitwise as they were, and an SGD step
moves them within 1e-6 relative of the reference's (XLA may fuse p - lr * g
into one rounding where torch rounds twice).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import amp as jamp
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.core import place as tplace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = saved


def _sequence(n, seed=0):
    """n steps of gradients for a [3, 2] weight and a [2] bias: mostly
    finite, an inf at steps 2 and 3, a NaN at step 6."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = [rng.randn(3, 2).astype(np.float32), rng.randn(2).astype(np.float32)]
        if i in (2, 3):
            g[0][1, 0] = np.inf
        if i == 6:
            g[1][1] = np.nan
        out.append(g)
    return out


def _pair(**scaler_kw):
    rng = np.random.RandomState(1)
    w0 = [rng.randn(3, 2).astype(np.float32), rng.randn(2).astype(np.float32)]
    jparams = [jp.create_parameter([3, 2], "float32"), jp.create_parameter([2], "float32")]
    for p, v in zip(jparams, w0):
        p._value = jnp.asarray(v)
    tparams = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in w0]
    jopt = jp.optimizer.SGD(0.1, parameters=jparams)
    topt = tp.optimizer.SGD(0.1, parameters=tparams)
    return ((jparams, jopt, jamp.GradScaler(**scaler_kw)),
            (tparams, topt, tamp.GradScaler(**scaler_kw)))


@pytest.mark.parametrize("scaler_kw", [
    dict(),
    dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2),
    dict(init_loss_scaling=4.0, decr_every_n_nan_or_inf=2, incr_ratio=3.0, decr_ratio=0.25,
         incr_every_n_steps=3),
    dict(use_dynamic_loss_scaling=False),
    dict(enable=False),
], ids=["defaults", "incr2", "decr2", "static", "disabled"])
def test_scaler_state_machine_matches_the_reference(scaler_kw):
    (jparams, jopt, js), (tparams, topt, ts) = _pair(**scaler_kw)
    assert ts.get_loss_scaling().numpy().tolist() == js.get_loss_scaling().numpy().tolist()
    for i, grads in enumerate(_sequence(10)):
        scale = js._scale
        assert ts._scale == scale
        for jpar, tpar, g in zip(jparams, tparams, grads):
            # the gradient of a scaled loss: g times the scale, in float32
            jpar._grad = jnp.asarray(g) * scale
            tpar.grad = torch.from_numpy(g) * scale
        before = [p.detach().clone() for p in tparams]
        js.unscale_(jopt)
        ts.unscale_(topt)
        assert ts._found_inf == js._found_inf, i
        skipped = ts._found_inf
        for jpar, tpar in zip(jparams, tparams):
            np.testing.assert_array_equal(tpar.grad.numpy(), np.asarray(jpar._grad), err_msg=i)
        # step() unscales again (the reference's step calls unscale_): hand
        # both the scaled gradients back
        for jpar, tpar, g in zip(jparams, tparams, grads):
            jpar._grad = jnp.asarray(g) * scale
            tpar.grad = torch.from_numpy(g) * scale
        js.step(jopt)
        ts.step(topt)
        assert ts.state_dict() == js.state_dict(), i
        assert ts._found_inf == js._found_inf
        for jpar, tpar, b in zip(jparams, tparams, before):
            if skipped and ts.is_enable():
                assert torch.equal(tpar.detach(), b), i
            np.testing.assert_allclose(tpar.detach().numpy(), np.asarray(jpar._value), rtol=1e-6,
                                       atol=0, err_msg=i)
        jopt.clear_grad()
        topt.clear_grad()
    np.testing.assert_array_equal(ts.get_loss_scaling().numpy(), js.get_loss_scaling().numpy())


def test_skipped_steps_leave_the_parameters_and_lower_the_scale():
    (_, _, _), (tparams, topt, ts) = _pair(init_loss_scaling=2.0 ** 15)
    before = [p.detach().clone() for p in tparams]
    tparams[0].grad = torch.full((3, 2), float("inf"))
    tparams[1].grad = torch.ones(2)
    ts.step(topt)
    assert all(torch.equal(p.detach(), b) for p, b in zip(tparams, before))
    assert ts._scale == 2.0 ** 14 and ts.state_dict()["bad_steps"] == 0
    # a parameter without a gradient is skipped, not counted as finite or not
    tparams[0].grad = None
    tparams[1].grad = torch.ones(2) * ts._scale
    ts.step(topt)
    assert not torch.equal(tparams[1].detach(), before[1])
    assert torch.equal(tparams[0].detach(), before[0])
    assert ts.state_dict() == {"scale": 2.0 ** 14, "good_steps": 1, "bad_steps": 0}


def test_state_dict_round_trip_and_minimize():
    (jparams, jopt, js), (tparams, topt, ts) = _pair(init_loss_scaling=8.0)
    ts.load_state_dict({"scale": 64.0, "good_steps": 3, "bad_steps": 0})
    js.load_state_dict({"scale": 64.0, "good_steps": 3, "bad_steps": 0})
    assert ts.state_dict() == js.state_dict()
    ts.set_init_loss_scaling(32.0)
    js.set_init_loss_scaling(32.0)
    assert ts.is_enable() and ts.is_use_dynamic_loss_scaling()
    # minimize: backward of the scaled loss, then the step; a real loss
    x = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    tloss = ts.scale(((torch.from_numpy(x) @ tparams[0] + tparams[1]) ** 2).mean())
    jloss = js.scale(((jp.to_tensor(x) @ jparams[0] + jparams[1]) ** 2).mean())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()), rtol=1e-6)
    ts.minimize(topt, tloss)
    js.minimize(jopt, jloss)
    assert ts.state_dict() == js.state_dict()
    for jpar, tpar in zip(jparams, tparams):
        np.testing.assert_allclose(tpar.detach().numpy(), np.asarray(jpar._value), rtol=0,
                                   atol=1e-6)


def test_unscale_reads_the_device_once(monkeypatch):
    """The found-inf flag crosses to the host once a step, whatever the
    number of parameters (the reference reads one flag a parameter)."""
    params = [torch.nn.Parameter(torch.ones(4)) for _ in range(5)]
    opt = tp.optimizer.SGD(0.1, parameters=params)
    s = tamp.GradScaler(init_loss_scaling=2.0)
    for p in params:
        p.grad = torch.ones(4)
    reads = []
    real = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append(1) or real(t))
    s.unscale_(opt)
    assert len(reads) == 1 and not s._found_inf
    assert all(torch.equal(p.grad, torch.full((4,), 0.5)) for p in params)


def test_lists_guard_and_decorate_match_the_reference():
    assert tamp.white_list == jamp.white_list and tamp.black_list == jamp.black_list
    assert tamp.amp_guard is tamp.auto_cast
    with tamp.amp_guard(level="O1", dtype="float16"):
        assert tamp.target_dtype("matmul") == torch.float16
        assert tamp.target_dtype("softmax") == torch.float32
        assert tamp.target_dtype("relu") is None
    with tamp.amp_guard(level="O2", dtype="float16", custom_black_list={"relu"}):
        assert tamp.target_dtype("relu") == torch.float32
        assert tamp.target_dtype("tanh") == torch.float16
    tm = tp.nn.Linear(3, 2)
    jm = jp.nn.Linear(3, 2)
    opt = tp.optimizer.SGD(0.1, parameters=tm.parameters())
    assert tamp.decorate(tm, level="O1") is tm and tm.weight.dtype == torch.float32
    models, opts = tamp.decorate([tm], opt, level="O2", dtype="float16")
    jmodels, _ = jamp.decorate([jm], jp.optimizer.SGD(0.1, parameters=jm.parameters()),
                               level="O2", dtype="float16")
    assert models == [tm] and opts is opt
    assert tm.weight.dtype == torch.float16 and tm.bias.dtype == torch.float16
    assert str(jm.weight.dtype).endswith("float16") and str(jm.bias.dtype).endswith("float16")
