"""The port's optimizer wrappers (paddle_tpu_torch/optimizer/wrappers.py:
ExponentialMovingAverage, LookAhead, ModelAverage) and incubate's
auto_checkpoint against the JAX package's.

The wrappers run over N steps in both packages from the same numpy
weights. The parameters' values at each step come from one seeded
sequence, written by a stand-in inner optimizer, so that the comparison
holds the wrappers' own arithmetic: shadows, slow weights and averages
bitwise equal (each is the reference's formula in its order, in float32,
and the reference runs them eagerly, one rounding per operation).

auto_checkpoint: a range stopped by SIGTERM (chaos at the "train.epoch"
site) exits with 143 after saving the epoch, and a new range resumes from
the next epoch to the same weights, bitwise, as an uninterrupted run; a
meta.json written by either package's range is resumed by the other's.
"""
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.incubate.checkpoint import TrainEpochRange as JaxRange
from paddle_tpu_torch import incubate
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.optimizer import ExponentialMovingAverage, LookAhead, ModelAverage
from paddle_tpu_torch.resilience import chaos, preemption

torch.set_num_threads(1)

SHAPES = ((3, 4), (4,))


@pytest.fixture(autouse=True)
def _cpu():
    chaos.reset()
    saved = tplace._CURRENT
    tp.set_device("cpu")
    yield
    chaos.reset()
    tplace._CURRENT = saved


def _values(n, seed=0):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) for s in SHAPES] for _ in range(n + 1)]


def _params(values):
    jparams = [jp.create_parameter(list(v.shape), "float32") for v in values]
    for p, v in zip(jparams, values):
        p._value = jnp.asarray(v)
    tparams = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    return jparams, tparams


class _Writer:
    """A stand-in inner optimizer: each step writes the next values of the
    sequence into its parameters (the JAX one into ``_value``)."""

    def __init__(self, params, values, jax_side):
        self._parameter_list = params
        self._values = iter(values)
        self._jax = jax_side

    def step(self):
        for p, v in zip(self._parameter_list, next(self._values)):
            if self._jax:
                p._value = jnp.asarray(v)
            else:
                with torch.no_grad():
                    p.copy_(torch.from_numpy(v))

    def clear_grad(self):
        pass

    def get_lr(self):
        return 0.5


def _same(jparams, tparams, msg=""):
    for j, t in zip(jparams, tparams):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j._value), err_msg=msg)


def _step_values(jparams, tparams, v):
    for j, t, x in zip(jparams, tparams, v):
        j._value = jnp.asarray(x)
        with torch.no_grad():
            t.copy_(torch.from_numpy(x))


@pytest.mark.parametrize("decay", [0.999, 0.5])
def test_ema_matches_the_reference(decay):
    values = _values(12)
    jparams, tparams = _params(values[0])
    je = jp.optimizer.ExponentialMovingAverage(decay, parameters=jparams)
    te = ExponentialMovingAverage(decay, parameters=tparams)
    for i, v in enumerate(values[1:]):
        _step_values(jparams, tparams, v)
        je.update()
        te.update()
        for p in range(len(SHAPES)):
            np.testing.assert_array_equal(te._shadow[id(tparams[p])].numpy(),
                                          np.asarray(je._shadow[id(jparams[p])]), err_msg=i)
    with te.apply():
        je.apply()
        _same(jparams, tparams, "applied")
        je.restore()
    _same(jparams, tparams, "restored")
    _same(jparams, [torch.from_numpy(v) for v in values[-1]], "the live weights")
    # need_restore=False keeps the shadow in until restore()
    te.apply(need_restore=False)
    assert torch.equal(tparams[0].detach(), te._shadow[id(tparams[0])])
    te.restore()
    assert torch.equal(tparams[0].detach(), torch.from_numpy(values[-1][0]))


@pytest.mark.parametrize("alpha,k", [(0.5, 5), (0.8, 2), (1.0, 1)])
def test_lookahead_matches_the_reference(alpha, k):
    values = _values(11, seed=1)
    jparams, tparams = _params(values[0])
    jl = jp.optimizer.LookAhead(_Writer(jparams, values[1:], True), alpha=alpha, k=k)
    tl = LookAhead(_Writer(tparams, values[1:], False), alpha=alpha, k=k)
    for i in range(11):
        jl.step()
        tl.step()
        _same(jparams, tparams, f"step {i}")
        for p in range(len(SHAPES)):
            np.testing.assert_array_equal(tl._slow[id(tparams[p])].numpy(),
                                          np.asarray(jl._slow[id(jparams[p])]))
    assert tl.get_lr() == jl.get_lr() == 0.5
    with pytest.raises(ValueError):
        LookAhead(_Writer(tparams, values, False), alpha=1.5)


def test_lookahead_minimize_steps_a_real_optimizer():
    net = tp.nn.Linear(3, 2)
    la = incubate.optimizer.LookAhead(tp.optimizer.SGD(0.1, parameters=net.parameters()),
                                      alpha=0.5, k=2)
    x = tp.to_tensor(np.ones((4, 3), np.float32))
    w0 = net.weight.detach().clone()
    la.minimize(net(x).sum())
    fast = net.weight.detach().clone()
    assert not torch.equal(fast, w0) and net.weight.grad is None
    la.minimize(net(x).sum())
    # step 2 of k = 2: slow = w0 + 0.5 * (fast2 - w0), and the fast weights are slow
    assert torch.equal(net.weight.detach(), la._slow[id(net.weight)])


@pytest.mark.parametrize("rate,min_w,max_w", [(0.15, 10000, 10000000), (0.5, 2, 4)])
def test_model_average_matches_the_reference(rate, min_w, max_w):
    values = _values(14, seed=2)
    jparams, tparams = _params(values[0])
    kw = dict(average_window_rate=rate, min_average_window=min_w, max_average_window=max_w)
    jm = jp.optimizer.ModelAverage(parameters=jparams, **kw)
    tm = ModelAverage(parameters=tparams, **kw)
    for i, v in enumerate(values[1:]):
        _step_values(jparams, tparams, v)
        jm.update()
        tm.update()
        assert tm._n == jm._n, i
        for p in range(len(SHAPES)):
            np.testing.assert_array_equal(tm._sum[id(tparams[p])].numpy(),
                                          np.asarray(jm._sum[id(jparams[p])]), err_msg=i)
    with tm.apply():
        jm.apply()
        _same(jparams, tparams, "averaged")
        jm.restore()
    _same(jparams, tparams, "restored")


def test_wrappers_need_parameters():
    with pytest.raises(ValueError):
        ExponentialMovingAverage()
    with pytest.raises(ValueError):
        ModelAverage()
    net = tp.nn.Linear(2, 2)
    assert len(ExponentialMovingAverage(layer=net)._params) == 2
    assert incubate.optimizer.ModelAverage is ModelAverage


# ------------------------------------------------------------ auto_checkpoint


def _epoch(net, opt, epoch):
    x = tp.to_tensor(np.random.RandomState(epoch).randn(8, 3).astype(np.float32))
    loss = (net(x) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


def _train(save_dir, epochs=5, stop_at=None):
    """A 5-epoch range over a seeded Linear with Adam; SIGTERM during epoch
    ``stop_at`` (chaos at "train.epoch"). Returns the net."""
    tp.seed(0)
    net = tp.nn.Linear(3, 2)
    opt = tp.optimizer.Adam(0.05, parameters=net.parameters())
    if stop_at is not None:
        chaos.arm("train.epoch", signum=signal.SIGTERM, at=chaos.visits("train.epoch") + 1 + stop_at)
    for epoch in incubate.auto_checkpoint.train_epoch_range(epochs, save_dir=save_dir,
                                                            model=net, optimizer=opt):
        _epoch(net, opt, epoch)
    return net


def test_auto_checkpoint_resumes_after_a_stop_bitwise(tmp_path):
    whole = _train(str(tmp_path / "whole"))
    d = str(tmp_path / "stopped")
    with pytest.raises(SystemExit) as stop:
        _train(d, stop_at=2)
    assert stop.value.code == preemption.EXIT_CODE == 143
    assert preemption.read_resume_marker(d)["step"] == 3
    with open(os.path.join(d, "meta.json")) as f:
        assert '"next_epoch": 3' in f.read()
    chaos.reset()
    # the restart: a new model and optimizer, restored from the snapshot
    resumed = _train(d)
    assert preemption.read_resume_marker(d) is None
    for a, b in zip(whole.parameters(), resumed.parameters()):
        assert torch.equal(a.detach(), b.detach())


def test_auto_checkpoint_falls_back_to_the_backup_meta(tmp_path):
    d = str(tmp_path)
    for _ in incubate.auto_checkpoint.train_epoch_range(2, save_dir=d):
        pass
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write('{"next_ep')
    with pytest.warns(UserWarning, match="falling back"):
        r = incubate.checkpoint.TrainEpochRange(4, save_dir=d)
    assert list(r) == [1, 2, 3]  # meta.json.bak recorded epoch 0's end
    os.remove(os.path.join(d, "meta.json.bak"))
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write("garbage")
    with pytest.warns(UserWarning):
        assert list(incubate.checkpoint.TrainEpochRange(2, save_dir=d)) == [0, 1]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_range_resumes_the_other_packages_meta(tmp_path, writer):
    d = str(tmp_path)
    first = JaxRange if writer == "reference" else incubate.checkpoint.TrainEpochRange
    second = incubate.checkpoint.TrainEpochRange if writer == "reference" else JaxRange
    assert list(first(3, save_dir=d)) == [0, 1, 2]
    assert list(second(6, save_dir=d)) == [3, 4, 5]
