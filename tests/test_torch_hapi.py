"""The port's high-level API (paddle_tpu_torch/hapi: Model, callbacks,
summary, flops) on the CPU: the reference's tests/test_hapi_dataset.py
TestHapiModel and tests/test_hapi_callbacks.py, ported; a LeNet fit of four
steps from weights carried across whose losses are within 1e-5 (relative)
of the JAX package's (float32 convolutions summed in another order);
``summary`` and ``flops`` equal to the reference's; a fit stopped by SIGTERM
(resilience.chaos) and resumed, bitwise an uninterrupted one; the knobs the
reference never reads refused."""
import json
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import Model, nn, optimizer
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping, LRScheduler,
                                             ModelCheckpoint, ReduceLROnPlateau, VisualDL)
from paddle_tpu_torch.io.dataset import Dataset
from paddle_tpu_torch.resilience import chaos, preemption
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet

torch.set_num_threads(2)
TOL_LOSS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


class _Subset:
    def __init__(self, ds, n):
        self.ds = ds
        self.n = min(n, len(ds))

    def __getitem__(self, i):
        return self.ds[i]

    def __len__(self):
        return self.n


def _lenet_model(net, pkg=tp):
    model = pkg.Model(net)
    model.prepare(pkg.optimizer.Adam(1e-3, parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
    return model


class TestHapiModel:
    @pytest.fixture(scope="class")
    def fitted(self):
        tp.seed(0)
        net = LeNet()
        model = _lenet_model(net)
        train = _Subset(MNIST(mode="train"), 2048)
        val = _Subset(MNIST(mode="test"), 256)
        model.fit(train, val, batch_size=64, epochs=2, verbose=0)
        return model, val

    def test_fit_learns(self, fitted):
        model, val = fitted
        res = model.evaluate(val, batch_size=64, verbose=0)
        assert res["acc"] > 0.9, res

    def test_predict_shapes(self, fitted):
        model, val = fitted
        out = model.predict(val, batch_size=64, verbose=0)
        assert out[0][0].shape[-1] == 10
        stacked = model.predict(val, batch_size=64, stack_outputs=True)
        assert stacked[0].shape == (256, 10)

    def test_train_eval_batch(self, fitted):
        model, val = fitted
        x, y = val[0]
        loss = model.eval_batch([np.asarray(x)[None]], [np.asarray(y).reshape(1, 1)])
        assert np.isfinite(loss[0][0])

    def test_save_load_roundtrip(self, fitted, tmp_path):
        model, val = fitted
        path = str(tmp_path / "hapi_ckpt")
        model.save(path)
        tp.seed(123)
        m2 = _lenet_model(LeNet())
        m2.load(path)
        res = m2.evaluate(_Subset(MNIST(mode="test"), 128), batch_size=64, verbose=0)
        assert res["acc"] > 0.9
        assert m2.evaluate(val, batch_size=64) == model.evaluate(val, batch_size=64)


# ---------------------------------------------- tests/test_hapi_callbacks.py
class _Toy(Dataset):
    def __init__(self, n=64):
        rng = np.random.RandomState(0)
        self.x = rng.rand(n, 4).astype(np.float32)
        w = rng.rand(4, 1).astype(np.float32)
        self.y = (self.x @ w).astype(np.float32)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def _fit(callbacks, epochs=2, lr=0.1):
    tp.seed(0)
    net = nn.Linear(4, 1)
    model = Model(net)
    opt = optimizer.SGD(lr, parameters=net.parameters())
    model.prepare(opt, nn.loss.MSELoss())
    model.fit(_Toy(), batch_size=16, epochs=epochs, verbose=0, callbacks=callbacks)
    return model, opt


class TestVisualDL:
    def test_writes_scalar_jsonl(self, tmp_path):
        log_dir = str(tmp_path / "vdl")
        _fit([VisualDL(log_dir)])
        rows = [json.loads(line) for line in open(os.path.join(log_dir, "train.jsonl"))]
        assert rows and all("step" in r and "loss" in r for r in rows)
        steps = [r["step"] for r in rows]
        assert steps == sorted(steps)
        assert os.path.exists(os.path.join(log_dir, "epoch.jsonl"))


class TestReduceLROnPlateau:
    def test_reduces_lr_when_flat(self):
        cb = ReduceLROnPlateau(monitor="flat", factor=0.5, patience=1, verbose=0)
        model, opt = _fit([cb], epochs=1)
        cb.set_model(model)
        lr0 = float(opt.get_lr())
        cb.on_epoch_end(0, {"flat": 1.0})
        cb.on_epoch_end(1, {"flat": 1.0})
        assert float(opt.get_lr()) == pytest.approx(lr0 * 0.5)

    def test_keeps_lr_when_improving(self):
        cb = ReduceLROnPlateau(monitor="m", factor=0.5, patience=1, verbose=0)
        model, opt = _fit([cb], epochs=1)
        cb.set_model(model)
        lr0 = float(opt.get_lr())
        for e, v in enumerate([1.0, 0.5, 0.25, 0.1]):
            cb.on_epoch_end(e, {"m": v})
        assert float(opt.get_lr()) == pytest.approx(lr0)

    def test_min_lr_floor_and_factor_validation(self):
        with pytest.raises(ValueError):
            ReduceLROnPlateau(factor=1.5)
        cb = ReduceLROnPlateau(monitor="flat", factor=0.1, patience=0, min_lr=0.05, verbose=0)
        model, opt = _fit([cb], epochs=1, lr=0.1)
        cb.set_model(model)
        cb.on_epoch_end(0, {"flat": 1.0})
        cb.on_epoch_end(1, {"flat": 1.0})
        assert float(opt.get_lr()) == pytest.approx(0.05)


def test_early_stopping_checkpoint_and_scheduler(tmp_path):
    stop = EarlyStopping(monitor="loss", patience=0, min_delta=1e9)
    best = ModelCheckpoint(save_dir=str(tmp_path), save_best_only=True, monitor="loss")
    model, _ = _fit([stop, best], epochs=5)
    assert model.stop_training and best.best_epoch == 1  # the loss fell; stopped after epoch 1
    assert json.load(open(tmp_path / "best.json"))["epoch"] == 1
    assert os.path.exists(tmp_path / "best.pdparams")
    tp.seed(0)
    net = nn.Linear(4, 1)
    sched = optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    model = Model(net)
    model.prepare(optimizer.SGD(sched, parameters=net.parameters()), nn.loss.MSELoss())
    model.fit(_Toy(), batch_size=16, epochs=1, verbose=0, callbacks=[LRScheduler()])
    assert sched.last_epoch == 4 and sched() == pytest.approx(0.025)


# ------------------------------------------------ parity with the reference
def _recorder(pkg):
    class Recorder(pkg.hapi.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    return Recorder()


def test_lenet_fit_losses_match_the_reference():
    jp.seed(0)
    jnet = jp.vision.models.LeNet()
    tnet = LeNet()
    load_state_dict(tnet, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    train = _Subset(MNIST(mode="train"), 256)
    losses = {}
    for name, pkg, net in (("ref", jp, jnet), ("port", tp, tnet)):
        rec = _recorder(pkg)
        model = _lenet_model(net, pkg)
        model.fit(train, batch_size=64, epochs=1, shuffle=False, verbose=0, callbacks=[rec])
        losses[name] = rec.losses
    assert len(losses["port"]) == len(losses["ref"]) == 4
    for g, w in zip(losses["port"], losses["ref"]):
        assert abs(g - w) <= TOL_LOSS * abs(w), (losses["port"], losses["ref"])


def test_summary_and_flops_equal_the_reference(capsys):
    jp.seed(0)
    jnet = jp.vision.models.LeNet()
    tnet = LeNet()
    got = tp.summary(tnet, (1, 1, 28, 28))
    t_out = capsys.readouterr().out
    assert got == jp.summary(jnet, (1, 1, 28, 28))
    assert t_out == capsys.readouterr().out
    assert tp.flops(tnet, [1, 1, 28, 28]) == jp.flops(jnet, [1, 1, 28, 28])
    for name in ("resnet18", "mobilenet_v2"):
        kw = dict(num_classes=10)
        assert tp.flops(getattr(tp.vision.models, name)(**kw), [1, 3, 32, 32]) == jp.flops(
            getattr(jp.vision.models, name)(**kw), [1, 3, 32, 32]), name
    assert Model(tnet).summary((1, 1, 28, 28))["total_params"] == 61610


class _EpochSeed(Callback):
    def on_epoch_begin(self, epoch, logs=None):
        np.random.seed(100 + epoch)


def _preemptible_fit(save_dir, kill_at=None, resume=False):
    tp.seed(7)
    net = LeNet()
    model = _lenet_model(net)
    if kill_at is not None:
        chaos.arm("train.step", signum=signal.SIGTERM, at=chaos.visits("train.step") + kill_at)
    try:
        model.fit(_Subset(MNIST(mode="train"), 192), batch_size=32, epochs=3, shuffle=True,
                  verbose=0, save_dir=save_dir, resume=resume, callbacks=[_EpochSeed()])
    finally:
        chaos.reset()
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def test_sigterm_stop_and_resume_is_bitwise(tmp_path):
    d_pre, d_ref = str(tmp_path / "pre"), str(tmp_path / "ref")
    _preemptible_fit(d_pre, kill_at=6 + 3)  # step 3 of epoch 2
    marker = preemption.read_resume_marker(d_pre)
    assert marker == {"preempted": True, "step": 1}
    assert not os.path.exists(os.path.join(d_pre, "final.pdparams"))
    resumed = _preemptible_fit(d_pre, resume=True)
    assert preemption.read_resume_marker(d_pre) is None
    assert os.path.exists(os.path.join(d_pre, "final.pdparams"))
    uninterrupted = _preemptible_fit(d_ref)
    for n in uninterrupted:
        assert torch.equal(resumed[n], uninterrupted[n]), n
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, None)


def test_unread_knobs_raise(tmp_path):
    net = nn.Linear(4, 1)
    model = Model(net)
    with pytest.raises(NotImplementedError, match="amp_configs"):
        model.prepare(optimizer.SGD(0.1, parameters=net.parameters()), nn.loss.MSELoss(),
                      amp_configs={"level": "O1"})
    model.prepare(optimizer.SGD(0.1, parameters=net.parameters()), nn.loss.MSELoss())
    with pytest.raises(NotImplementedError, match="accumulate_grad_batches"):
        model.fit(_Toy(), batch_size=16, accumulate_grad_batches=2, verbose=0)
    with pytest.raises(NotImplementedError, match="callbacks"):
        model.evaluate(_Toy(), callbacks=[Callback()])
    model.save(str(tmp_path / "m"))
    with pytest.raises(NotImplementedError, match="skip_mismatch"):
        model.load(str(tmp_path / "m"), skip_mismatch=True)
