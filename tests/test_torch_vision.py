"""The port's vision models (paddle_tpu_torch/vision/models) against the JAX
package's, on the CPU, the JAX model's parameters and BatchNorm buffers
carried across by ``convert.load_state_dict`` and inputs made from a numpy
seed; and ``build_train_step`` over layers with buffers.

Tolerances, each with its reason:
- forwards: 1e-4 of the output's max magnitude (float32 convolutions
  summed in another order by XLA and by ATen, through up to 20 layers);
- one O0 ``build_train_step`` step of ``resnet18(num_classes=10)`` at
  bench.py's smoke config (Momentum 0.1 / 0.9, weight decay 1e-4, 32 x 32,
  batch 4), chip_smoke.py phase 5's bounds: loss 1e-4 relative; each
  parameter's velocity (its gradient plus the decay, after one step)
  within 1e-3 of its max magnitude; updated parameters within 2.5 * lr;
  the BatchNorm running statistics within 1e-4 of their max;
  At batch 2 the last stage's BatchNorm would normalise two values per
  channel (its maps are 1 x 1), which multiplies the float32 rounding of
  its input by up to ~1e3 (2e-3 relative in the logits); bench.py's
  batch of 4 keeps the step well conditioned.
- the buffers of a ``recompute=True`` step and of a step after a
  checkpoint is loaded: bitwise, as the same computation on one machine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.distributed import topology
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.distributed import spmd as tspmd

torch.set_num_threads(2)
LR = 0.1
TOL_FWD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _numpy_state(layer):
    return {k: np.array(v.numpy()) for k, v in layer.state_dict().items()}  # a copy


def pair(name, **kw):
    """The JAX model ``name`` (seed 0) and the port's with its state."""
    jp.seed(0)
    jm = getattr(jp.vision.models, name)(**kw)
    tm = getattr(tp.vision.models, name)(**kw)
    load_state_dict(tm, _numpy_state(jm))
    return jm, tm


def images(b, c, hw, seed=0):
    return np.random.RandomState(seed).rand(b, c, hw, hw).astype(np.float32)


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err:.3e} > {tol} of {np.abs(want).max()}"


@pytest.mark.parametrize("name,kw,c,hw", [
    ("LeNet", {}, 1, 28),
    ("mobilenet_v2", dict(scale=0.35, num_classes=10), 3, 32),
    ("vgg11", dict(num_classes=0), 3, 32),
    ("vgg11", dict(batch_norm=True, num_classes=0), 3, 32),
])
def test_forward_matches_jax(name, kw, c, hw):
    jm, tm = pair(name, **kw)
    jm.eval()
    tm.eval()
    x = images(2, c, hw)
    want = jm(jp.to_tensor(x)).numpy()
    got = tm(tp.to_tensor(x))
    assert isinstance(got, tp.Tensor)
    close(got.numpy(), want, TOL_FWD, name)


def test_mobilenet_aliases():
    from paddle_tpu_torch.vision.models import mobilenet, mobilenetv1, mobilenetv2

    assert mobilenetv1 is mobilenetv2 is mobilenet
    assert mobilenetv1.MobileNetV1 is tp.vision.models.MobileNetV1


def _jax_loss(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _torch_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1).mean()


def _buffers(state):
    return {k: v for k, v in state.items() if k.endswith(("_mean", "_variance"))}


@pytest.fixture(scope="module")
def resnet_steps():
    """One O0 step of resnet18 (bench.py's smoke model) on each side from
    the same weights and batch, and the eval forwards after it."""
    jm, tm = pair("resnet18", num_classes=10)
    start = _numpy_state(tm)
    x = images(4, 3, 32)
    y = np.random.RandomState(1).randint(0, 10, (4,)).astype(np.int32)
    runs = {}
    for side, m, opt_mod, spmd_mod, loss_fn, arr in (
            ("jax", jm, jopt, jspmd, _jax_loss, jnp.asarray),
            ("port", tm, topt, tspmd, _torch_loss, torch.from_numpy)):
        m.train()
        opt = opt_mod.Momentum(LR, momentum=0.9, parameters=m.parameters(),
                               weight_decay=1e-4)
        kw = dict(mesh=topology.build_mesh(dp=1, devices=jax.devices()[:1])) \
            if side == "jax" else {}
        step, init = spmd_mod.build_train_step(m, loss_fn, opt, **kw)
        params, state = init()
        loss, params, state = step(params, state, arr(x), arr(y))
        velocity = {n: np.asarray(st[0]) if side == "jax" else st[0].numpy()
                    for n, st in state.items()}
        new_params = {n: np.asarray(p) if side == "jax" else p.numpy()
                      for n, p in params.items()}
        buffers = _buffers(_numpy_state(m))
        m.set_state_dict(new_params)
        m.eval()
        out = m(jp.to_tensor(x) if side == "jax" else tp.to_tensor(x)).numpy()
        runs[side] = dict(loss=float(loss), velocity=velocity, params=new_params,
                          buffers=buffers, eval_out=np.asarray(out))
    return runs, start, x, y


def test_resnet18_step_matches_jax(resnet_steps):
    (runs, start, _, _) = resnet_steps
    j, t = runs["jax"], runs["port"]
    assert np.isfinite(t["loss"])
    assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"])
    assert sorted(t["velocity"]) == sorted(j["velocity"])
    for n in j["velocity"]:
        close(t["velocity"][n], j["velocity"][n], 1e-3, f"velocity {n}")
        assert np.abs(t["params"][n] - j["params"][n]).max() <= 2.5 * LR, n


def test_resnet18_step_updates_the_batchnorm_statistics(resnet_steps):
    runs, start, _, _ = resnet_steps
    j, t = runs["jax"], runs["port"]
    assert sorted(t["buffers"]) == sorted(j["buffers"]) and len(j["buffers"]) == 40
    for n in j["buffers"]:
        assert not np.array_equal(t["buffers"][n], start[n]), f"{n} did not move"
        close(t["buffers"][n], j["buffers"][n], 1e-4, n)


def test_resnet18_eval_after_training(resnet_steps):
    runs, _, _, _ = resnet_steps
    close(runs["port"]["eval_out"], runs["jax"]["eval_out"], 1e-3, "eval after the step")


def _port_step(m, x, y, recompute=False):
    opt = topt.Momentum(LR, momentum=0.9, parameters=m.parameters(), weight_decay=1e-4)
    step, init = tspmd.build_train_step(m, _torch_loss, opt, recompute=recompute)
    params, state = init()
    return step, params, state, (torch.from_numpy(x), torch.from_numpy(y))


def test_recompute_updates_the_buffers_once(resnet_steps):
    """A recompute=True step runs the forward twice (again in the
    backward); the statistics move once, bitwise as in a plain step."""
    _, start, x, y = resnet_steps
    got = {}
    for rc in (False, True):
        tp.seed(0)
        m = tp.vision.models.resnet18(num_classes=10)
        m.set_state_dict(start)
        step, params, state, batch = _port_step(m, x, y, recompute=rc)
        loss, params, state = step(params, state, *batch)
        got[rc] = (float(loss), _buffers(_numpy_state(m)),
                   {n: p.numpy() for n, p in params.items()})
    assert got[True][0] == got[False][0]
    for n in got[False][1]:
        assert np.array_equal(got[True][1][n], got[False][1][n]), n
    for n in got[False][2]:
        assert np.array_equal(got[True][2][n], got[False][2][n]), n


def test_buffers_loaded_between_steps_are_picked_up(resnet_steps):
    """Statistics loaded onto the layer between steps (a checkpoint) are
    what the next step starts from: the same step from the same buffers
    gives the same buffers, bitwise."""
    _, start, x, y = resnet_steps
    tp.seed(0)
    m = tp.vision.models.resnet18(num_classes=10)
    m.set_state_dict(start)
    checkpoint = _buffers(_numpy_state(m))
    step, params, state, batch = _port_step(m, x, y)
    params0 = {n: p.clone() for n, p in params.items()}
    state0 = {n: tuple(s.clone() for s in st) for n, st in state.items()}
    step(params, state, *batch)
    first = _buffers(_numpy_state(m))
    m.set_state_dict(checkpoint)
    step(params0, state0, *batch)
    again = _buffers(_numpy_state(m))
    for n in first:
        assert not np.array_equal(first[n], checkpoint[n]), n
        assert np.array_equal(again[n], first[n]), n
