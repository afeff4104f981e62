"""The port's bad-step guard (paddle_tpu_torch/resilience/badstep.py and
``build_train_step(bad_step_guard=True)``): the JAX package's
tests/test_resilience_badstep.py cases run on the port (the generic
guard, the fused guard in the training step, the consecutive-bad-step
policy, rollback through a CheckpointManager, GradScaler's skips feeding
the monitor, and three NaN steps recovered end to end), the guarded step
against the JAX package's on the same weights and batches, and the port's
own promises: with ``donate=True`` a bad step leaves the given params,
optimizer state and a layer's buffers bitwise as they were.

Tolerances: a bad step's state bitwise unchanged; the guarded step's loss
within 1e-6 relative of the reference's and its parameters within 1e-6
(the same float32 formulas, summed in another order); the recovered run
bitwise the clean run of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.distributed import topology
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.distributed import spmd
from paddle_tpu_torch.resilience import (BadStepMonitor, CheckpointManager, chaos,
                                         guard_step)
from paddle_tpu_torch.resilience.badstep import (OK, ROLLBACK, SKIP, select_tree,
                                                 tree_nonfinite)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    saved = tplace._CURRENT
    tp.set_device("cpu")
    yield
    chaos.reset()
    tplace._CURRENT = saved


def _sgd_step(params, opt_state, x):
    w = params["w"].detach().requires_grad_(True)
    loss = ((w * x) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [w])
    return loss.detach(), {"w": params["w"] - 0.1 * g}, opt_state


def _mse(out, y):
    return ((out - y) ** 2).mean()


class TestGuardStep:
    def test_good_step_updates(self):
        loss, p1, _, bad = guard_step(_sgd_step)({"w": torch.ones(3)}, {}, torch.ones(3))
        assert not bool(bad) and not torch.allclose(p1["w"], torch.ones(3))

    def test_nan_input_skips_update(self):
        _, p1, _, bad = guard_step(_sgd_step)({"w": torch.ones(3)}, {},
                                              torch.full((3,), float("nan")))
        assert bool(bad) and torch.equal(p1["w"], torch.ones(3))

    def test_inf_detected_too(self):
        _, p1, _, bad = guard_step(_sgd_step)({"w": torch.ones(3)}, {},
                                              torch.full((3,), float("inf")))
        assert bool(bad) and torch.equal(p1["w"], torch.ones(3))

    def test_tree_nonfinite_ignores_int_leaves(self):
        assert not bool(tree_nonfinite({"step": torch.tensor(3), "x": torch.ones(2)}))
        assert bool(tree_nonfinite({"step": torch.tensor(3),
                                    "x": torch.tensor([1.0, float("nan")])}))
        assert not bool(tree_nonfinite({}))
        assert bool(tree_nonfinite([torch.ones(1), (torch.tensor([float("-inf")]),)]))

    def test_select_tree_keeps_structure_and_bits(self):
        old = {"a": torch.tensor([-0.0, 1.0]), "b": (torch.ones(2), 7)}
        new = {"a": torch.tensor([float("nan"), 2.0]), "b": (torch.zeros(2), 8)}
        kept = select_tree(torch.tensor(True), old, new)
        assert torch.equal(kept["a"], old["a"]) and torch.signbit(kept["a"][0])
        assert isinstance(kept["b"], tuple) and kept["b"][1] == 8
        taken = select_tree(torch.tensor(False), old, new)
        assert torch.equal(taken["b"][0], torch.zeros(2))


def _build(seed=0, guard=True, donate=True, opt_cls=optimizer.SGD, layer=None, **kw):
    tp.seed(seed)
    net = layer if layer is not None else nn.Linear(4, 2)
    opt = opt_cls(0.1, parameters=net.parameters())
    step_fn, init_fn = spmd.build_train_step(net, _mse, opt, bad_step_guard=guard,
                                             donate=donate, **kw)
    return net, step_fn, init_fn


def _batch(rng):
    return (torch.from_numpy(rng.rand(8, 4).astype(np.float32)),
            torch.from_numpy(rng.rand(8, 2).astype(np.float32)))


class TestBuildTrainStepGuard:
    @pytest.mark.chaos
    @pytest.mark.parametrize("donate", [True, False])
    def test_nan_batch_is_noop_and_recovery(self, donate):
        _, step_fn, init_fn = _build(donate=donate, opt_cls=optimizer.Adam)
        params, opt_state = init_fn()
        x, y = _batch(np.random.RandomState(0))
        loss, params, opt_state, bad = step_fn(params, opt_state, x, y)
        assert not bool(bad) and np.isfinite(float(loss)) and bad.dtype == torch.bool
        snap = {k: v.clone() for k, v in params.items()}
        snap_st = {k: tuple(a.clone() for a in v) for k, v in opt_state.items()}
        given = (params, opt_state)
        chaos.arm("badstep.batch", nan=True, at=chaos.visits("badstep.batch") + 1)
        xn = torch.from_numpy(chaos.poison("badstep.batch", x.numpy()))
        assert torch.isnan(xn).any()
        loss, params, opt_state, bad = step_fn(params, opt_state, xn, y)
        assert bool(bad) and not np.isfinite(float(loss))
        for k in snap:
            assert torch.equal(params[k], snap[k])
            assert all(torch.equal(a, b) for a, b in zip(opt_state[k], snap_st[k]))
            # the tensors handed in are untouched too (donate writes in place)
            assert torch.equal(given[0][k], snap[k])
            assert all(torch.equal(a, b) for a, b in zip(given[1][k], snap_st[k]))
        loss, params, opt_state, bad = step_fn(params, opt_state, x, y)
        assert not bool(bad)
        assert any(not torch.equal(params[k], snap[k]) for k in snap)

    def test_a_bad_step_does_not_write_the_buffers(self):
        """BatchNorm's running statistics: a NaN batch would make them NaN;
        the guard keeps the layer's buffers as they were."""
        tp.seed(3)
        net = nn.Sequential(nn.Linear(4, 4), nn.BatchNorm1D(4), nn.Linear(4, 2))
        _, step_fn, init_fn = _build(layer=net)
        params, opt_state = init_fn()
        rng = np.random.RandomState(1)
        x, y = _batch(rng)
        _, params, opt_state, bad = step_fn(params, opt_state, x, y)
        assert not bool(bad)
        bufs = {n: b.clone() for n, b in net.named_buffers()}
        assert bufs and all(torch.isfinite(b).all() for b in bufs.values())
        xn = x.clone()
        xn[0, 0] = float("nan")
        _, params, opt_state, bad = step_fn(params, opt_state, xn, y)
        assert bool(bad)
        for n, b in net.named_buffers():
            assert torch.equal(b, bufs[n]), n
        _, params, opt_state, bad = step_fn(params, opt_state, x, y)
        assert not bool(bad)
        assert any(not torch.equal(b, bufs[n]) for n, b in net.named_buffers()
                   if b.is_floating_point())

    def test_guarded_step_matches_the_reference(self):
        """The same weights and batches through the JAX package's guarded
        step and the port's: bad flags equal, losses and params close, and
        the bad steps leave both where they were."""
        jp.seed(0)
        jnet = jp.nn.Linear(4, 2)
        w0 = {n: np.array(p._value) for n, p in jnet.named_parameters()}
        jopt = jp.optimizer.Momentum(0.1, parameters=jnet.parameters())
        jstep, jinit = jspmd.build_train_step(
            jnet, lambda out, y: jnp.mean((out - y) ** 2), jopt,
            mesh=topology.build_mesh(dp=1, devices=jax.devices()[:1]), bad_step_guard=True)
        tnet = nn.Linear(4, 2)
        with torch.no_grad():
            for n, p in tnet.named_parameters():
                p.copy_(torch.from_numpy(w0[n]))
        topt = optimizer.Momentum(0.1, parameters=tnet.parameters())
        tstep, tinit = spmd.build_train_step(tnet, _mse, topt, bad_step_guard=True)
        jpar, jst = jinit()
        tpar, tst = tinit()
        rng = np.random.RandomState(2)
        for i in range(6):
            x, y = _batch(rng)
            if i in (2, 3):
                x[1, 2] = float("inf") if i == 2 else float("nan")
            jl, jpar, jst, jbad = jstep(jpar, jst, jnp.asarray(x.numpy()),
                                        jnp.asarray(y.numpy()))
            tl, tpar, tst, tbad = tstep(tpar, tst, x, y)
            assert bool(jbad) == bool(tbad) == (i in (2, 3)), i
            if not bool(tbad):
                np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
            for n in tpar:
                np.testing.assert_allclose(tpar[n].numpy(), np.asarray(jpar[n]), rtol=0,
                                           atol=1e-6, err_msg=f"{n} step {i}")

    def test_offload_with_the_guard(self):
        """offload=True and bad_step_guard=True together: the guarded
        offloaded step is bitwise the guarded resident one, bad steps
        included."""
        runs = {}
        for offload in (False, True):
            _, step_fn, init_fn = _build(seed=5, opt_cls=optimizer.AdamW, offload=offload)
            params, state = init_fn()
            rng = np.random.RandomState(4)
            bads = []
            for i in range(4):
                x, y = _batch(rng)
                if i == 1:
                    x[0, 0] = float("nan")
                _, params, state, bad = step_fn(params, state, x, y)
                bads.append(bool(bad))
            runs[offload] = (params, state, bads)
        (p0, s0, b0), (p1, s1, b1) = runs[False], runs[True]
        assert b0 == b1 == [False, True, False, False]
        assert all(torch.equal(p0[n], p1[n]) for n in p0)
        assert all(torch.equal(a, b) for n in s0 for a, b in zip(s0[n], s1[n]))


class TestBadStepMonitor:
    def test_threshold_rollback_policy(self):
        m = BadStepMonitor(threshold=3)
        assert m.record(False) == OK
        assert m.record(True) == SKIP
        assert m.record(True) == SKIP
        assert m.record(True) == ROLLBACK
        assert m.record(True) == SKIP
        assert m.record(False) == OK
        assert m.total_bad == 4 and m.rollbacks == 1
        assert m.state_dict() == {"consecutive": 0, "total_bad": 4, "rollbacks": 1}

    def test_good_step_resets_streak(self):
        m = BadStepMonitor(threshold=2)
        assert m.record(True) == SKIP
        assert m.record(False) == OK
        assert m.record(True) == SKIP

    def test_on_rollback_callback(self):
        fired = []
        m = BadStepMonitor(threshold=1, on_rollback=lambda: fired.append(1))
        assert m.record(torch.tensor(True)) == ROLLBACK
        assert fired == [1]

    def test_bad_threshold_refused(self):
        with pytest.raises(ValueError):
            BadStepMonitor(threshold=0)

    @pytest.mark.chaos
    def test_rollback_restores_last_good_checkpoint(self, tmp_path):
        from paddle_tpu_torch.obs import goodput

        mgr = CheckpointManager(tmp_path)
        good = {"w": np.arange(4, dtype=np.float32)}
        mgr.save(good, 10)
        mon = BadStepMonitor(threshold=3, manager=mgr)
        actions = [mon.record(True) for _ in range(3)]
        assert actions[-1] == ROLLBACK
        before = goodput.report()["rollback_s"]
        state, step = mon.restore()
        assert step == 10
        np.testing.assert_array_equal(np.asarray(state["w"]), good["w"])
        assert goodput.report()["rollback_s"] > before

    def test_restore_without_manager_raises(self, tmp_path):
        with pytest.raises(RuntimeError, match="no CheckpointManager"):
            BadStepMonitor().restore()
        with pytest.raises(RuntimeError, match="no usable checkpoint"):
            BadStepMonitor(manager=CheckpointManager(tmp_path)).restore()


class TestGradScalerComposition:
    def test_scaler_overflow_feeds_monitor(self):
        from paddle_tpu_torch.amp import GradScaler

        tp.seed(0)
        net = nn.Linear(3, 1)
        opt = optimizer.SGD(0.1, parameters=net.parameters())
        scaler = GradScaler(init_loss_scaling=2.0 ** 10)
        mon = scaler.attach_bad_step_monitor(BadStepMonitor(threshold=3))
        x = tp.to_tensor(np.ones((4, 3), np.float32))
        before = [p.detach().clone() for p in net.parameters()]
        for _ in range(3):
            opt.clear_grad()
            scaler.scale(net(x).sum()).backward()
            for p in net.parameters():
                if p.grad is not None:
                    p.grad = p.grad * float("inf")
            scaler.step(opt)
        assert mon.total_bad == 3 and mon.rollbacks == 1
        assert all(torch.equal(p.detach(), b) for p, b in zip(net.parameters(), before))
        assert scaler._scale == 2.0 ** 7
        opt.clear_grad()
        scaler.scale(net(x).sum()).backward()
        scaler.step(opt)
        assert mon.consecutive == 0
        assert any(not torch.equal(p.detach(), b) for p, b in zip(net.parameters(), before))


@pytest.mark.chaos
class TestEndToEndNaNRecovery:
    """Three consecutive NaN steps recover on their own: the guarded loop
    (skip, then roll back to the last good checkpoint at the threshold)
    reaches the same params as a run that never saw the NaN batches."""

    def test_three_nan_steps_rollback_and_converge(self, tmp_path):
        rng = np.random.RandomState(0)
        batches = [(rng.rand(8, 4).astype(np.float32), rng.rand(8, 2).astype(np.float32))
                   for _ in range(8)]

        def build():
            return _build(seed=42, opt_cls=optimizer.Momentum)[1:]

        def run(poison_steps, ckpt_root):
            mgr = CheckpointManager(ckpt_root, keep=2)
            mon = BadStepMonitor(threshold=3, manager=mgr)
            step_fn, init_fn = build()
            params, opt_state = init_fn()
            good = rollbacks = 0
            for i, (x, y) in enumerate(batches, start=1):
                if i in poison_steps:
                    chaos.arm("e2e.batch", nan=True, at=chaos.visits("e2e.batch") + 1)
                x = torch.from_numpy(chaos.poison("e2e.batch", x))
                loss, params, opt_state, bad = step_fn(params, opt_state, x,
                                                       torch.from_numpy(y))
                action = mon.record(bool(bad))
                if action == ROLLBACK:
                    state, _ = mon.restore()
                    params = {k: torch.as_tensor(np.asarray(v)).clone()
                              for k, v in state["params"].items()}
                    opt_state = {k: tuple(torch.as_tensor(np.asarray(a)).clone() for a in v)
                                 for k, v in state["opt"].items()}
                    rollbacks += 1
                elif action == OK:
                    good += 1
                    mgr.save({"params": {k: v.numpy() for k, v in params.items()},
                              "opt": {k: [a.numpy() for a in v]
                                      for k, v in opt_state.items()}}, good)
            return params, good, rollbacks

        p_chaos, good_c, rb = run({4, 5, 6}, str(tmp_path / "chaos"))
        chaos.reset()
        assert rb == 1 and good_c == 5
        step_fn, init_fn = build()
        params, opt_state = init_fn()
        for x, y in [batches[i] for i in (0, 1, 2, 6, 7)]:
            _, params, opt_state, _ = step_fn(params, opt_state, torch.from_numpy(x),
                                              torch.from_numpy(y))
        for k in p_chaos:
            assert torch.equal(p_chaos[k], params[k]), k
