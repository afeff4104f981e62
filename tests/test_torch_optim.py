"""The port's optimizer library (paddle_tpu_torch: optimizer/lr.py,
optimizer/optimizer.py, regularizer.py, nn/clip.py) against the JAX
package's, on inputs from a numpy seed.

Tolerances, each with its reason:
- schedulers: 1e-12 relative (the same host float formulas; only libm
  could round differently);
- optimizer ``_update``s, clips and eager steps: 1e-6 relative plus 1e-7
  of the tensor's max magnitude (the same float32 formulas; XLA may fuse
  and reassociate them, the reductions sum in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(1)

RTOL = 1e-6
ATOL_OF_MAX = 1e-7


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_OF_MAX * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


# ------------------------------------------------------------------ schedulers

SCHEDULERS = {
    "noam": ("NoamDecay", dict(d_model=512, warmup_steps=8)),
    "noam_resumed": ("NoamDecay", dict(d_model=512, warmup_steps=4000, last_epoch=3999)),
    "piecewise": ("PiecewiseDecay", dict(boundaries=[5, 12, 20], values=[1.0, 0.5, 0.1, 0.01])),
    "natural_exp": ("NaturalExpDecay", dict(learning_rate=0.3, gamma=0.07)),
    "inverse_time": ("InverseTimeDecay", dict(learning_rate=0.3, gamma=0.2)),
    "polynomial": ("PolynomialDecay", dict(learning_rate=0.3, decay_steps=11, power=2.0)),
    "polynomial_cycle": ("PolynomialDecay", dict(learning_rate=0.3, decay_steps=7,
                                                 cycle=True)),
    "linear_warmup": ("LinearWarmup", dict(learning_rate=0.5, warmup_steps=6, start_lr=0.0,
                                           end_lr=0.5)),
    "exponential": ("ExponentialDecay", dict(learning_rate=0.3, gamma=0.9)),
    "multistep": ("MultiStepDecay", dict(learning_rate=0.3, milestones=[4, 9, 17],
                                         gamma=0.3)),
    "step": ("StepDecay", dict(learning_rate=0.3, step_size=4, gamma=0.5)),
    "lambda": ("LambdaDecay", dict(learning_rate=0.3, lr_lambda=lambda e: 0.95 ** e)),
    "multiplicative": ("MultiplicativeDecay", dict(learning_rate=0.3,
                                                   lr_lambda=lambda e: 0.9 + 0.001 * e)),
    "cosine": ("CosineAnnealingDecay", dict(learning_rate=0.3, T_max=13, eta_min=0.01)),
    "one_cycle": ("OneCycleLR", dict(max_learning_rate=0.4, total_steps=30)),
    "cyclic": ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                                step_size_up=4, step_size_down=6)),
    "cyclic_triangular2": ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                                            step_size_up=5, mode="triangular2")),
    "cyclic_exp_range": ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                                          step_size_up=3, mode="exp_range", exp_gamma=0.9)),
}


def _sched(mod, name):
    cls, kw = SCHEDULERS[name]
    return getattr(mod, cls)(**kw)


def _warm_cosine(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(0.2, T_max=10), warmup_steps=5,
                            start_lr=0.01, end_lr=0.2)


def _trajectory(s, n=30):
    out = [s()]
    for _ in range(n):
        s.step()
        out.append(s())
    return np.array(out)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_reference(name):
    _close_lr(_trajectory(_sched(tlr, name)), _trajectory(_sched(jlr, name)))


def _close_lr(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_linear_warmup_wrapping_cosine_matches_reference():
    t, j = _warm_cosine(tlr), _warm_cosine(jlr)
    _close_lr(_trajectory(t), _trajectory(j))
    assert t.lr_sched.last_epoch == j.lr_sched.last_epoch == 25


def test_reduce_on_plateau_with_a_metric_matches_reference():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84, 0.85] * 3
    kw = dict(learning_rate=0.5, factor=0.5, patience=2, cooldown=1, min_lr=0.05)
    for mode_kw in (dict(), dict(mode="max", threshold_mode="abs", threshold=0.01)):
        t, j = tlr.ReduceOnPlateau(**kw, **mode_kw), jlr.ReduceOnPlateau(**kw, **mode_kw)
        got, want = [], []
        for i, m in enumerate(metrics):
            # the port reads a one-element tensor on the host too
            t.step(torch.tensor(m) if i % 2 else m)
            j.step(m)
            got.append(t())
            want.append(j())
        t.step()  # no metric: nothing
        _close_lr(np.array(got + [t()]), np.array(want + [want[-1]]))
        assert t.state_dict() == j.state_dict()
    assert len(set(got)) > 2  # the rate was cut more than once


def test_scheduler_state_dict_round_trip():
    t, j = _warm_cosine(tlr), _warm_cosine(jlr)
    for s in (t, j):
        for _ in range(7):
            s.step()
    sd = t.state_dict()
    assert sd == {k: v for k, v in j.state_dict().items()}
    assert "lr_sched" not in sd and sd["last_epoch"] == 7
    fresh = tlr.NoamDecay(d_model=64, warmup_steps=3)
    fresh.set_state_dict(_sched(tlr, "noam").state_dict())
    fresh.step()
    ref = _sched(jlr, "noam")
    ref.step()
    assert fresh() == ref() and fresh.d_model == 512
    lam = _sched(tlr, "lambda")
    assert "lr_lambda" not in lam.state_dict()


def test_schedulers_refuse_knobs_the_reference_ignores():
    with pytest.raises(NotImplementedError):
        tlr.OneCycleLR(0.1, 10, anneal_strategy="linear")
    with pytest.raises(NotImplementedError):
        tlr.OneCycleLR(0.1, 10, three_phase=True)
    with pytest.raises(NotImplementedError):
        tlr.CyclicLR(0.01, 0.1, 3, scale_fn=lambda x: 1.0)


# ------------------------------------------------------------------ _update

OPTIMIZERS = [
    ("SGD", dict()),
    ("SGD", dict(weight_decay=0.01)),
    ("Momentum", dict(momentum=0.8)),
    ("Momentum", dict(momentum=0.9, use_nesterov=True, weight_decay=0.02)),
    ("Momentum", dict(momentum=0.9, use_lars=True, lars_coeff=0.01, lars_weight_decay=0.001)),
    ("Lars", dict(momentum=0.85, lars_coeff=0.02)),
    ("Adam", dict(beta1=0.8, beta2=0.99, epsilon=1e-6, weight_decay=0.01)),
    ("AdamW", dict(beta1=0.85, beta2=0.95, weight_decay=0.1)),
    ("Adamax", dict(beta1=0.9, beta2=0.99)),
    ("Adagrad", dict(epsilon=1e-5, initial_accumulator_value=0.1)),
    ("Adadelta", dict(rho=0.9, epsilon=1e-5)),
    ("RMSProp", dict(rho=0.9)),
    ("RMSProp", dict(rho=0.9, momentum=0.5, centered=True, weight_decay=0.01)),
    ("Lamb", dict(lamb_weight_decay=0.02)),
    ("Ftrl", dict(l1=0.05, l2=0.1)),
    ("Ftrl", dict(lr_power=-0.7)),
    ("DecayedAdagrad", dict(decay=0.9)),
]


@pytest.mark.parametrize("cls,kw", OPTIMIZERS,
                         ids=[f"{c}-{i}" for i, (c, _) in enumerate(OPTIMIZERS)])
def test_update_matches_reference(cls, kw):
    """Three steps of each optimizer's ``_update`` at float32, with the
    hypers the two shells give for no parameter."""
    lr = 0.05
    jo = getattr(jopt, cls)(lr, parameters=[], **kw)
    to = getattr(topt, cls)(lr, parameters=[], **kw)
    jh, th = jo._hypers(), to._hypers()
    assert jh == th
    p = _rand(5, 7, seed=1)
    jstate = (jnp.asarray(p), *jo._init_state(jnp.asarray(p)))
    tstate = (torch.from_numpy(p.copy()), *to._init_state(torch.from_numpy(p.copy())))
    for step in range(3):
        g = _rand(5, 7, seed=10 + step)
        jout = type(jo)._update(jstate[0], jnp.asarray(g), jnp.asarray(lr, jnp.float32),
                                *jstate[1:], **jh)
        tout = type(to)._update(tstate[0], torch.from_numpy(g), torch.tensor(lr),
                                *tstate[1:], **th)
        assert len(tout) == len(jout)
        for i, (a, b) in enumerate(zip(jout, tout)):
            assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
            _close(b.numpy(), a, err_msg=f"{cls} step {step} output {i}")
        jstate, tstate = jout, tout
    assert not np.array_equal(tstate[0].numpy(), p)


# ------------------------------------------------------------------ regularizers


@pytest.mark.parametrize("case", ["l2_float", "l2", "l1", "param_l1_over_l2",
                                  "param_l2_over_l1", "ftrl_l1_split"])
def test_regularizer_hypers_match_reference(case):
    """``_hypers`` for no parameter and for one with its own regularizer;
    L1 travels as ``l1_reg``, which ``_take_l1`` pops, apart from Ftrl's
    own ``l1``."""
    def build(opt_mod, reg_mod):
        wd = {"l2_float": 0.03, "l2": reg_mod.L2Decay(0.02), "l1": reg_mod.L1Decay(0.01),
              "param_l1_over_l2": reg_mod.L2Decay(0.02),
              "param_l2_over_l1": reg_mod.L1Decay(0.01),
              "ftrl_l1_split": reg_mod.L1Decay(0.04)}[case]
        cls = opt_mod.Ftrl if case == "ftrl_l1_split" else opt_mod.Momentum
        kw = dict(l1=0.5) if case == "ftrl_l1_split" else {}
        return cls(0.1, parameters=[], weight_decay=wd, **kw)

    class P:  # a parameter with its own regularizer
        regularizer = None

    jo, to = build(jopt, jreg), build(topt, treg)
    jp, tp = P(), P()
    if case == "param_l1_over_l2":
        jp.regularizer, tp.regularizer = jreg.L1Decay(0.07), treg.L1Decay(0.07)
    elif case == "param_l2_over_l1":
        jp.regularizer, tp.regularizer = jreg.L2Decay(0.05), treg.L2Decay(0.05)
    for jh, th in ((jo._hypers(), to._hypers()), (jo._hypers(jp), to._hypers(tp))):
        assert jh == th
        assert type(jo)._take_l1(dict(jh)) == type(to)._take_l1(th)
        assert "l1_reg" not in th
    if case == "ftrl_l1_split":
        assert th["l1"] == 0.5 and to._hypers()["l1_reg"] == 0.04


def _params(mod, arrays, names):
    if mod is jopt:
        return [JParameter(jnp.asarray(a), name=n) for a, n in zip(arrays, names)]
    out = []
    for a, n in zip(arrays, names):
        p = torch.nn.Parameter(torch.from_numpy(a.copy()))
        p.param_name = n  # the reference's Parameter.name
        out.append(p)
    return out


def _set_grads(params, grads):
    for p, g in zip(params, grads):
        if isinstance(p, torch.Tensor):
            p.grad = torch.from_numpy(g.copy())
        else:
            p._grad = jnp.asarray(g)


def _value(p):
    return p.detach().numpy() if isinstance(p, torch.Tensor) else np.asarray(p._value)


@pytest.mark.parametrize("cls", ["SGD", "Adam", "Ftrl"])
def test_eager_step_with_regularizers_matches_reference(cls):
    """``step()`` with an L1Decay on the optimizer, a parameter with its own
    L2Decay and one with a learning-rate ratio (``optimize_attr``)."""
    arrays = [_rand(4, 3, seed=1), _rand(6, seed=2), _rand(2, 2, seed=3)]
    names = ["w0", "b0", "w1"]
    opts, params = {}, {}
    for mod, reg in ((jopt, jreg), (topt, treg)):
        ps = _params(mod, arrays, names)
        ps[1].regularizer = reg.L2Decay(0.3)
        ps[2].optimize_attr = {"learning_rate": 0.5}
        kw = dict(l1=0.01) if cls == "Ftrl" else {}
        opts[mod] = getattr(mod, cls)(0.1, parameters=ps, weight_decay=reg.L1Decay(0.02), **kw)
        params[mod] = ps
    for step in range(3):
        grads = [_rand(*a.shape, seed=20 + 3 * step + i) for i, a in enumerate(arrays)]
        for mod in (jopt, topt):
            _set_grads(params[mod], grads)
            opts[mod].step()
            opts[mod].clear_grad()
    for jp, tp, n in zip(params[jopt], params[topt], names):
        _close(_value(tp), _value(jp), err_msg=n)
        assert tp.grad is None
    assert opts[topt]._step_count == 3


# ------------------------------------------------------------------ clips


@pytest.mark.parametrize("clip", ["value", "value_asym", "norm_small", "norm_large",
                                  "global"])
def test_clip_arrays_match_reference(clip):
    def build(mod):
        return {"value": lambda: mod.ClipGradByValue(0.5),
                "value_asym": lambda: mod.ClipGradByValue(0.7, min=-0.2),
                "norm_small": lambda: mod.ClipGradByNorm(1.0),
                "norm_large": lambda: mod.ClipGradByNorm(1e3),
                "global": lambda: mod.ClipGradByGlobalNorm(1.5)}[clip]()
    grads = [_rand(4, 6, seed=1), _rand(9, seed=2), _rand(3, 2, 2, seed=3)]
    want = build(jnn).clip_arrays([jnp.asarray(g) for g in grads] + [None])
    tclip = build(tnn)
    got = tclip.clip_arrays([torch.from_numpy(g) for g in grads] + [None])
    assert got[-1] is None and want[-1] is None
    for a, b in zip(want[:-1], got[:-1]):
        _close(b.numpy(), a)
    # the pair form leaves need_clip=False parameters untouched
    params = [torch.nn.Parameter(torch.zeros(1)) for _ in grads]
    params[0].need_clip = False
    pairs = tclip(list(zip(params, [torch.from_numpy(g) for g in grads])))
    assert torch.equal(pairs[0][1], torch.from_numpy(grads[0]))
    if clip != "global":  # the others clip each gradient alone
        _close(pairs[1][1].numpy(), want[1])


def test_clip_grad_norm_and_clip_by_norm_match_reference():
    arrays = [_rand(4, 6, seed=4) * 3, _rand(5, seed=5)]
    jps, tps = _params(jopt, arrays, ["a", "b"]), _params(topt, arrays, ["a", "b"])
    _set_grads(jps, arrays)
    _set_grads(tps, arrays)
    jtotal = jnn.clip_grad_norm_(jps, 2.0)
    ttotal = tnn.clip_grad_norm_(tps, 2.0)
    _close(ttotal.numpy(), jtotal.numpy())
    for jp, tp in zip(jps, tps):
        _close(tp.grad.numpy(), np.asarray(jp._grad))
    assert float(tnn.clip_grad_norm_([torch.nn.Parameter(torch.zeros(2))], 1.0)) == 0.0
    with pytest.raises(NotImplementedError):
        tnn.clip_grad_norm_(tps, 2.0, norm_type=1.0)
    for max_norm in (0.5, 100.0):
        x = _rand(3, 5, seed=6)
        want = jnn.clip_by_norm(paddle.to_tensor(x), max_norm).numpy()
        _close(tnn.clip_by_norm(torch.from_numpy(x), max_norm).numpy(), want)


# ------------------------------------------------------------------ shells


def _decay(name):
    return not name.startswith("b")


def test_optimizer_on_a_scheduler_steps_eagerly_like_the_reference():
    """AdamW on LinearWarmup(CosineAnnealingDecay) with a global-norm clip
    and ``apply_decay_param_fun``: eager ``step()``s with the scheduler
    stepped after each, then a state_dict round trip into a fresh
    optimizer that carries on as the reference does."""
    arrays = [_rand(6, 4, seed=1), _rand(4, seed=2)]
    names = ["w", "b"]
    opts, params = {}, {}
    for mod, lr_mod, nn_mod in ((jopt, jlr, jnn), (topt, tlr, tnn)):
        ps = _params(mod, arrays, names)
        opts[mod] = mod.AdamW(_warm_cosine(lr_mod), parameters=ps, weight_decay=0.05,
                              apply_decay_param_fun=_decay,
                              grad_clip=nn_mod.ClipGradByGlobalNorm(0.5))
        params[mod] = ps

    def run(steps, seed0):
        for step in range(steps):
            grads = [_rand(*a.shape, seed=seed0 + 2 * step + i) * 3
                     for i, a in enumerate(arrays)]
            assert opts[topt].get_lr() == opts[jopt].get_lr()
            for mod in (jopt, topt):
                _set_grads(params[mod], grads)
                opts[mod].step()
                opts[mod]._learning_rate.step()
    run(4, 30)
    sd = opts[topt].state_dict()
    jsd = opts[jopt].state_dict()
    assert sd["step_count"] == jsd["step_count"] == 4
    assert sd["LR_Scheduler"] == jsd["LR_Scheduler"]
    for n in names:
        for a, b in zip(sd["accumulators"][n], jsd["accumulators"][n]):
            _close(a.numpy(), b)
    # a fresh optimizer over the same parameters picks up where it stopped
    fresh = topt.AdamW(_warm_cosine(tlr), parameters=params[topt], weight_decay=0.05,
                       apply_decay_param_fun=_decay,
                       grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    fresh.set_state_dict(sd)
    assert fresh.get_lr() == opts[topt].get_lr() and fresh._step_count == 4
    opts[topt] = fresh
    run(3, 60)
    for jp, tp, n in zip(params[jopt], params[topt], names):
        _close(_value(tp), _value(jp), err_msg=n)


def test_set_lr_and_minimize_match_reference():
    """``minimize(loss)`` on the eager shell is backward, then step;
    ``set_lr`` replaces the rate, ``set_lr_scheduler`` the scheduler."""
    w = _rand(3, 2, seed=7)
    x = _rand(4, 3, seed=8)
    jw = _params(jopt, [w], ["w"])
    tw = _params(topt, [w], ["w"])
    jo = jopt.Momentum(0.1, parameters=jw)
    to = topt.Momentum(0.1, parameters=tw)
    for lr in (0.1, 0.02):
        jo.set_lr(lr)
        to.set_lr(lr)
        jloss = (paddle.matmul(paddle.to_tensor(x), jw[0]) ** 2).sum()
        tloss = (torch.from_numpy(x) @ tw[0]).square().sum()
        jo.minimize(jloss)
        to.minimize(tloss)
        jo.clear_grad()
        to.clear_grad()
        _close(_value(tw[0]), _value(jw[0]))
    to.set_lr_scheduler(tlr.StepDecay(0.5, step_size=2))
    assert to.get_lr() == 0.5 and to._lr_scheduler is not None


def test_apply_gradients_arrays_match_reference():
    """The pure dict form the training step mirrors: clip, then the L1 term
    and ``_update`` with the hypers for no parameter."""
    ps = {"a": _rand(3, 4, seed=1), "b": _rand(4, seed=2)}
    grads = {n: _rand(*a.shape, seed=9 + i) for i, (n, a) in enumerate(ps.items())}
    jo = jopt.RMSProp(0.01, parameters=[], weight_decay=jreg.L1Decay(0.02),
                      grad_clip=jnn.ClipGradByValue(0.8))
    to = topt.RMSProp(0.01, parameters=[], weight_decay=treg.L1Decay(0.02),
                      grad_clip=tnn.ClipGradByValue(0.8))
    jp = {n: jnp.asarray(a) for n, a in ps.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in ps.items()}
    js, ts = jo.init_state_arrays(jp), to.init_state_arrays(tp)
    for _ in range(2):
        jp, js = jo.apply_gradients_arrays(jp, {n: jnp.asarray(g) for n, g in grads.items()},
                                           js)
        tp, ts = to.apply_gradients_arrays(tp, {n: torch.from_numpy(g)
                                                for n, g in grads.items()}, ts)
    for n in ps:
        _close(tp[n].numpy(), jp[n], err_msg=n)
