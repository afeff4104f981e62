"""The model-parallel tier's pieces that need no ranks, against the JAX
package: ``SegmentLayers`` (uniform, "layer:<Class>", "param", a
tail-heavy model, too few marked layers), ``PipelineLayer``,
``schedule_stats``, the ``RNGStatesTracker`` keys (bitwise), and
``PipelineParallel.train_batch``'s sequential path, with the reference's
loud warning where a pp mesh meets a trunk it cannot split.

Tolerances: the segmentations, the schedule and the keys exactly; the
forward of a ``PipelineLayer`` within 1e-6 (float32 products); the
sequential path's losses and parameters after three SGD steps within 1e-6
(one eager step each side, float32 sums in other orders).
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import random as jrandom
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.meta_parallel import mp_layers as jmp
from paddle_tpu.distributed.meta_parallel import pipeline_parallel as jpp
from paddle_tpu.distributed.meta_parallel import pp_layers as jpl
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.distributed import topology as ttopology
from paddle_tpu_torch.distributed.meta_parallel import mp_layers as tmp
from paddle_tpu_torch.distributed.meta_parallel import pipeline_parallel as tpp
from paddle_tpu_torch.distributed.meta_parallel import pp_layers as tpl

torch.set_num_threads(1)


@pytest.fixture
def cpu_place():
    saved = tp.core.place._CURRENT
    tp.set_device("cpu")
    yield
    tp.core.place._CURRENT = saved


def _descs(pkg, nn, widths):
    """LayerDescs of Linear layers of the given widths, every third one a
    Tanh (an unmarked, parameterless layer)."""
    out = []
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        kw = dict(device="cpu") if pkg == "torch" else {}
        out.append(pkg_desc(pkg)(nn.Linear, a, b, **kw))
        if i % 3 == 2:
            out.append(pkg_desc(pkg)(nn.Tanh))
    return out


def pkg_desc(pkg):
    return tpl.LayerDesc if pkg == "torch" else jpl.LayerDesc


@pytest.mark.parametrize("method,widths,parts", [
    ("uniform", [4] * 8, 2), ("uniform", [4] * 11, 4), ("layer:Linear", [4] * 8, 3),
    ("layer:Tanh", [4] * 11, 3), ("param", [4, 8, 8, 8, 8, 4], 2),
    ("param", [4, 4, 4, 4, 4, 64, 64], 3),  # tail-heavy: no stage may be empty
    ("param", [2, 2, 2, 2, 2], 4)])
def test_segment_layers_are_the_reference(method, widths, parts):
    got = tpl.SegmentLayers(_descs("torch", tnn, widths), parts, method).do_segment()
    want = jpl.SegmentLayers(_descs("jax", jnn, widths), parts, method).do_segment()
    assert got == want
    assert len(got) == parts + 1 and all(b > a for a, b in zip(got, got[1:]))


def test_segment_layers_refuses_too_few_marked_layers():
    for pl, nn, pkg in ((tpl, tnn, "torch"), (jpl, jnn, "jax")):
        with pytest.raises(ValueError, match="cannot fill"):
            pl.SegmentLayers(_descs(pkg, nn, [4] * 5), 3, "layer:Tanh").do_segment()
        with pytest.raises(ValueError):
            pl.SegmentLayers(_descs(pkg, nn, [4] * 5), 2, "nope").do_segment()


def test_pipeline_layer_is_the_reference(cpu_place):
    tlayers = [tpl.LayerDesc(tnn.Linear, 4, 6, device="cpu"), tnn.Tanh(),
               tpl.LayerDesc(tnn.Linear, 6, 6, device="cpu"), lambda x: x * 2,
               tpl.LayerDesc(tnn.Linear, 6, 3, device="cpu")]
    jlayers = [jpl.LayerDesc(jnn.Linear, 4, 6), jnn.Tanh(), jpl.LayerDesc(jnn.Linear, 6, 6),
               lambda x: x * 2, jpl.LayerDesc(jnn.Linear, 6, 3)]
    tm = tpl.PipelineLayer(tlayers, num_stages=2)
    jm = jpl.PipelineLayer(jlayers, num_stages=2)
    assert tm.segment_parts == jm.segment_parts
    assert [tm.get_stage_from_index(i) for i in range(6)] == \
        [jm.get_stage_from_index(i) for i in range(6)]
    assert [len(tm.stage_layers(s)) for s in range(2)] == [len(jm.stage_layers(s))
                                                            for s in range(2)]
    jm.set_state_dict({n: p.detach().numpy() for n, p in tm.named_parameters()})
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(paddle.to_tensor(x)).numpy()), rtol=0, atol=1e-6)
    topo = ttopology.CommunicateTopology(dims=(1, 2, 1, 1))
    assert tpl.PipelineLayer(tlayers[:1] * 2, topology=topo)._num_stages == 2


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 4), (4, 4), (4, 8), (3, 5)])
def test_schedule_stats_are_the_reference(stages, micro):
    assert tpipe.schedule_stats(stages, micro) == jpipe.schedule_stats(stages, micro)


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)).reshape(-1)) \
        if not isinstance(key, tuple) else tuple(int(w) for w in trandom.key_data(key))


def test_rng_states_tracker_keys_are_the_reference():
    t, j = tmp.RNGStatesTracker(), jmp.RNGStatesTracker()
    for tr in (t, j):
        tr.add("global_seed", 1234)
        tr.add("model_parallel_rng", 1234 + 1024)
    for name in ("model_parallel_rng", "global_seed", "model_parallel_rng"):
        with t.rng_state(name):
            got = [trandom.next_key() for _ in range(2)]
        with j.rng_state(name):
            want = [jrandom.next_key() for _ in range(2)]
        assert [_words(k) for k in got] == [_words(k) for k in want], name
    assert {n: _words(k) for n, k in t.get_states_tracker().items()} == \
        {n: _words(k) for n, k in j.get_states_tracker().items()}
    for tr in (t, j):
        with pytest.raises(ValueError, match="already exists"):
            tr.add("other", 1234)
    tmp.model_parallel_random_seed(77)
    jmp.model_parallel_random_seed(77)
    assert {n: _words(k) for n, k in tmp.get_rng_state_tracker().get_states_tracker().items()} \
        == {n: _words(k) for n, k in jmp.get_rng_state_tracker().get_states_tracker().items()}


class _Strategy:
    pipeline_configs = {"accumulate_steps": 2}
    amp = False


def _sequential_run(pkg, pp, seed_state=None):
    """Three train_batch calls of a PipelineLayer whose layers differ in
    shape (no homogeneous trunk) over a mesh of ``pp`` stages."""
    rng = np.random.RandomState(2)
    x, y = rng.randn(6, 4).astype(np.float32), rng.randn(6, 3).astype(np.float32)
    if pkg == "torch":
        layers = [tnn.Linear(4, 8, device="cpu"), tnn.Tanh(), tnn.Linear(8, 6, device="cpu"),
                  tnn.Linear(6, 3, device="cpu")]
        model = tpl.PipelineLayer(layers, num_stages=1, loss_fn=tnn.MSELoss())
        wrapped = tpp.PipelineParallel(model, strategy=_Strategy())
        ttopology.set_global_mesh(ttopology.Mesh((1, pp, 1, 1, 1, 1)))
        opt = topt.SGD(0.1, parameters=model.parameters())
        feed = [tp.to_tensor(a, place=tp.CPUPlace()) for a in (x, y)]
    else:
        layers = [jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 6), jnn.Linear(6, 3)]
        model = jpl.PipelineLayer(layers, num_stages=1, loss_fn=jnn.MSELoss())
        model.set_state_dict(seed_state)
        wrapped = jpp.PipelineParallel(model, strategy=_Strategy())
        jtopology.set_global_mesh(jtopology.build_mesh(pp=pp, devices=jax.devices()[:pp]))
        opt = jopt.SGD(0.1, parameters=model.parameters())
        feed = [paddle.to_tensor(a) for a in (x, y)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses = [float(wrapped.train_batch(feed, opt)) for _ in range(3)]
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and "FALLING BACK" in str(w.message)]
    state = {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}
    return losses, state, len(warned)


@pytest.mark.parametrize("pp", [1, 2])
def test_pipeline_parallel_sequential_path_is_the_reference(pp):
    saved = (ttopology._GLOBAL_MESH, jtopology._GLOBAL_MESH)
    try:
        tp.seed(4)
        got, state, t_warned = _sequential_run("torch", pp)
        want, jstate, j_warned = _sequential_run("jax", pp, dict(_sequential_run_init()))
    finally:
        ttopology._GLOBAL_MESH, jtopology._GLOBAL_MESH = saved
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for n, w in jstate.items():
        np.testing.assert_allclose(state[n], w, rtol=0, atol=1e-6, err_msg=n)
    # a pp mesh with no trunk to split warns loudly, once (the step is cached)
    assert t_warned == j_warned == (1 if pp == 2 else 0)


def _sequential_run_init():
    tp.seed(4)
    layers = [tnn.Linear(4, 8, device="cpu"), tnn.Tanh(), tnn.Linear(8, 6, device="cpu"),
              tnn.Linear(6, 3, device="cpu")]
    model = tpl.PipelineLayer(layers, num_stages=1)
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def test_pipeline_parallel_eval_batch_and_model_parallel(cpu_place):
    layers = [tnn.Linear(4, 3, device="cpu")]
    model = tpl.PipelineLayer(layers, num_stages=1, loss_fn=tnn.MSELoss())
    wrapped = tpp.PipelineParallel(model)
    x, y = torch.ones(2, 4), torch.zeros(2, 3)
    want = ((layers[0](x) - y) ** 2).mean()
    torch.testing.assert_close(wrapped.eval_batch((x, y)), want)
    torch.testing.assert_close(wrapped.eval_batch((x, y), compute_loss=False), layers[0](x))
    from paddle_tpu_torch.distributed.meta_parallel import ModelParallel

    torch.testing.assert_close(ModelParallel(layers[0])(x), layers[0](x))


def test_pipeline_spmd_fn_on_one_stage():
    """The forward primitive with one stage: each microbatch through
    ``stage_apply``, as the reference's."""
    saved = ttopology._GLOBAL_MESH
    ttopology.set_global_mesh(ttopology.Mesh((1,) * 6))
    try:
        body = tpp.pipeline_spmd_fn(lambda p, x: x @ p["w"], 1, 3)
        w = torch.arange(9.0).reshape(1, 3, 3)
        micro = torch.arange(18.0).reshape(3, 2, 3)
        jbody = jpp.pipeline_spmd_fn(lambda p, x: x @ p["w"], 1, 3)
        assert jbody is not None
        torch.testing.assert_close(body({"w": w}, micro), micro @ w[0])
    finally:
        ttopology._GLOBAL_MESH = saved
