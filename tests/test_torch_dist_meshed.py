"""Meshed training in the port against the JAX package: ZeRO stages 1-3
(``build_train_step(sharding_stage=...)``) at ``dp=1, sharding=2`` (two
gloo ranks) and ``dp=2, sharding=2`` (four), ``build_fsdp_train_step``,
``comm_opt``'s fp16 all-reduce, DGC, LocalSGD and adaptive LocalSGD,
BatchNorm over a data mesh and ``sharding.group_sharded_parallel``. The
ranks run tests/torch_dist_meshed_worker.py through the port's launcher
on the CPU (one spawn for each world size, with its own timeout); the
references run here, the JAX package's Pallas kernels in interpret mode
(``_use_pallas`` patched, ``pallas_attention_min_seq`` 0) so both sides
drop by the kernel's hash. A rank's state is gathered with
``convert.from_rank_states`` (or cut with ``to_rank_state``) to meet the
reference's global arrays.

Tolerances, each with its reason:
- losses: the reference's own two-process tolerance (rtol 2e-5, atol
  1e-6, tests/test_distributed.py), as tests/test_torch_dist_train.py;
- the first step's clipped gradients (AdamW's first moment / (1 - beta1))
  within 1e-4 of each tensor's max plus 1e-8, and the parameters after
  three steps within 2.5 * lr: tests/test_torch_train.py's one-device
  bounds, which tests/test_torch_dist_train.py holds the dp mesh to (the
  sums run in other orders: the ranks' all-reduce and reduce-scatter
  against XLA's);
- the MLP's comm_opt modes (parameters, DGC's (u, v), the replicas, the
  losses) within 1e-6 absolute: float32 sums of two ranks against XLA's
  psum, an ulp or so at these magnitudes; fp16's within 1e-3 of the
  float32 mesh step, the reference's own bound for it
  (tests/test_comm_opt.py) at its loss scale; ``dgc_sparsify`` and the
  adaptive ``k`` trajectory exactly;
- BatchNorm's running statistics within 1e-5 (the reference's two-pass
  variance against the port's, each summed in its own order), its losses
  as BERT's, its parameters (three SGD steps at lr 0.1) within 1e-5;
- stage 1 against stage 0, the strategy's, ``shard_optimizer``'s and the
  tagged layer's stage against the stage's own run, offload against the
  resident run, the ranks' parameters against each other, and the eager
  ZeRO step against the unsharded eager step: bitwise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import comm_opt as jcomm
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.ops import attention as jattention
from paddle_tpu.text.models import BertForPretraining as JaxPretraining
from paddle_tpu_torch.convert import from_rank_states, to_rank_state
from paddle_tpu_torch.distributed import comm_opt as tcomm

import torch_dist_meshed_worker as M
import torch_dist_worker as W
from test_torch_dist_train import _JaxWrapper, _jax_loss

torch.set_num_threads(2)
SPAWN_TIMEOUT = 240  # seconds one spawn of ranks may take before its tests fail


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jtopology.build_mesh(**axes, devices=jax.devices()[:n])


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _pallas_interpret():
    saved = jattention._use_pallas
    jattention._use_pallas = lambda: True
    paddle.set_flags({"pallas_attention_min_seq": 0})
    return saved


def _restore(saved):
    paddle.set_flags({"pallas_attention_min_seq": 1024})
    jattention._use_pallas = saved


def _bert_reference(tmp):
    """The reference's ZeRO-3 mesh step over two devices on the global
    batch: losses, the first step's first moments, the final params."""
    paddle.seed(0)
    jw = _JaxWrapper(JaxPretraining(**W.BERT), W.SEQ)
    np.savez(tmp / "bert.npz", **{n: np.asarray(p.numpy()) for n, p in jw.named_parameters()})
    opt = jopt.AdamW(W.LR, parameters=jw.parameters(), weight_decay=0.01,
                     grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    mesh = _mesh(sharding=2)
    step, init = jspmd.build_train_step(jw, _jax_loss, opt, mesh=mesh, sharding_stage=3)
    params, st = init()
    x, y = (jspmd.shard_batch(a, mesh) for a in W.mesh_batch())
    losses = []
    for i in range(W.STEPS):
        loss, params, st = step(params, st, x, y, key=jax.random.fold_in(jax.random.PRNGKey(0), i))
        losses.append(float(loss))
        if i == 0:
            moments = {n: np.asarray(s[0]) for n, s in st.items()}
    return dict(losses=losses, moments=moments, params=_np(params), state=_np(st))


def _fsdp_reference(tmp):
    paddle.seed(3)
    f = M.FSDP
    seq = jnn.Sequential(jnn.Embedding(f["vocab"], f["d"]),
                         *[jnn.TransformerEncoderLayer(f["d"], f["heads"], f["ff"], dropout=0.1)
                           for _ in range(f["layers"])],
                         jnn.Linear(f["d"], f["vocab"]))
    np.savez(tmp / "fsdp.npz", **{n: np.asarray(p.numpy()) for n, p in seq.named_parameters()})
    opt = jopt.AdamW(W.LR, parameters=seq.parameters(), weight_decay=0.01,
                     grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    mesh = _mesh(dp=2)
    step, init = jspmd.build_fsdp_train_step(seq, _jax_loss, opt, mesh=mesh)
    params, st = init()
    x, y = (jspmd.shard_batch(a, mesh) for a in M.fsdp_batch())
    losses = []
    for i in range(W.STEPS):
        loss, params, st = step(params, st, x, y, key=jax.random.fold_in(jax.random.PRNGKey(0), i))
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params), state=_np(st))


def _comm_reference(tmp):
    """tests/test_comm_opt.py's MLP through each mode on a dp=2 mesh."""
    paddle.seed(7)
    m = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    np.savez(tmp / "mlp.npz", **{n: np.asarray(p.numpy()) for n, p in m.named_parameters()})
    weights = dict(np.load(tmp / "mlp.npz"))
    mesh = _mesh(dp=2)
    x, y = (jspmd.shard_batch(a, mesh) for a in M.mlp_data())
    out = {}
    strategies = {}
    for mode, knobs in (("localsgd", dict(localsgd=True, localsgd_configs={"k_steps": 2})),
                        ("adaptive", dict(adaptive_localsgd=True, adaptive_localsgd_configs={
                            "init_k_steps": 2, "begin_step": 2}))):
        s = JStrategy()
        for k, v in knobs.items():
            setattr(s, k, v)
        strategies[mode] = dict(strategy=s)
    modes = dict(base=dict(), fp16=dict(fp16_allreduce=True), dgc=dict(dgc_configs=dict(M.DGC)),
                 **strategies)
    for mode, kw in modes.items():
        m = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
        m.set_state_dict(weights)
        opt = jopt.SGD(0.2, parameters=m.parameters())
        step, init = jspmd.build_train_step(m, lambda o, t: jnp.mean((o - t) ** 2), opt,
                                            mesh=mesh, **kw)
        params, st = init()
        losses, ks, snaps = [], [], []
        for _ in range(M.COMM_STEPS.get(mode, M.COMM_STEPS["fp16"])):
            loss, params, st = step(params, st, x, y)
            losses.append(float(loss))
            snaps.append(_np(params))
            if mode == "adaptive":
                ks.append(int(step.comm_state["comm"]["k"]))
        out[mode] = dict(losses=losses, steps=snaps, k=ks, state=_np(st))
        if mode == "localsgd":
            out[mode]["avg"] = _np(jcomm.average_params(params))
    return out


def _conv_reference(tmp):
    paddle.seed(11)
    c = M.CONV
    m = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4), jnn.ReLU(),
                       jnn.AdaptiveAvgPool2D(1), jnn.Flatten(), jnn.Linear(4, c["classes"]))
    np.savez(tmp / "conv.npz", **{n: np.asarray(p.numpy()) for n, p in m.named_parameters()})
    opt = jopt.SGD(c["lr"], parameters=m.parameters())
    mesh = _mesh(dp=2)
    step, init = jspmd.build_train_step(m, _jax_loss, opt, mesh=mesh)
    params, st = init()
    x, y = (jspmd.shard_batch(a, mesh) for a in M.conv_batch())
    losses = []
    for i in range(W.STEPS):
        loss, params, st = step(params, st, x, y, key=jax.random.fold_in(jax.random.PRNGKey(0), i))
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params),
                buffers={n: np.asarray(b.numpy()) for n, b in m.named_buffers()})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshed_ref")
    saved_mesh = jtopology._GLOBAL_MESH
    saved = _pallas_interpret()
    try:
        out = dict(dir=tmp, bert=_bert_reference(tmp), fsdp=_fsdp_reference(tmp),
                   comm=_comm_reference(tmp), conv=_conv_reference(tmp))
    finally:
        _restore(saved)
        jtopology._GLOBAL_MESH = saved_mesh
    return out


def _spawn(mode, tmp, ref, nproc):
    rc, log = W.run_ranks(mode, tmp, ref["dir"], nproc=nproc, timeout=SPAWN_TIMEOUT,
                          worker=M.__file__)
    assert rc == 0, log[-6000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(nproc)]


@pytest.fixture(scope="module")
def meshed(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshed_ranks")
    return dict(ranks=_spawn("meshed", tmp, ref, 2), dir=tmp)


@pytest.fixture(scope="module")
def zero4(ref, tmp_path_factory):
    return _spawn("zero4", tmp_path_factory.mktemp("zero4_ranks"), ref, 4)


def _tree(rank, prefix):
    """{name: array or tuple of arrays} of the keys under ``prefix``."""
    out = {}
    for k, v in rank.items():
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        head, _, tail = name.rpartition("/")
        if head and tail.isdigit():
            lst = out.setdefault(head, [])
            lst.extend([None] * (int(tail) + 1 - len(lst)))
            lst[int(tail)] = v
        else:
            out[name] = v
    return {n: tuple(v) if isinstance(v, list) else v for n, v in out.items()}


def _hold_bert(ranks, run, ref, stage):
    world = len(ranks)
    for r in ranks:
        got = [float(r[f"{run}/loss{i}"]) for i in range(W.STEPS)]
        np.testing.assert_allclose(got, ref["losses"], rtol=2e-5, atol=1e-6, err_msg=run)
    moments = (from_rank_states([_tree(r, f"{run}/moment0/") for r in ranks], ref["params"])
               if stage >= 1 else _tree(ranks[0], f"{run}/moment0/"))
    for n, want in ref["moments"].items():
        np.testing.assert_allclose(moments[n] / 0.1, want / 0.1, rtol=0,
                                   atol=1e-4 * np.abs(want / 0.1).max() + 1e-8,
                                   err_msg=f"{run} {n}")
    params = [_tree(r, f"{run}/param/") for r in ranks]
    whole = from_rank_states(params, ref["params"]) if stage == 3 else params[0]
    assert set(whole) == set(ref["params"])
    for n, want in ref["params"].items():
        np.testing.assert_allclose(whole[n], want, rtol=0, atol=2.5 * W.LR, err_msg=f"{run} {n}")
    if stage < 3:
        for p in params[1:]:
            for n in p:
                np.testing.assert_array_equal(p[n], params[0][n], err_msg=f"{run} {n}")
    # a rank's blocks are its part of the reference's global arrays' layout
    if stage >= 1:
        state = [_tree(r, f"{run}/state/") for r in ranks]
        for rank, st in enumerate(state):
            want = to_rank_state(ref["state"], rank, world)
            for n, arrs in st.items():
                assert [a.shape for a in arrs] == [a.shape for a in want[n]], n


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stage_over_two_ranks_is_the_reference_mesh_step(ref, meshed, stage):
    _hold_bert(meshed["ranks"], f"s{stage}", ref["bert"], stage)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stage_over_four_ranks_is_the_reference_mesh_step(ref, zero4, stage):
    _hold_bert(zero4, f"s{stage}", ref["bert"], stage)


def test_zero_state_and_params_at_rest_are_the_ranks_blocks(meshed, zero4):
    """A rank holds about 1/N of the optimizer state (stages 1-3) and of
    the parameters (stage 3); the scalars and the tensors no N divides
    stay whole."""
    for ranks, n in ((meshed["ranks"], 2), (zero4, 4)):
        p0, s0 = ranks[0]["s0/bytes"]
        for stage in (1, 2, 3):
            for r in ranks:
                p, s = r[f"s{stage}/bytes"]
                assert s <= 0.51 * s0 * 2 / n, (stage, s, s0)
                assert p == p0 if stage < 3 else p <= 0.51 * p0 * 2 / n, (stage, p, p0)


@pytest.mark.parametrize("run,same", [("s1", "s0"), ("shard_optimizer", "s1"),
                                      ("strategy2", "s2"), ("tag3", "s3"), ("offload2", "s2")])
def test_zero_forms_are_bitwise_their_stage(meshed, run, same):
    """Stage 1 is bitwise stage 0 (a block's elementwise update is the
    block of the whole update); ``shard_optimizer``, a strategy's
    ``sharding_configs.stage``, a tagged layer and offload pick the same
    step as the stage itself."""
    for r in meshed["ranks"]:
        for i in range(W.STEPS):
            assert r[f"{run}/loss{i}"] == r[f"{same}/loss{i}"], (run, i)
        for k in r:
            if k.startswith(f"{same}/param/"):
                np.testing.assert_array_equal(r[k.replace(same, run, 1)], r[k], err_msg=k)


def test_fsdp_is_the_reference_fsdp_step_one_gathered_layer_at_a_time(ref, meshed):
    ranks, want = meshed["ranks"], ref["fsdp"]
    for r in ranks:
        got = [float(r[f"fsdp/loss{i}"]) for i in range(W.STEPS)]
        np.testing.assert_allclose(got, want["losses"], rtol=2e-5, atol=1e-6)
    params = from_rank_states([_tree(r, "fsdp/param/") for r in ranks], want["params"], "fsdp")
    assert set(params) == set(want["params"])
    assert any(n.startswith("trunk.") for n in params)
    for n, w in want["params"].items():
        np.testing.assert_allclose(params[n], w, rtol=0, atol=2.5 * W.LR, err_msg=n)
    for rank, r in enumerate(ranks):
        mine = _tree(r, "fsdp/param/")
        cut = to_rank_state(want["params"], rank, len(ranks), "fsdp")
        assert {n: a.shape for n, a in mine.items()} == {n: a.shape for n, a in cut.items()}
        # recompute: one gathered trunk layer at a time, none left after
        # the step; without it, every layer's stays alive for the backward
        assert list(r["fsdp/peaks"]) == [1, 1, 1, 0], r["fsdp/peaks"]
        assert list(r["fsdp_plain/peaks"])[:3] == [M.FSDP["layers"]] * 3


@pytest.mark.parametrize("mode", ["fp16", "dgc", "localsgd", "adaptive"])
def test_comm_mode_is_the_reference_rank_by_rank(ref, meshed, mode):
    want = ref["comm"][mode]
    ranks = meshed["ranks"]
    for rank, r in enumerate(ranks):
        got = [float(r[f"{mode}/loss{i}"]) for i in range(M.COMM_STEPS[mode])]
        np.testing.assert_allclose(got, want["losses"], rtol=0, atol=1e-6)
        for i, snap in enumerate(want["steps"]):
            mine = _tree(r, f"{mode}/step{i}/")
            rows = (to_rank_state(snap, rank, len(ranks), "rows")
                    if mode in ("localsgd", "adaptive") else snap)
            for n, w in rows.items():
                np.testing.assert_allclose(mine[n], w, rtol=0, atol=1e-6, err_msg=f"{i} {n}")
    if mode in ("fp16", "dgc"):  # the same update on every rank
        for k in ranks[0]:
            if k.startswith(f"{mode}/step"):
                np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    if mode == "fp16":
        base = ref["comm"]["base"]["losses"]
        np.testing.assert_allclose(want["losses"], base, rtol=0.02, atol=1e-3)
        np.testing.assert_allclose([float(ranks[0][f"fp16/loss{i}"]) for i in range(4)],
                                   base, rtol=0, atol=1e-3)
        f16, f32 = ranks[0]["fp16/comm_bytes"]
        assert f16 == 2 * sum(a.size for a in want["steps"][0].values()) and f32 == 4, (f16, f32)
    if mode == "dgc":
        comm = [_tree(r, "dgc/comm/") for r in ranks]
        for rank, c in enumerate(comm):
            rows = to_rank_state(want["state"]["__comm__"], rank, len(ranks), "rows")
            for n, (u, v) in c.items():
                np.testing.assert_allclose(u, rows[n][0], rtol=0, atol=1e-6, err_msg=n)
                np.testing.assert_allclose(v, rows[n][1], rtol=0, atol=1e-6, err_msg=n)
        assert any(not np.array_equal(comm[0][n][1], comm[1][n][1]) for n in comm[0])
    if mode == "adaptive":
        for r in ranks:
            assert list(r["adaptive/k"]) == want["k"], (list(r["adaptive/k"]), want["k"])
    if mode == "localsgd":
        # between syncs (k_steps 2: after steps 0 and 2) the replicas
        # differ; after a sync (steps 1 and 3) they are bitwise equal
        for i in range(M.COMM_STEPS["localsgd"]):
            a, b = (_tree(r, f"localsgd/step{i}/") for r in ranks)
            same = all(np.array_equal(a[n], b[n]) for n in a)
            assert same == (i % 2 == 1), i
        for n, w in want["avg"].items():
            np.testing.assert_allclose(ranks[0][f"localsgd/avg/{n}"], w, rtol=0, atol=1e-6)


def test_dgc_sparsify_is_bitwise_the_reference():
    rng = np.random.RandomState(4)
    for shape, sparsity in (((64, 16), 0.999), ((37,), 0.8), ((4, 5, 6), 0.5)):
        g, u, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
        want = jcomm.dgc_sparsify(*(jnp.asarray(a) for a in (g, u, v)), momentum=0.9,
                                  sparsity=sparsity)
        got = tcomm.dgc_sparsify(*(torch.from_numpy(a) for a in (g, u, v)), 0.9, sparsity)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(NotImplementedError, match="never reads"):
        tcomm.dgc_settings({"rampup_begin_step": 5})


def test_batch_norm_over_the_mesh_takes_the_global_batch_statistics(ref, meshed):
    want = ref["conv"]
    for r in meshed["ranks"]:
        got = [float(r[f"bn/loss{i}"]) for i in range(W.STEPS)]
        np.testing.assert_allclose(got, want["losses"], rtol=2e-5, atol=1e-6)
        for n, w in want["buffers"].items():
            np.testing.assert_allclose(r[f"bn/buffer/{n}"], w, rtol=0, atol=1e-5, err_msg=n)
        for n, w in want["params"].items():
            np.testing.assert_allclose(r[f"bn/param/{n}"], w, rtol=0, atol=1e-5, err_msg=n)
    a, b = meshed["ranks"]
    for k in a:
        if k.startswith("bn/"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_group_sharded_eager_step_is_bitwise_the_unsharded_one(meshed):
    for r in meshed["ranks"]:
        for k in r:
            if k.startswith("eager_plain/step"):
                np.testing.assert_array_equal(r[k.replace("plain", "sharded", 1)], r[k],
                                              err_msg=k)
        assert r["eager_sharded/acc_bytes"] <= 0.51 * r["eager_plain/acc_bytes"]
        assert list(r["eager_sharded/stage"]) == [2, 2]
        # the gathered state_dict is the unsharded one's
        for k in r:
            if k.startswith("eager_plain/opt/"):
                np.testing.assert_array_equal(r[k.replace("plain", "sharded", 1)], r[k],
                                              err_msg=k)


def test_save_group_sharded_model_loads_in_both_packages(meshed):
    import paddle_tpu_torch as tp

    prefix = str(meshed["dir"] / "gsm")
    r = meshed["ranks"][0]
    for load in (paddle.load, lambda path: tp.load(path, return_numpy=True)):
        opt = load(prefix + ".pdopt")
        accs = opt["accumulators"]
        assert accs, opt
        for j, (name, arrs) in enumerate(accs.items()):
            for i, a in enumerate(arrs):
                np.testing.assert_array_equal(np.asarray(getattr(a, "_value", a)),
                                              r[f"eager_plain/opt/{j}/{i}"], err_msg=name)
        params = load(prefix + ".pdparams")
        for n, p in params.items():
            np.testing.assert_array_equal(
                np.asarray(getattr(p, "_value", p)),
                r[f"eager_sharded/step{M.EAGER_STEPS - 1}/{n}"])
    # the reference's optimizer takes the file (by position: its
    # parameters' names are its own)
    m = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    o = jopt.AdamW(0.01, parameters=m.parameters())
    saved = paddle.load(prefix + ".pdopt")
    o.set_state_dict(saved)
    got = o.state_dict()["accumulators"]
    assert len(got) == len(saved["accumulators"]) == 4
    for want, have in zip(saved["accumulators"].values(), got.values()):
        for a, b in zip(want, have):
            np.testing.assert_array_equal(np.asarray(getattr(a, "_value", a)), b)
