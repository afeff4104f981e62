"""Model parallelism in the port against the JAX package: the mp layers and
``distributed.split``, ``LlamaModel(tensor_parallel=True)`` through
``build_train_step`` at mp=2, at mp=4 with ``num_kv_heads=2`` (a KV head
split over two ranks) and at ``sharding=2, mp=2`` (ZeRO-2),
``broadcast_mp_parameters``, and the pipeline step at pp=2 (plain,
``recompute=True``, amp O1, a dropout trunk), pp=4, dp2 x pp2, pp2 x mp2,
pp2 x sp2 (ring attention blocks) and ``fleet.distributed_model(...)
.train_batch``. The ranks run tests/torch_dist_model_parallel_worker.py
through the port's launcher over gloo on the CPU (one spawn a world size,
started before the references are computed, each with its own timeout);
the references run here on the JAX package's 8-device CPU mesh and on one
device, with the weights the ranks made. A rank's blocks are gathered with
``convert.from_rank_states`` (layouts "mp", "pp", "zero").

Tolerances, each with its reason:
- losses: the reference's own mp/pp tolerance (rtol 2e-4, atol 2e-5,
  tests/test_llama_hybrid.py), against both its one-device step and its
  mesh step: the ranks sum the row-parallel products and the gradients in
  other orders than XLA;
- the Llama's gathered parameters after three AdamW steps within 2.5 * lr
  (tests/test_torch_train.py's one-device bound), and so the Adam
  pipelines': Adam divides a gradient by its own root mean square, so a
  gradient that is float noise around 0 (an attention key's bias, which
  the softmax cancels) moves its parameter by up to lr a step in either
  package; the SGD pipelines' within 1e-5 absolute, float32 sums in other
  orders; the moments of the dp2 x pp2 Adam state within 1e-5 of each
  tensor's largest;
- amp O1 (float16, as the reference's CPU test, whose bf16 trips XLA-CPU)
  loosely, rtol and atol 5e-2 against the float32 run
  (tests/test_pipeline_schedule.py:211);
- the replicated parameters of the mp ranks, the pp ranks' pre/post and
  losses, ``recompute`` against the plain pipeline and ``train_batch``
  against the step it drives: bitwise.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import collective as jcollective
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.meta_parallel import ColumnParallelLinear as JCol
from paddle_tpu.distributed.meta_parallel import RowParallelLinear as JRow
from paddle_tpu.distributed.meta_parallel import VocabParallelEmbedding as JVocab
from paddle_tpu.ops import ring_attention as jra
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch.convert import from_rank_states, to_rank_state

import torch_dist_model_parallel_worker as M
import torch_dist_worker as W

torch.set_num_threads(2)
SPAWN_TIMEOUT = 240  # seconds one spawn of ranks may take before its tests fail
RTOL, ATOL = 2e-4, 2e-5
ADAM_ATOL = 2.5 * 1e-2  # the Adam pipelines' parameters: 2.5 * lr (see the docstring)


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jtopology.build_mesh(**axes, devices=jax.devices()[:n])


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jax_lm_loss(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0])


def _jax_mse(o, t):
    return jnp.mean((o - t) ** 2)


def _load(layers, state):
    for i, l in enumerate(layers):
        l.set_state_dict({n[len(f"{i}."):]: a for n, a in state.items()
                          if n.startswith(f"{i}.")})


# ------------------------------------------------------- the JAX twins


class JHead(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.norm = jmodels.RMSNorm(32)
        self.head = jnn.Linear(32, 64, bias_attr=False)

    def forward(self, x):
        return self.head(self.norm(x))


class JTPBlock(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.col = JCol(16, 32, has_bias=True, gather_output=False)
        self.row = JRow(32, 16, input_is_parallel=True)

    def forward(self, x):
        return x + self.row(paddle.tanh(self.col(x)))


class JRingBlock(jnn.Layer):
    def __init__(self, hidden=16, heads=2):
        super().__init__()
        self.heads = heads
        self.qkv = jnn.Linear(hidden, 3 * hidden)
        self.out = jnn.Linear(hidden, hidden)

    def forward(self, x):
        import paddle_tpu.tensor as pt
        from paddle_tpu.core.tensor import Tensor

        b, s, h = x.shape
        d = h // self.heads
        q, k, v = pt.split(self.qkv(x), 3, axis=-1)

        def hsplit(t):
            return pt.transpose(pt.reshape(t, [b, s, self.heads, d]), [0, 2, 1, 3])

        att = jra.ring_attention_in_shard_map(hsplit(q)._value, hsplit(k)._value,
                                              hsplit(v)._value, causal=True)
        return x + self.out(pt.reshape(pt.transpose(Tensor(att), [0, 2, 1, 3]), [b, s, h]))


class JDropBlock(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(16, 16)
        self.drop = jnn.Dropout(0.3)

    def forward(self, x):
        return paddle.tanh(self.drop(self.fc(x)))


def _jax_pipe_layers(kind):
    if kind == "llama":
        port = M.llama_pipe_layers()
        layers = ([jnn.Embedding(64, 32)],
                  [jmodels.LlamaDecoderLayer(32, 4, 64, 2) for _ in range(4)], [JHead()])
    else:
        port = M.small_pipe_layers(kind)
        block = dict(tp=JTPBlock, ring=JRingBlock, drop=JDropBlock)[kind]
        layers = ([jnn.Linear(8, 16)], [block() for _ in range(4)], [jnn.Linear(16, 4)])
    for j, p in zip(layers, port):
        _load(j, M.numpy_state(p))
    return layers


def _jax_pipe(kind, mesh, data, opt_cls, lr, steps, loss_fn=_jax_mse, **kw):
    pre, trunk, post = _jax_pipe_layers(kind)
    jtopology.set_global_mesh(mesh)
    opt = opt_cls(lr, parameters=[p for l in pre + trunk + post for p in l.parameters()])
    step, init = jpipe.build_pipeline_train_step(pre, trunk, post, loss_fn, opt, mesh=mesh,
                                                 num_micro=2, donate=False, **kw)
    params, st = init()
    losses = []
    for _ in range(steps):
        loss, params, st = step(params, st, *data, key=jax.random.PRNGKey(0))
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params), state=_np(st))


def _jax_llama(mesh, kv_heads, tensor_parallel, **kw):
    jtopology.set_global_mesh(mesh)
    model = jmodels.LlamaModel(**dict(M.LLAMA, num_kv_heads=kv_heads),
                               tensor_parallel=tensor_parallel)
    model.set_state_dict(M.numpy_state(M.llama_model(kv_heads)))
    opt = jopt.AdamW(M.LLAMA_LR, parameters=model.parameters(), weight_decay=0.01,
                     grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    step, init = jspmd.build_train_step(model, _jax_lm_loss, opt, mesh=mesh, **kw)
    params, st = init()
    x, y = M.llama_batch()
    losses = []
    for _ in range(M.LLAMA_STEPS):
        loss, params, st = step(params, st, x, y, key=jax.random.PRNGKey(9))
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params), state=_np(st))


def _jax_mp_layers(mesh):
    jtopology.set_global_mesh(mesh)
    m = jnn.Sequential(JVocab(16, 8), JCol(8, 12, has_bias=True, gather_output=False),
                       jnn.Tanh(), JRow(12, 8, input_is_parallel=True),
                       JCol(8, 6, has_bias=True, gather_output=True))
    m.set_state_dict(M.numpy_state(M.mp_layers_model()))
    opt = jopt.SGD(0.1, parameters=m.parameters())
    step, init = jspmd.build_train_step(m, _jax_mse, opt, mesh=mesh)
    params, st = init()
    ids, y = M.mp_layers_data()
    losses = []
    for _ in range(2):
        loss, params, st = step(params, st, ids, y)
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params))


def _jax_split(r0):
    """The reference's ``split`` layers with the ranks' weights, on the
    same inputs (eagerly its layers' weights lie on one device, so its
    global mesh is that device's)."""
    jtopology.set_global_mesh(_mesh(dp=1))
    ids, _ = M.mp_layers_data()
    x = np.random.RandomState(6).randn(3, 8).astype(np.float32)
    out = {}
    for name, size, op, axis in (("col", (8, 6), "linear", 1), ("row", (8, 6), "linear", 0),
                                 ("emb", (16, 8), "embedding", 0)):
        inp = paddle.to_tensor(ids[:, :3] if op == "embedding" else x)
        key = f"torch_split_{name}"
        jcollective._SPLIT_LAYERS.pop(key, None)
        jcollective.split(inp, size, op, axis=axis, name=key)
        layer = jcollective._SPLIT_LAYERS.pop(key)
        prefix = f"split/{name}/param/"
        layer.set_state_dict({k[len(prefix):]: v for k, v in r0.items() if k.startswith(prefix)})
        out[name] = np.asarray(layer(inp).numpy())
    return out


def _references(ranks):
    saved = jtopology._GLOBAL_MESH
    try:
        ids, labels = M.llama_batch()
        one = _mesh(dp=1)
        ref = dict(
            layers_one=_jax_mp_layers(one), layers_mesh=_jax_mp_layers(_mesh(mp=2)),
            llama_one=_jax_llama(one, 2, False), llama_mp2=_jax_llama(_mesh(mp=2), 2, True),
            llama_mp4=_jax_llama(_mesh(mp=4), 2, True),
            llama_mp2sh2=_jax_llama(_mesh(sharding=2, mp=2), 2, True, sharding_stage=2),
            pipe_llama=_jax_pipe("llama", one, (ids, labels), jopt.SGD, 0.1, M.PIPE_STEPS,
                                 loss_fn=_jax_lm_loss),
            pipe_llama_pp2=_jax_pipe("llama", _mesh(pp=2), (ids, labels), jopt.SGD, 0.1,
                                     M.PIPE_STEPS, loss_fn=_jax_lm_loss),
            pipe_llama_o1=_jax_pipe("llama", one, (ids, labels), jopt.SGD, 0.1, M.PIPE_STEPS,
                                    loss_fn=_jax_lm_loss, amp_level="O1",
                                    amp_dtype="float16"),
            pipe_llama_adam=_jax_pipe("llama", one, (ids, labels), jopt.Adam, 1e-2,
                                      M.PIPE_STEPS, loss_fn=_jax_lm_loss),
            pipe_drop=_jax_pipe("drop", _mesh(pp=2), M.small_pipe_data("drop"), jopt.SGD, 0.1,
                                M.PIPE_STEPS),
            pipe_tp=_jax_pipe("tp", one, M.small_pipe_data("tp"), jopt.SGD, 0.01,
                              M.PIPE_STEPS),
            pipe_tp_mesh=_jax_pipe("tp", _mesh(pp=2, mp=2), M.small_pipe_data("tp"), jopt.SGD,
                                   0.01, M.PIPE_STEPS),
            pipe_ring=_jax_pipe("ring", one, M.small_pipe_data("ring"), jopt.Adam, 1e-2, 3),
            pipe_ring_mesh=_jax_pipe("ring", _mesh(pp=2, sp=2), M.small_pipe_data("ring"),
                                     jopt.Adam, 1e-2, 3),
            pipe_ring_rank1=_jax_pipe(
                "ring", one, (M.small_pipe_data("ring")[0],
                              np.random.RandomState(1).randn(4).astype(np.float32)),
                jopt.Adam, 1e-2, 1,
                loss_fn=lambda o, t: jnp.mean((jnp.mean(o, axis=1)[:, 0] - t) ** 2)))
        ranks["mp2"].join()
        if ranks["mp2"].result is not None:
            ref["split"] = _jax_split(ranks["mp2"].result[0])
        return ref
    finally:
        jtopology._GLOBAL_MESH = saved


class _Spawn(threading.Thread):
    def __init__(self, mode, tmp, nproc):
        super().__init__(daemon=True)
        self.args = (mode, tmp, nproc)
        self.result = self.log = None

    def run(self):
        mode, tmp, nproc = self.args
        rc, self.log = W.run_ranks(mode, tmp, nproc=nproc, timeout=SPAWN_TIMEOUT,
                                   worker=M.__file__)
        if rc == 0:
            self.result = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(nproc)]

    def get(self):
        self.join()
        assert self.result is not None, self.log[-6000:]
        return self.result


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ranks = {m: _Spawn(m, tmp_path_factory.mktemp(m), n) for m, n in (("mp2", 2), ("mp4", 4))}
    for t in ranks.values():
        t.start()
    ref = _references(ranks)
    return dict(ref=ref, mp2=ranks["mp2"].get(), mp4=ranks["mp4"].get())


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


def _losses(rank, tag, steps):
    return [float(rank[f"{tag}/loss{i}"]) for i in range(steps)]


def _mp_dims(names):
    """The Llama's mp dimension of each parameter (the reference's specs)."""
    col = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
    row = ("o_proj", "down_proj", "embed_tokens")
    return {n: 1 if any(c in n for c in col) else 0 if any(r in n for r in row) else None
            for n in names}


# ------------------------------------------------------------ mp layers


def test_mp_layers_train_as_the_reference(run):
    ref = run["ref"]
    np.testing.assert_allclose(ref["layers_mesh"]["losses"], ref["layers_one"]["losses"],
                               rtol=RTOL, atol=ATOL)
    params = [_tree(r, "layers/param/") for r in run["mp2"]]
    assert [int(r["layers/mp_rank"]) for r in run["mp2"]] == [0, 1]
    dims = {"0.weight": 0, "1.weight": 1, "1.bias": 0, "3.weight": 0, "3.bias": None,
            "4.weight": 1, "4.bias": 0}
    whole = from_rank_states(params, ref["layers_one"]["params"], "mp", dims)
    for r in run["mp2"]:
        np.testing.assert_allclose(_losses(r, "layers", 2), ref["layers_one"]["losses"],
                                   rtol=RTOL, atol=ATOL)
    for n, want in ref["layers_one"]["params"].items():
        np.testing.assert_allclose(whole[n], want, rtol=0, atol=1e-5, err_msg=n)
    # each rank holds its half of a sharded weight, the row bias whole
    assert params[0]["0.weight"].shape == (8, 8) and params[0]["3.bias"].shape == (8,)
    np.testing.assert_array_equal(params[0]["3.bias"], params[1]["3.bias"])


@pytest.mark.parametrize("name", ["col", "row", "emb"])
def test_split_is_the_reference_split(run, name):
    want = run["ref"]["split"][name]
    for r in run["mp2"]:
        np.testing.assert_allclose(r[f"split/{name}/out"], want, rtol=0, atol=1e-6)
        # the parallel form through the rank's blocks gives the whole output
        np.testing.assert_allclose(r[f"split/{name}/parallel"], want, rtol=0, atol=1e-6)


def test_broadcast_mp_parameters_keeps_each_ranks_blocks(run):
    r0, r1 = run["mp2"]
    # the column-parallel weight and bias are each rank's own; the rest
    # become rank 0's
    assert (r0["broadcast/0.weight"] == 0).all() and (r1["broadcast/0.weight"] == 10).all()
    assert (r0["broadcast/0.bias"] == 1).all() and (r1["broadcast/0.bias"] == 11).all()
    for n in ("1.weight", "1.bias"):
        np.testing.assert_array_equal(r1[f"broadcast/{n}"], r0[f"broadcast/{n}"], err_msg=n)
    assert str(r0["broadcast/mode"]) == "model"
    assert str(r0["broadcast/wrapper"]) == "ModelParallel"


# ---------------------------------------------------------------- Llama


@pytest.mark.parametrize("tag,world", [("llama_mp2", 2), ("llama_mp4", 4),
                                       ("llama_mp2sh2", 4)])
def test_llama_tensor_parallel_is_the_reference_step(run, tag, world):
    ref = run["ref"]
    one, mesh_ref = ref["llama_one"], ref[tag]
    ranks = run["mp2" if world == 2 else "mp4"]
    np.testing.assert_allclose(mesh_ref["losses"], one["losses"], rtol=RTOL, atol=ATOL)
    for r in ranks:
        got = _losses(r, tag, M.LLAMA_STEPS)
        np.testing.assert_allclose(got, one["losses"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, mesh_ref["losses"], rtol=RTOL, atol=ATOL)
        assert got[-1] < got[0]
    coords = [tuple(int(c) for c in r[f"{tag}/coord"]) for r in ranks]
    n_mp = max(c[0] for c in coords) + 1
    n_data = max(c[1] for c in coords) + 1
    by = {c: r for c, r in zip(coords, ranks)}
    dims = _mp_dims(one["params"])
    params = [_tree(by[(m, 0)], f"{tag}/param/") for m in range(n_mp)]
    whole = from_rank_states(params, one["params"], "mp", dims)
    assert set(whole) == set(one["params"])
    for n, want in one["params"].items():
        np.testing.assert_allclose(whole[n], want, rtol=0, atol=2.5 * M.LLAMA_LR, err_msg=n)
    # the replicated parameters stay bitwise equal on every rank
    for r in ranks:
        mine = _tree(r, f"{tag}/param/")
        for n in dims:
            if dims[n] is None:
                np.testing.assert_array_equal(mine[n], params[0][n], err_msg=n)
    # a rank's stamped parameters are its 1/mp of the whole
    for r in ranks:
        held, total = (int(v) for v in r[f"{tag}/bytes"])
        assert held * n_mp == total, (held, total)
    # the state: each rank's (mp, then ZeRO) block of the reference's
    states = [[_tree(by[(m, d)], f"{tag}/state/") for d in range(n_data)] for m in range(n_mp)]
    layout = ("mp", "zero") if n_data > 1 else "mp"
    state = from_rank_states(states if n_data > 1 else [s[0] for s in states], one["state"],
                             layout, dims)
    for n, arrs in one["state"].items():
        for a, b in zip(state[n], arrs):
            if np.ndim(b):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max() + 1e-7,
                                           err_msg=n)
    if n_data > 1:
        for (m, d), r in by.items():
            want = to_rank_state(one["state"], (m, d), (n_mp, n_data), ("mp", "zero"), dims)
            got = _tree(r, f"{tag}/state/")
            assert {n: [a.shape for a in v] for n, v in got.items()} == \
                {n: [a.shape for a in v] for n, v in want.items()}


# ------------------------------------------------------------ pipelines


def _pipe_params(ranks, tag):
    """The pipeline's parameters gathered over pp (from the ranks of data
    and mp index 0), stages reshaped to [1, L, ...]; pre/post held bitwise
    equal on every pp rank."""
    by = {tuple(int(c) for c in r[f"{tag}/coord"]): r for r in ranks}
    n_pp = max(c[0] for c in by) + 1
    per_pp = [_tree(by[(s, 0, 0)], f"{tag}/param/") for s in range(n_pp)]
    whole = {}
    for n in per_pp[0]:
        if n.startswith("stages."):
            a = np.concatenate([p[n] for p in per_pp])
            whole[n] = a.reshape((1, -1) + a.shape[2:])
        else:
            whole[n] = per_pp[0][n]
            for p in per_pp[1:]:
                np.testing.assert_array_equal(p[n], whole[n], err_msg=n)
    return whole


def _hold_pipe(ranks, tag, want, steps, mesh_ref=None, atol=1e-5):
    for r in ranks:
        got = _losses(r, tag, steps)
        np.testing.assert_allclose(got, want["losses"], rtol=RTOL, atol=ATOL, err_msg=tag)
        if mesh_ref is not None:
            np.testing.assert_allclose(got, mesh_ref["losses"], rtol=RTOL, atol=ATOL)
        # the loss comes back bitwise on every rank
        assert got == _losses(ranks[0], tag, steps)
    whole = _pipe_params(ranks, tag)
    assert set(whole) == set(want["params"])
    for n, w in want["params"].items():
        np.testing.assert_allclose(whole[n].reshape(w.shape), w, rtol=0, atol=atol,
                                   err_msg=f"{tag} {n}")


@pytest.mark.parametrize("tag", ["pp2", "pp2_recompute"])
def test_pipeline_pp2_is_the_reference_pipeline(run, tag):
    ref = run["ref"]
    np.testing.assert_allclose(ref["pipe_llama_pp2"]["losses"], ref["pipe_llama"]["losses"],
                               rtol=RTOL, atol=ATOL)
    _hold_pipe(run["mp2"], tag, ref["pipe_llama"], M.PIPE_STEPS, ref["pipe_llama_pp2"])
    for r in run["mp2"]:
        assert list(r[f"{tag}/schedule"]) == [3, 1 / 3]


def test_pipeline_recompute_is_bitwise_the_plain_pipeline(run):
    for r in run["mp2"]:
        for k in r:
            if k.startswith("pp2/"):
                np.testing.assert_array_equal(r[k.replace("pp2/", "pp2_recompute/", 1)], r[k],
                                              err_msg=k)


def test_pipeline_amp_o1_matches_loosely(run):
    ref = run["ref"]
    for r in run["mp2"]:
        got = _losses(r, "pp2_o1", M.PIPE_STEPS)
        np.testing.assert_allclose(got, ref["pipe_llama_o1"]["losses"], rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(got, ref["pipe_llama"]["losses"], rtol=5e-2, atol=5e-2)
        assert got != _losses(r, "pp2", M.PIPE_STEPS)  # the trunk ran in float16


def test_pipeline_dropout_trunk_takes_the_tick_and_stage_keys(run):
    _hold_pipe(run["mp2"], "pp2_drop", run["ref"]["pipe_drop"], M.PIPE_STEPS)


def test_fleet_pipeline_train_batch_drives_the_step(run):
    ref = run["ref"]
    for r in run["mp2"]:
        assert str(r["fleet/wrapper"]) == "PipelineParallel"
        assert _losses(r, "fleet", M.PIPE_STEPS) == _losses(r, "pp2", M.PIPE_STEPS)
        np.testing.assert_allclose(_losses(r, "fleet", M.PIPE_STEPS),
                                   ref["pipe_llama"]["losses"], rtol=RTOL, atol=ATOL)
        assert "needs batch size divisible by micro_batches*dp (2); got 3" in \
            str(r["fleet/divisibility"])
        # the gathered state_dict is the whole model's, the same on both ranks
        assert len(r["fleet/state"]) == 1 + 4 * 9 + 2
    a, b = (_tree(r, "fleet/param/") for r in run["mp2"])
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    whole = _pipe_params(run["mp2"], "pp2")
    for n, w in whole.items():
        if n.startswith("stages."):
            name = n[len("stages."):]
            for i in range(4):
                np.testing.assert_array_equal(a[f"run_functions.{i + 1}.{name}"], w[0, i],
                                              err_msg=n)


def test_pipeline_pp4_is_the_reference_pipeline(run):
    _hold_pipe(run["mp4"], "pp4", run["ref"]["pipe_llama"], M.PIPE_STEPS)
    for r in run["mp4"]:
        np.testing.assert_allclose(list(r["pp4/schedule"]), [5, 3 / 5])


def test_pipeline_dp2_pp2_zero1_state_is_the_reference(run):
    ref = run["ref"]["pipe_llama_adam"]
    _hold_pipe(run["mp4"], "dp2pp2", ref, M.PIPE_STEPS, atol=ADAM_ATOL)
    by = {tuple(int(c) for c in r["dp2pp2/coord"]): r for r in run["mp4"]}
    states = [[_tree(by[(s, 0, d)], "dp2pp2/state/") for d in range(2)] for s in range(2)]
    like = {n: tuple(np.zeros((2, 2) + a.shape[2:]) if n.startswith("stages.") and a.ndim
                     else a for a in v) for n, v in ref["state"].items()}
    state = from_rank_states(states, like, ("pp", "zero"))
    for n, arrs in ref["state"].items():
        for a, b in zip(state[n], arrs):
            np.testing.assert_allclose(np.reshape(a, np.shape(b)), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max() + 1e-8, err_msg=n)
    # the moments are sharded over dp behind the [stage, layer] dims
    got = states[0][0]["stages.self_attn.q_proj.weight"][0].shape
    assert got == (1, 2, 16, 32), got


def test_pipeline_pp2_mp2_megatron_stages(run):
    ref = run["ref"]
    np.testing.assert_allclose(ref["pipe_tp_mesh"]["losses"], ref["pipe_tp"]["losses"],
                               rtol=RTOL, atol=ATOL)
    ranks = run["mp4"]
    for r in ranks:
        np.testing.assert_allclose(_losses(r, "pp2mp2", M.PIPE_STEPS), ref["pipe_tp"]["losses"],
                                   rtol=RTOL, atol=ATOL)
    by = {tuple(int(c) for c in r["pp2mp2/coord"]): r for r in ranks}
    dims = {"stages.col.weight": 3, "stages.col.bias": 2, "stages.row.weight": 2}
    per_pp = [from_rank_states([_tree(by[(s, m, 0)], "pp2mp2/param/") for m in range(2)],
                               to_rank_state(ref["pipe_tp_mesh"]["params"], s, 2, "pp"),
                               "mp", dims) for s in range(2)]
    whole = from_rank_states(per_pp, ref["pipe_tp_mesh"]["params"], "pp")
    for n, w in ref["pipe_tp_mesh"]["params"].items():
        np.testing.assert_allclose(whole[n], w, rtol=0, atol=1e-5, err_msg=n)
    # the mp ranks of a stage hold halves of its Megatron weights
    assert _tree(by[(0, 0, 0)], "pp2mp2/param/")["stages.col.weight"].shape == (1, 2, 16, 16)


def test_pipeline_pp2_sp2_ring_attention_stages(run):
    ref = run["ref"]
    np.testing.assert_allclose(ref["pipe_ring_mesh"]["losses"], ref["pipe_ring"]["losses"],
                               rtol=RTOL, atol=ATOL)
    _hold_pipe(run["mp4"], "pp2sp2", ref["pipe_ring"], 3, ref["pipe_ring_mesh"],
               atol=ADAM_ATOL)
    # rank-1 labels keep the plain data layout
    for r in run["mp4"]:
        np.testing.assert_allclose(_losses(r, "pp2sp2_rank1", 1),
                                   ref["pipe_ring_rank1"]["losses"], rtol=RTOL, atol=ATOL)
