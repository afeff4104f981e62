"""The port's MoE (paddle_tpu_torch/incubate/moe.py, nn/aux_loss.py) and
expert parallelism against the JAX package's, on the CPU.

One process: ``MoELayer``'s dense, capacity and alltoall forwards, its aux
loss and its gradients against paddle_tpu/incubate/moe.py on the same
weights and inputs; the reference's own regressions (exactly top-k on a
uniform gate, capacity matching dense when nothing drops, overflow
dropping); the aux loss joining ``build_train_step``'s loss. Several
processes: the ranks of ``tests/torch_dist_moe_worker.py`` (the port's
launcher over gloo) train at ep=2 in the three modes, at dp=2 x ep=2 and
pipelined at pp=2 x ep=2, and run Lamb and LARS under ZeRO-2 over dp=2
and over mp=2; each is held against the reference's step on the same
mesh of the JAX package's 8-device CPU platform.

Tolerances, each with its reason:
- forwards, aux losses and gradients: 1e-5 (float32 products in other
  orders than XLA's);
- the MoE steps (SGD, lr 0.1): losses rtol 1e-5, parameters 1e-5
  absolute: the ranks add the experts' outputs over ep and the
  gradients over data in other orders;
- Lamb and LARS: losses 1e-4 and parameters 2.5 * lr (the meshed steps'
  tolerances, tests/test_torch_dist_meshed.py): the trust ratio's norms
  are sums of the blocks' sums of squares over the ranks.
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
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.meta_parallel import ColumnParallelLinear as JCol
from paddle_tpu.distributed.meta_parallel import RowParallelLinear as JRow
from paddle_tpu.distributed.meta_parallel import VocabParallelEmbedding as JVocab
from paddle_tpu.incubate.moe import MoELayer as JMoE
import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import from_rank_states, to_rank_state
from paddle_tpu_torch.distributed import spmd as tspmd
from paddle_tpu_torch.distributed import topology as ttopology
from paddle_tpu_torch.incubate.moe import MoELayer

import torch_dist_moe_worker as M
import torch_dist_worker as W
from test_torch_dist_model_parallel import _tree

torch.set_num_threads(2)
SPAWN_TIMEOUT = 240
TOL = 1e-5
TRUST_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = ptt.core.place._CURRENT
    ptt.set_device("cpu")
    yield
    ptt.core.place._CURRENT = saved


@pytest.fixture(autouse=True)
def _meshes():
    saved_j, saved_t = jtopology._GLOBAL_MESH, ttopology._GLOBAL_MESH
    yield
    jtopology._GLOBAL_MESH, ttopology._GLOBAL_MESH = saved_j, saved_t


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jtopology.build_mesh(**axes, devices=jax.devices()[:n])


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jmse(o, t):
    return jnp.mean((o - t) ** 2)


def _state(layer):
    return {n: p.detach().numpy().copy() for n, p in layer.named_parameters()}


class JMoENet(jnn.Layer):
    def __init__(self, mode, experts, cf):
        super().__init__()
        self.moe = JMoE(8, 16, num_experts=experts, top_k=2, dispatch_mode=mode,
                        capacity_factor=cf, aux_weight=0.1)

    def forward(self, x):
        return x + self.moe(x)


class JMoEBlock(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.moe = JMoE(16, 32, num_experts=4, top_k=2, dispatch_mode="capacity",
                        capacity_factor=4.0)

    def forward(self, x):
        return x + self.moe(x)


# ------------------------------------------------------------ one process


def _pair(mode, experts, cf, aux_weight=0.01, hidden=8, ffn=16):
    paddle.seed(0)
    ref = JMoE(hidden, ffn, num_experts=experts, top_k=2, dispatch_mode=mode,
               capacity_factor=cf, aux_weight=aux_weight)
    port = MoELayer(hidden, ffn, num_experts=experts, top_k=2, dispatch_mode=mode,
                    capacity_factor=cf, aux_weight=aux_weight, device="cpu")
    # the reference's numpy state loads into the port's unchanged
    port.set_state_dict({n: np.asarray(p._value) for n, p in ref.state_dict().items()})
    return ref, port


@pytest.mark.parametrize("mode,experts,cf", [("dense", 4, 1.25), ("capacity", 8, 1.25),
                                             ("capacity", 8, 0.3), ("alltoall", 8, 1.25)])
def test_forward_aux_and_gradients_match_the_reference(mode, experts, cf):
    ref, port = _pair(mode, experts, cf)
    assert [n for n, _ in port.named_parameters()] == [n for n, _ in ref.named_parameters()]
    assert port.w_up.mp_spec == ("ep",) and port.dispatch_mode == ref.dispatch_mode
    if mode == "alltoall":
        jtopology.set_global_mesh(_mesh(ep=2))
        ttopology.set_global_mesh(ttopology.Mesh((1, 1, 1, 1, 2, 1)))
    x = np.random.RandomState(0).rand(4, 6, 8).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out_t = port(xt)
    aux_t = port.aux_loss
    ((out_t * out_t).mean() + aux_t).backward()
    if mode == "alltoall":
        # the reference's eager backward of its shard_map places its
        # cotangents on other devices than its inputs and fails; its
        # gradients come from one SGD step at lr 1 instead (p - g)
        out_j = ref(paddle.to_tensor(x))
        aux_j = ref.aux_loss
        before = {n: np.asarray(p._value) for n, p in ref.named_parameters()}
        mesh = jtopology.get_global_mesh()
        step, init = jspmd.build_train_step(ref, lambda o, t: jnp.mean(o * o),
                                            jopt.SGD(1.0, parameters=ref.parameters()),
                                            mesh=mesh)
        _, after, _ = step(*init(), x, x)
        grads = {n: before[n] - np.asarray(a) for n, a in _np(after).items()}
    else:
        xj = paddle.to_tensor(x, stop_gradient=False)
        out_j = ref(xj)
        aux_j = ref.aux_loss
        (paddle.mean(out_j * out_j) + aux_j).backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(xj.grad._value), rtol=0,
                                   atol=TOL)
        grads = {n: np.asarray(q.grad._value) for n, q in ref.named_parameters()}
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j._value), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(aux_t.detach()), float(np.asarray(aux_j._value)),
                               rtol=TOL)
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n], rtol=0, atol=TOL, err_msg=n)


def test_uniform_probs_select_exactly_topk():
    """The reference's regression: a zero token under a zero gate picks
    exactly one expert (index 0 wins the tie) at top_k=1."""
    port = MoELayer(8, 16, num_experts=4, top_k=1, device="cpu")
    with torch.no_grad():
        port.gate.weight.zero_()
        port.gate.bias.zero_()
    x = torch.zeros(1, 1, 8)  # a padding token: a uniform gate
    out = port(x).detach().numpy()
    w_up, w_down = port.w_up.detach().numpy()[0], port.w_down.detach().numpy()[0]
    h = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy() @ w_up)))
    np.testing.assert_allclose(out, h @ w_down, rtol=1e-5, atol=1e-6)
    # top_k ties go to the lower index, as jax.lax.top_k
    from paddle_tpu_torch.incubate.moe import top_k

    vals, idx = top_k(torch.full((2, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1], [0, 1]]


def test_capacity_matches_dense_when_nothing_drops_and_drops_overflow():
    paddle.seed(9)
    cap = MoELayer(8, 16, num_experts=8, top_k=2, capacity_factor=8.0, device="cpu")
    dense = MoELayer(8, 16, num_experts=8, top_k=2, dispatch_mode="dense", device="cpu")
    tight = MoELayer(8, 16, num_experts=8, top_k=2, capacity_factor=0.1, device="cpu")
    dense.set_state_dict(cap.state_dict())
    tight.set_state_dict(cap.state_dict())
    assert cap.dispatch_mode == "capacity"
    assert MoELayer(8, 16, num_experts=4, device="cpu").dispatch_mode == "dense"
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 6, 8).astype(np.float32))
    o_cap, o_dense, o_tight = (m(x).detach().numpy() for m in (cap, dense, tight))
    np.testing.assert_allclose(o_cap, o_dense, rtol=1e-4, atol=1e-5)
    assert np.isfinite(o_tight).all() and np.abs(o_tight).sum() < np.abs(o_dense).sum()


def test_alltoall_refuses_what_the_reference_refuses():
    ttopology.set_global_mesh(ttopology.Mesh((1, 1, 1, 1, 4, 1)))
    with pytest.raises(ValueError, match="divide"):
        MoELayer(8, 16, num_experts=6, dispatch_mode="alltoall", device="cpu")(
            torch.zeros(4, 2, 8))
    with pytest.raises(ValueError, match="divisible"):
        MoELayer(8, 16, num_experts=8, dispatch_mode="alltoall", device="cpu")(
            torch.zeros(3, 2, 8))
    ttopology.set_global_mesh(ttopology.Mesh((1, 1, 1, 1, 1, 1)))
    with pytest.raises(ValueError, match="needs a global mesh"):
        MoELayer(8, 16, num_experts=8, dispatch_mode="alltoall", device="cpu")(
            torch.zeros(4, 2, 8))


@pytest.mark.parametrize("aux_weight", [0.5, 0.0])
def test_aux_loss_joins_the_steps_loss(aux_weight):
    """One step of ``build_train_step`` (one device) against the
    reference's: the aux loss is in the loss, and the layer holds none
    after the step."""
    mesh = _mesh(dp=1)
    jtopology.set_global_mesh(mesh)
    ref, port = _pair("dense", 4, 1.25, aux_weight=aux_weight)
    x = np.random.RandomState(0).rand(4, 3, 8).astype(np.float32)
    jstep, jinit = jspmd.build_train_step(ref, _jmse, jopt.SGD(0.1, parameters=ref.parameters()),
                                          mesh=mesh)
    jl, jp, _ = jstep(*jinit(), x, x)
    tstep, tinit = tspmd.build_train_step(
        port, lambda o, t: ((o - t) ** 2).mean(), topt.SGD(0.1, parameters=port.parameters()))
    tl, tp, _ = tstep(*tinit(), torch.from_numpy(x), torch.from_numpy(x))
    assert port.aux_loss is None
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    for n, a in _np(jp).items():
        np.testing.assert_allclose(tp[n].numpy(), a, rtol=0, atol=TOL, err_msg=n)


def test_direct_aux_loss_assignment_is_collected():
    """A layer that assigns ``self.aux_loss`` itself: the step adds it
    and clears it (the reference's legacy contract)."""

    class DirectAux(ptt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = ptt.nn.Linear(4, 4, device="cpu")
            self.aux_loss = None

        def forward(self, x):
            out = self.fc(x)
            self.aux_loss = (out * out).mean() * 0.1
            return out

    net = DirectAux()
    step, init = tspmd.build_train_step(net, lambda o, t: ((o - t) ** 2).mean(),
                                        topt.SGD(0.0, parameters=net.parameters()))
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 4).astype(np.float32))
    loss, _, _ = step(*init(), x, torch.zeros_like(x))
    assert net.aux_loss is None
    out = net(x)
    np.testing.assert_allclose(float(loss), float(((out ** 2).mean() + net.aux_loss).detach()),
                               rtol=1e-6)


# ------------------------------------------------------------- the ranks


def _jax_moe(mode, experts, cf, mesh, batch_rows=None):
    jtopology.set_global_mesh(mesh)
    net = JMoENet(mode, experts, cf)
    net.set_state_dict(_state(M.MoENet(mode, experts, cf)))
    step, init = jspmd.build_train_step(net, _jmse, jopt.SGD(M.MOE_LR,
                                                             parameters=net.parameters()),
                                        mesh=mesh)
    params, st = init()
    x, y = M.moe_data()
    losses = []
    for _ in range(M.STEPS):
        loss, params, st = step(params, st, x, y, key=jax.random.PRNGKey(0))
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params))


def _jax_trust(kind, mesh, mp):
    jtopology.set_global_mesh(mesh)
    if mp:
        m = jnn.Sequential(JVocab(16, 8), JCol(8, 12, has_bias=True, gather_output=False),
                           jnn.Tanh(), JRow(12, 8, input_is_parallel=True),
                           JCol(8, 6, has_bias=True, gather_output=True))
        import torch_dist_model_parallel_worker as MP

        m.set_state_dict(M.MP.numpy_state(MP.mp_layers_model()))
        x, y = MP.mp_layers_data()
        kw = {}
    else:
        m = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
        m.set_state_dict(M.MP.numpy_state(M.trust_model()))
        x, y = M.trust_data()
        kw = dict(sharding_stage=2)
    if kind == "lamb":
        opt = jopt.Lamb(M.TRUST_LR, lamb_weight_decay=0.01, parameters=m.parameters())
    else:
        opt = jopt.Lars(M.TRUST_LR, momentum=0.9, lars_coeff=0.05, parameters=m.parameters())
    step, init = jspmd.build_train_step(m, _jmse, opt, mesh=mesh, **kw)
    params, st = init()
    losses = []
    for _ in range(M.STEPS):
        loss, params, st = step(params, st, x, y, key=jax.random.PRNGKey(0))
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params))


def _jax_fsdp_lamb(mesh):
    jtopology.set_global_mesh(mesh)
    seq = jnn.Sequential(jnn.Linear(8, 16), *[jnn.Linear(16, 16) for _ in range(4)],
                         jnn.Linear(16, 4))
    seq.set_state_dict(M.MP.numpy_state(M.fsdp_model()))
    opt = jopt.Lamb(M.TRUST_LR, lamb_weight_decay=0.01, parameters=seq.parameters())
    step, init = jspmd.build_fsdp_train_step(seq, _jmse, opt, mesh=mesh)
    params, st = init()
    x, y = M.trust_data()
    losses = []
    for _ in range(M.STEPS):
        loss, params, st = step(params, st, x, y, key=jax.random.PRNGKey(0))
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params))


def _jax_pipe(mesh, lamb=False):
    pre = [jnn.Linear(8, 16)]
    trunk = [JMoEBlock() for _ in range(4)]
    post = [jnn.Linear(16, 4)]
    port = M.moe_pipe_layers()
    for j, p in zip((pre, trunk, post), port):
        for jl, pl in zip(j, p):
            jl.set_state_dict(_state(pl))
    jtopology.set_global_mesh(mesh)
    params = [p for l in pre + trunk + post for p in l.parameters()]
    opt = (jopt.Lamb(M.TRUST_LR, lamb_weight_decay=0.01, parameters=params) if lamb
           else jopt.SGD(0.01, parameters=params))
    step, init = jpipe.build_pipeline_train_step(pre, trunk, post, _jmse, opt, mesh=mesh,
                                                 num_micro=2, donate=False)
    params, st = init()
    x, y = M.moe_pipe_data()
    losses = []
    for _ in range(M.STEPS):
        loss, params, st = step(params, st, x, y, key=jax.random.PRNGKey(0))
        losses.append(float(loss))
    return dict(losses=losses, params=_np(params))


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
    spawns = {m: _Spawn(m, tmp_path_factory.mktemp(m), n) for m, n in (("ep2", 2), ("ep4", 4))}
    for t in spawns.values():
        t.start()
    saved = jtopology._GLOBAL_MESH
    try:
        ref = {f"ep2_{mode}": _jax_moe(mode, e, cf, _mesh(ep=2)) for mode, e, cf in M.MOE_RUNS}
        ref.update({f"dp2ep2_{mode}": _jax_moe(mode, e, cf, _mesh(dp=2, ep=2))
                    for mode, e, cf in M.MOE_RUNS[1:]})
        for kind in M.TRUST:
            ref[f"zero2_{kind}"] = _jax_trust(kind, _mesh(dp=2), mp=False)
            ref[f"mp2_{kind}"] = _jax_trust(kind, _mesh(mp=2), mp=True)
        ref["pp2ep2"] = _jax_pipe(_mesh(pp=2, ep=2))
        ref["pp2ep2_lamb"] = _jax_pipe(_mesh(pp=2, ep=2), lamb=True)
        ref["one_pipe"] = _jax_pipe(_mesh(dp=1))
        ref["fsdp_lamb"] = _jax_fsdp_lamb(_mesh(dp=2))
    finally:
        jtopology._GLOBAL_MESH = saved
    return dict(ref=ref, ep2=spawns["ep2"].get(), ep4=spawns["ep4"].get())


def _losses(rank, tag):
    return [float(rank[f"{tag}/loss{i}"]) for i in range(M.STEPS)]


EP_DIMS = {"moe.w_up": 0, "moe.w_down": 0}


@pytest.mark.parametrize("tag", [f"ep2_{m}" for m, _, _ in M.MOE_RUNS]
                         + [f"dp2ep2_{m}" for m, _, _ in M.MOE_RUNS[1:]])
def test_ep_steps_match_the_reference_mesh(run, tag):
    ranks = run["ep2"] if tag.startswith("ep2") else run["ep4"]
    want = run["ref"][tag]
    for r in ranks:
        np.testing.assert_allclose(_losses(r, tag), want["losses"], rtol=TOL, err_msg=tag)
    # rank r is ep rank r % 2 (ep is the mesh's last axis of more than one)
    params = [_tree(ranks[e], f"{tag}/param/") for e in range(2)]
    assert params[0]["moe.w_up"].shape[0] == want["params"]["moe.w_up"].shape[0] // 2
    whole = from_rank_states(params, want["params"], "ep", EP_DIMS)
    for n, w in want["params"].items():
        np.testing.assert_allclose(whole[n], w, rtol=0, atol=TOL, err_msg=f"{tag} {n}")
    # the gate is replicated over ep: bitwise equal on every rank
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{tag}/param/moe.gate.weight"],
                                      ranks[0][f"{tag}/param/moe.gate.weight"])
    for e in range(2):  # the data ranks of one ep rank hold the same block
        for r in ranks[2 + e::2]:
            np.testing.assert_array_equal(r[f"{tag}/param/moe.w_up"],
                                          ranks[e][f"{tag}/param/moe.w_up"])


def test_ep_layout_round_trips_through_convert(run):
    want = run["ref"]["ep2_capacity"]["params"]
    cut = [to_rank_state(want, e, 2, "ep", EP_DIMS) for e in range(2)]
    assert cut[1]["moe.w_up"].shape == (4, 8, 16) and cut[1]["moe.gate.weight"].shape == (8, 8)
    back = from_rank_states(cut, want, "ep", EP_DIMS)
    for n, w in want.items():
        np.testing.assert_array_equal(back[n], w)


@pytest.mark.parametrize("tag", ["pp2ep2", "pp2ep2_lamb"])
def test_pp2_ep2_pipeline_matches_the_reference(run, tag):
    """SGD, and Lamb, whose trust ratio reads each stacked [S, lps, ...]
    array's norms over the stages and the experts."""
    ranks = run["ep4"]
    want = run["ref"][tag]
    lamb = tag.endswith("lamb")
    for r in ranks:
        np.testing.assert_allclose(_losses(r, tag), want["losses"],
                                   rtol=TRUST_RTOL if lamb else TOL)
        if not lamb:
            np.testing.assert_allclose(_losses(r, tag), run["ref"]["one_pipe"]["losses"],
                                       rtol=2e-4, atol=2e-5)
    by = {tuple(int(c) for c in r[f"{tag}/coord"]): r for r in ranks}
    dims = {"stages.moe.w_up": 2, "stages.moe.w_down": 2}
    per_pp = [from_rank_states([_tree(by[(s, e)], f"{tag}/param/") for e in range(2)],
                               to_rank_state(want["params"], s, 2, "pp"), "ep", dims)
              for s in range(2)]
    whole = from_rank_states(per_pp, want["params"], "pp")
    for n, w in want["params"].items():
        np.testing.assert_allclose(whole[n], w, rtol=0,
                                   atol=2.5 * M.TRUST_LR if lamb else TOL, err_msg=n)
    assert by[(0, 1)][f"{tag}/param/stages.moe.w_up"].shape == (1, 2, 2, 16, 32)


@pytest.mark.parametrize("tag", ["zero2_lamb", "zero2_lars", "mp2_lamb", "mp2_lars",
                                 "fsdp_lamb"])
def test_lamb_and_lars_over_blocks_match_the_reference(run, tag):
    ranks = run["ep2"]
    want = run["ref"][tag]
    for r in ranks:
        np.testing.assert_allclose(_losses(r, tag), want["losses"], rtol=TRUST_RTOL)
    params = [_tree(r, f"{tag}/param/") for r in ranks]
    if tag == "fsdp_lamb":  # the trunk's blocks over the data ranks
        whole = from_rank_states(params, want["params"], "fsdp")
    elif tag.startswith("mp2"):
        dims = {"0.weight": 0, "1.weight": 1, "1.bias": 0, "3.weight": 0, "3.bias": None,
                "4.weight": 1, "4.bias": 0}
        whole = from_rank_states(params, want["params"], "mp", dims)
    else:  # ZeRO-2: the parameters are whole on every rank
        whole = params[0]
        for n in whole:
            np.testing.assert_array_equal(params[1][n], whole[n])
    for n, w in want["params"].items():
        np.testing.assert_allclose(whole[n], w, rtol=0, atol=2.5 * M.TRUST_LR,
                                   err_msg=f"{tag} {n}")
    if tag == "fsdp_lamb":
        assert params[0]["trunk.weight"].shape == (4, 8, 16)  # a rank's block of [4, 16, 16]
        return
    # the trust ratio moved every parameter (the update is not zero)
    start = M.MP.numpy_state(M.trust_model() if tag.startswith("zero2") else
                             M.MP.mp_layers_model())
    assert all(not np.array_equal(whole[n], start[n]) for n in start)
