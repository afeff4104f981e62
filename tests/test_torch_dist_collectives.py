"""The port's collectives, topology, strategy, role makers, p2p transport,
fleet.metrics/UtilBase and DistributedBatchSampler against numpy and the
JAX package's.

One spawned run (two gloo ranks on the CPU, started by the port's launcher
from tests/torch_dist_worker.py, with its own timeout) exercises every
op; each result must be bitwise the numpy answer. The rank arithmetic
(CommunicateTopology, HybridCommunicateGroup), DistributedStrategy and the
role makers must equal the reference's for the same shape or env; the
global metrics over two ranks must equal the reference's one-process
value on the whole data (float64 sums in another order: rtol 1e-12).
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import metrics as jmetrics
from paddle_tpu.distributed.fleet import role_maker as jrole
from paddle_tpu.io import DistributedBatchSampler as JSampler
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import collective as tcol
from paddle_tpu_torch.distributed import topology as ttopology
from paddle_tpu_torch.distributed.fleet import DistributedStrategy as TStrategy
from paddle_tpu_torch.distributed.fleet import role_maker as trole

import torch_dist_worker as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    rc, log = W.run_ranks("collectives", out)
    assert rc == 0, log[-6000:]
    return ([dict(np.load(out / f"rank{r}.npz")) for r in (0, 1)],
            [json.load(open(out / f"topology{r}.json")) for r in (0, 1)])


def _x(r):
    return W.values(r)


OPS = {
    "all_reduce_sum": lambda r: _x(0) + _x(1),
    "all_reduce_max": lambda r: np.maximum(_x(0), _x(1)),
    "all_reduce_min": lambda r: np.minimum(_x(0), _x(1)),
    "all_reduce_prod": lambda r: _x(0) * _x(1),
    "all_reduce_avg": lambda r: (_x(0) + _x(1)) / np.float32(2),
    "broadcast": lambda r: _x(1),
    "all_gather": lambda r: np.stack([_x(0), _x(1)]),
    "scatter": lambda r: np.full(2, 10.0 * r + 1, np.float32),
    "all_to_all": lambda r: np.stack([np.full(2, 100.0 * i + r, np.float32) for i in (0, 1)]),
    "alltoall_single": lambda r: np.concatenate(
        [(np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * i)[2 * r:2 * r + 2]
         for i in (0, 1)]),
    "psum": lambda r: _x(0) + _x(1),
    "pmean": lambda r: (_x(0) + _x(1)) / np.float32(2),
    "all_gather_spmd": lambda r: np.concatenate([_x(0), _x(1)]),
    "ppermute": lambda r: _x(1 - r),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_collective_over_two_ranks_is_bitwise_numpy(ranks, op):
    res, _ = ranks
    for r in (0, 1):
        want = OPS[op](r)
        assert res[r][op].dtype == want.dtype
        np.testing.assert_array_equal(res[r][op], want, err_msg=f"rank {r}")


def test_reduce_send_recv_and_p2p_tags(ranks):
    res, _ = ranks
    np.testing.assert_array_equal(res[0]["reduce"], _x(0) + _x(1))
    np.testing.assert_array_equal(res[1]["recv"], _x(0) * 3)
    # two tags on one edge, received in the other order
    np.testing.assert_array_equal(res[1]["p2p_tag1"], W.values(7))
    np.testing.assert_array_equal(res[1]["p2p_tag2"], W.values(8))
    for r in (0, 1):
        np.testing.assert_array_equal(res[r]["world"], [2, r, 2, r])


def test_metrics_and_util_over_two_ranks_equal_the_reference_on_the_whole_data(ranks):
    res, _ = ranks
    data = np.random.RandomState(3).rand(2, 10)
    pos, neg = np.random.RandomState(4).randint(0, 9, (2, 2, 16))
    want = [jmetrics.sum(data), jmetrics.max(data), jmetrics.min(data),
            jmetrics.auc(pos.sum(0), neg.sum(0)), jmetrics.mae(data, 20),
            jmetrics.mse(data, 20), jmetrics.rmse(data, 20), jmetrics.acc(data, data + 1)]
    for r in (0, 1):
        np.testing.assert_allclose(res[r]["metrics"], want, rtol=1e-12)
        np.testing.assert_allclose(res[r]["util_sum"], data.sum(0), rtol=1e-15)
        np.testing.assert_array_equal(res[r]["util_max"], data.max(0))
        np.testing.assert_array_equal(
            res[r]["util_gather"], np.stack([data[i].astype(np.int64) + i for i in (0, 1)]))
    assert list(res[0]["file_shard"]) == ["f0", "f1", "f2"]
    assert list(res[1]["file_shard"]) == ["f3", "f4"]


def test_distributed_batch_sampler_reads_the_job(ranks):
    """Not given num_replicas/rank, the sampler takes the job's (2, r), as
    the reference's reads get_world_size()/get_rank(); its batches are the
    reference sampler's given (2, r) explicitly."""
    res, _ = ranks
    for r in (0, 1):
        np.testing.assert_array_equal(res[r]["sampler"], [2, r])
        ref = JSampler(list(range(11)), batch_size=2, num_replicas=2, rank=r, shuffle=True)
        np.testing.assert_array_equal(res[r]["sampler_batches"], [i for b in ref for i in b])


@pytest.fixture
def jax_global_mesh():
    """The reference's HybridCommunicateGroup sets the JAX package's global
    mesh: put it back for the tests that follow in this process."""
    saved = jtopology._GLOBAL_MESH, jtopology._HYBRID_GROUP
    yield
    jtopology._GLOBAL_MESH, jtopology._HYBRID_GROUP = saved


def test_hybrid_groups_over_two_ranks_equal_the_reference(ranks, jax_global_mesh):
    """Each shape's parallel mode, degrees and per-rank coordinates (the
    reference's HybridCommunicateGroup with a device list of two) and a
    sum over the size-2 axis's group."""
    _, topo = ranks
    for key, shape in (("dp2", dict(dp=2)), ("mp2", dict(mp=2)), ("pp2", dict(pp=2)),
                       ("sharding2", dict(sharding=2))):
        ref = jtopology.HybridCommunicateGroup(**shape)
        for r in (0, 1):
            got = topo[r][key]
            assert got["mode"] == ref.get_parallel_mode()
            assert got["sizes"] == [ref.get_data_parallel_world_size(),
                                    ref.get_model_parallel_world_size(),
                                    ref.get_pipe_parallel_world_size(),
                                    ref.get_sharding_parallel_world_size()]
            assert got["ranks"] == list(ref.topology().get_coord(r)[:4])
            assert got["mesh"] == dict(ref.mesh.shape)
            assert got["axis_sum"] == 3.0


@pytest.mark.parametrize("names,dims", [
    (("data", "pipe", "sharding", "model"), (2, 1, 1, 1)),
    (("data", "pipe", "sharding", "model"), (2, 2, 1, 2)),
    (("data", "pipe", "sharding", "sep", "model"), (2, 1, 2, 1, 2)),
    (("data", "model"), (3, 2)),
])
def test_communicate_topology_equals_the_reference(names, dims):
    ref = jtopology.CommunicateTopology(names, dims)
    got = ttopology.CommunicateTopology(names, dims)
    assert got.world_size() == ref.world_size()
    for n in names:
        assert got.get_dim(n) == ref.get_dim(n)
        assert got.get_comm_list(n) == ref.get_comm_list(n)
        for i in range(got.get_dim(n)):
            assert got.get_axis_list(n, i) == ref.get_axis_list(n, i)
    for r in range(got.world_size()):
        assert got.get_coord(r) == ref.get_coord(r)
        assert got.get_rank(**dict(zip(names, got.get_coord(r)))) == r


def test_one_process_mesh_and_collectives_are_the_identity():
    """Outside a job the mesh is one rank and every op is the reference's
    one-process identity; a larger mesh needs the ranks."""
    mesh = ttopology.build_mesh()
    assert mesh.size == 1 and mesh.group("dp") is None and mesh.rank_in("dp") == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ttopology.build_mesh(dp=2)
    x = torch.arange(6.0).reshape(2, 3)
    for op in ("sum", "max", "min", "prod", "avg"):
        assert torch.equal(tdist.all_reduce(x.clone(), op), x)
    assert torch.equal(tdist.broadcast(x.clone()), x)
    assert [t.tolist() for t in tdist.all_gather([], x)] == [x.tolist()]
    assert torch.equal(tcol.psum(x, "dp"), x) and torch.equal(tcol.pmean(x, "mp"), x)
    assert torch.equal(tcol.ppermute(x, "dp", [(0, 0)]), x)
    assert tdist.get_rank() == 0 and tdist.get_world_size() == 1
    assert tdist.get_rank_in() == 0
    # one rank: split's layer is the plain one (a named layer is cached)
    out = tdist.split(x, (3, 4), "linear", axis=1, name="one_rank_split")
    layer = tcol._SPLIT_LAYERS.pop("one_rank_split")
    torch.testing.assert_close(out, x @ layer.weight + layer.bias)
    with pytest.raises(RuntimeError, match="one rank"):
        tdist.send(x, dst=1)


def test_distributed_strategy_equals_the_reference():
    ref, got = JStrategy(), TStrategy()
    assert got.to_dict() == ref.to_dict()
    for s in (ref, got):
        s.amp = True
        s.amp_configs = {"use_pure_fp16": True}
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": 4}
        s.hybrid_configs = {"dp_degree": 2}
    assert got.to_dict() == ref.to_dict() and repr(got) == repr(ref)
    with pytest.raises(AttributeError):
        got.no_such_knob  # noqa: B018


ENV = {"TRAINING_ROLE": "TRAINER", "PADDLE_TRAINERS_NUM": "4", "PADDLE_TRAINER_ID": "2",
       "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2,c:3,d:4", "PADDLE_PSERVERS_IP_PORT_LIST": "s:7,t:8"}


@pytest.mark.parametrize("role", ["TRAINER", "PSERVER"])
def test_role_makers_from_one_env_equal_the_reference(monkeypatch, role):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TRAINING_ROLE", role)
    monkeypatch.setenv("POD_IP", "t")
    monkeypatch.setenv("PADDLE_PORT", "8")

    def facts(m):
        return (m.is_worker(), m.is_server(), m.is_first_worker(), m.worker_index(),
                m.server_index(), m.worker_num(), m.server_num(), m.get_pserver_endpoints(),
                m.get_trainer_endpoints(), m._is_collective)

    for kw in ({}, {"is_collective": True}):
        assert facts(trole.PaddleCloudRoleMaker(**kw)) == facts(jrole.PaddleCloudRoleMaker(**kw))
    kw = dict(current_id=1, role=trole.Role.SERVER, worker_num=3, server_endpoints=["x:1"],
              worker_endpoints=["y:2", "z:3"])
    assert facts(trole.UserDefinedRoleMaker(**kw)) == facts(jrole.UserDefinedRoleMaker(**kw))
    assert (trole.Role.WORKER, trole.Role.SERVER) == (jrole.Role.WORKER, jrole.Role.SERVER)
