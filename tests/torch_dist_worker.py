"""The port's ranks for tests/test_torch_dist_*.py: started by the port's
launcher (``python -m paddle_tpu_torch.distributed.launch --backend gloo
--nproc_per_node N tests/torch_dist_worker.py MODE OUT ...``) or by
``spawn(backend="cpu")``. Each rank runs on the CPU over gloo, imports
nothing of jax or the JAX package, and writes what it saw to ``OUT``
(``rank{r}.npz`` or ``.json``); the test holds that against numpy and the
JAX package in its own process.

Modes: ``collectives`` (every op, the topology, p2p, fleet.metrics,
UtilBase, DistributedBatchSampler), ``mesh_step`` (a 2-layer BERT through
``build_train_step(mesh=build_mesh(dp=2))``), ``bad_step`` (a NaN fed to
rank 1 only, under ``bad_step_guard``), ``eager_ddp`` (DataParallel and
the fleet facade).
"""
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
from paddle_tpu_torch.distributed import collective as C  # noqa: E402
from paddle_tpu_torch.distributed import fleet, p2p, spmd, topology  # noqa: E402

# the mesh step's model and data (the test builds the same on the JAX side)
BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
SEQ, PRED, GLOBAL_BATCH, LR, STEPS = 16, 4, 8, 1e-4, 3


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120  # seconds a spawned run may take before its test fails


def run_ranks(mode, out, *args, nproc=2, timeout=RANK_TIMEOUT, transient_retries=2,
              worker=__file__):
    """Start ``nproc`` ranks of ``mode`` of ``worker`` (this file by
    default) through the port's launcher (gloo, the CPU) in a session of
    their own, wait at most ``timeout`` seconds (then kill the whole
    session), and return the launcher's exit code and output with the
    ranks' logs. A run whose log shows gloo's transient TCP framing abort
    (launch_mod._TRANSIENT_RE) is started again up to
    ``transient_retries`` times, as the reference's tests pass
    ``transient_retries=2`` to its launcher."""
    from paddle_tpu_torch.distributed.launch_mod import _TRANSIENT_RE

    for _ in range(transient_retries + 1):
        rc, text = _run_ranks_once(mode, out, args, nproc, timeout, worker)
        if rc == 0 or not _TRANSIENT_RE.search(text):
            break
    return rc, text


def _run_ranks_once(mode, out, args, nproc, timeout, worker):
    import shutil
    import signal
    import subprocess

    shutil.rmtree(os.path.join(out, "logs"), ignore_errors=True)

    logs = os.path.join(out, "logs")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--nproc_per_node",
           str(nproc), "--backend", "gloo", "--log_dir", logs, os.path.abspath(worker), mode,
           str(out), *map(str, args)]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        text = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text = proc.communicate()[0] + f"\n[killed after {timeout} s]"
        proc.returncode = -signal.SIGKILL
    if os.path.isdir(logs):
        for name in sorted(os.listdir(logs)):
            with open(os.path.join(logs, name), errors="replace") as f:
                text += f"\n--- {name} ---\n" + f.read()[-4000:]
    return proc.returncode, text


def values(rank, shape=(3, 4), dtype=np.float32):
    """Rank r's operand of the collectives: distinct, exact in float32."""
    return (np.arange(np.prod(shape)).reshape(shape) * (rank + 2) - 5 * rank).astype(dtype)


def mesh_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, BERT["vocab_size"], (GLOBAL_BATCH, SEQ))
    pos = np.stack([rng.choice(SEQ, PRED, replace=False) for _ in range(GLOBAL_BATCH)])
    labels = rng.randint(0, BERT["vocab_size"], (GLOBAL_BATCH, PRED)).astype(np.int32)
    return np.concatenate([ids, pos], 1).astype(np.int32), labels


def step_keys():
    from paddle_tpu_torch.core import random as prandom

    return [prandom.fold_in(prandom.PRNGKey(0), i) for i in range(STEPS)]


class TrainWrapper(torch.nn.Module):
    """bench.py's wrapper: packed [ids | masked positions] in, MLM logits out."""

    def __init__(self, inner, seq_len):
        super().__init__()
        self.inner = inner
        self.seq_len = seq_len

    def forward(self, packed):
        return self.inner(packed[:, :self.seq_len],
                          masked_positions=packed[:, self.seq_len:])[0]


def mlm_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0].mean()


def mesh_parts(weights):
    """(step, init, wrapper) of the mesh step over the job's dp=2 mesh,
    with the JAX model's weights from ``weights`` (an npz path)."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.convert import load_numpy_state
    from paddle_tpu_torch.text.models import BertForPretraining

    wrapper = TrainWrapper(BertForPretraining(**BERT, device="cpu"), SEQ)
    load_numpy_state(wrapper, dict(np.load(weights)))
    opt = optimizer.AdamW(LR, parameters=wrapper.parameters(), weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    mesh = topology.build_mesh(dp=2)
    return spmd.build_train_step, (wrapper, mlm_loss, opt, mesh)


def run_collectives(rank, world, out):
    res = {}
    x = torch.from_numpy(values(rank))
    for op in ("sum", "max", "min", "prod", "avg"):
        t = x.clone()
        dist.all_reduce(t, op)
        res[f"all_reduce_{op}"] = t.numpy()
    t = x.clone()
    res["broadcast"] = dist.broadcast(t, src=1).numpy()
    gathered = dist.all_gather([], x.clone())
    res["all_gather"] = np.stack([g.numpy() for g in gathered])
    t = x.clone()
    dist.reduce(t, dst=0)
    if rank == 0:
        res["reduce"] = t.numpy()
    parts = [torch.full((2,), 10.0 * i + 1) for i in range(world)]
    t = torch.zeros(2)
    dist.scatter(t, parts if rank == 0 else None, src=0)
    res["scatter"] = t.numpy()
    outs = []
    dist.all_to_all(outs, [torch.full((2,), 100.0 * rank + j) for j in range(world)])
    res["all_to_all"] = np.stack([o.numpy() for o in outs])
    t = torch.zeros(4, 3)
    dist.alltoall_single(t, torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * rank)
    res["alltoall_single"] = t.numpy()
    dist.barrier()
    if rank == 0:
        dist.send(x.clone() * 3, dst=1)
    else:
        t = torch.zeros(3, 4)
        dist.recv(t, src=0)
        res["recv"] = t.numpy()
    res["psum"] = C.psum(x, "dp").numpy()
    res["pmean"] = C.pmean(x, "dp").numpy()
    res["all_gather_spmd"] = C.all_gather_spmd(x, "dp").numpy()
    res["ppermute"] = C.ppermute(x, "dp", [(0, 1), (1, 0)]).numpy()
    # p2p Transport: two tags on one edge, received in the other order
    tr = p2p.get_transport()
    if rank == 0:
        tr.send("dp", 1, values(7), tag=1)
        tr.send("dp", 1, values(8), tag=2)
    else:
        res["p2p_tag2"] = tr.recv("dp", 0, tag=2, timeout=60)
        res["p2p_tag1"] = tr.recv("dp", 0, tag=1, timeout=60)
    dist.barrier()
    # fleet.metrics / UtilBase over host values: each rank its half
    data = np.random.RandomState(3).rand(2, 10)
    mine = data[rank]
    util = fleet.UtilBase()
    res["util_sum"] = util.all_reduce(mine, "sum")
    res["util_max"] = util.all_reduce(mine, "max")
    res["util_gather"] = np.stack(util.all_gather(mine.astype(np.int64) + rank))
    pos, neg = np.random.RandomState(4).randint(0, 9, (2, 2, 16))
    res["metrics"] = np.array([
        fleet.metrics.sum(mine), fleet.metrics.max(mine), fleet.metrics.min(mine),
        fleet.metrics.auc(pos[rank], neg[rank]), fleet.metrics.mae(mine, 10),
        fleet.metrics.mse(mine, 10), fleet.metrics.rmse(mine, 10),
        fleet.metrics.acc(mine, mine + 1)])
    res["file_shard"] = np.array(util.get_file_shard([f"f{i}" for i in range(5)]))
    util.barrier()
    # DistributedBatchSampler: the job's world and rank when not given
    sampler = paddle.io.DistributedBatchSampler(list(range(11)), batch_size=2, shuffle=True)
    res["sampler"] = np.array([sampler.nranks, sampler.local_rank])
    res["sampler_batches"] = np.array([i for b in sampler for i in b])
    # the topology: HybridCommunicateGroup over this 2-rank job
    topo = {}
    for shape in (dict(dp=2), dict(mp=2), dict(pp=2), dict(sharding=2)):
        hcg = topology.HybridCommunicateGroup(**shape)
        key = ",".join(f"{k}{v}" for k, v in shape.items())
        topo[key] = dict(
            mode=hcg.get_parallel_mode(),
            ranks=[hcg.get_data_parallel_rank(), hcg.get_pipe_parallel_rank(),
                   hcg.get_sharding_parallel_rank(), hcg.get_model_parallel_rank()],
            sizes=[hcg.get_data_parallel_world_size(), hcg.get_model_parallel_world_size(),
                   hcg.get_pipe_parallel_world_size(),
                   hcg.get_sharding_parallel_world_size()],
            mesh=hcg.mesh.shape, coord=list(hcg.mesh.coord))
        # the axis of size 2 holds a group: a collective over it sums both ranks
        axis = {"dp": "dp", "mp": "mp", "pp": "pp", "sharding": "sharding"}[next(iter(shape))]
        topo[key]["axis_sum"] = float(dist.all_reduce(torch.tensor([rank + 1.0]), "sum",
                                                      axis).item())
    topology.set_global_mesh(topology.build_mesh(dp=world))
    res["world"] = np.array([dist.get_world_size(), dist.get_rank(),
                             dist.ParallelEnv().world_size, dist.ParallelEnv().rank])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    with open(os.path.join(out, f"topology{rank}.json"), "w") as f:
        json.dump(topo, f)


def run_mesh_step(rank, world, out, weights):
    build, args = mesh_parts(weights)
    step, init = build(*args)
    x, y = mesh_batch()
    b = GLOBAL_BATCH // world
    x, y = spmd.shard_batch(x[rank * b:(rank + 1) * b]), spmd.shard_batch(y[rank * b:(rank + 1) * b])
    params, state = init()
    res = {}
    for i, key in enumerate(step_keys()):
        loss, params, state = step(params, state, x, y, key=key)
        res[f"loss{i}"] = loss.numpy()
        if i == 0:
            for n, st in state.items():
                res[f"grad0/{n}"] = (st[0] / (1 - 0.9)).numpy()
    for n, p in params.items():
        res[f"param/{n}"] = p.numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def run_bad_step(rank, world, out, weights):
    build, args = mesh_parts(weights)
    step, init = build(*args, bad_step_guard=True)
    x, y = mesh_batch()
    b = GLOBAL_BATCH // world
    x, y = torch.from_numpy(x[rank * b:(rank + 1) * b]), torch.from_numpy(y[rank * b:(rank + 1) * b])
    params, state = init()
    before = {n: p.clone() for n, p in params.items()}
    keys = step_keys()
    loss0, params, state, bad0 = step(params, state, x, y, key=keys[0])
    after_good = {n: p.clone() for n, p in params.items()}
    # rank 1's word embeddings poisoned for one step: the local gradient
    # of rank 1 only is NaN, the all-reduce carries it to both ranks
    wrapper = args[0]
    word = "inner.bert.embeddings.word_embeddings.weight"
    saved = params[word].clone()
    if rank == 1:
        params[word][0] = float("nan")
    loss1, params, state, bad1 = step(params, state, x, y, key=keys[1])
    if rank == 1:
        params[word].copy_(saved)
    kept = all(torch.equal(params[n], after_good[n]) for n in params if n != word)
    moved = not all(torch.equal(after_good[n], before[n]) for n in params)
    del wrapper
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(dict(bad=[bool(bad0), bool(bad1)], loss0=float(loss0), loss1=float(loss1),
                       kept=kept, first_step_moved=moved,
                       word_equal=bool(torch.equal(params[word], saved))), f)


def run_eager_ddp(rank, world, out):
    """dist_eager_ddp_worker.py's run, then the fleet facade's."""
    from paddle_tpu_torch import nn, optimizer

    x = np.random.RandomState(0).rand(16, 8).astype(np.float32)
    y = np.random.RandomState(1).rand(16, 4).astype(np.float32)
    half = 16 // world
    xl = paddle.to_tensor(x[rank * half:(rank + 1) * half])
    yl = paddle.to_tensor(y[rank * half:(rank + 1) * half])
    res = {}
    for how in ("ddp", "fleet", "fused"):
        paddle.seed(5)
        model = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
        np.savez(os.path.join(out, f"init_{how}{rank}.npz"),
                 **{n: p.detach().numpy() for n, p in model.named_parameters()})
        if how == "ddp":
            ddp = dist.DataParallel(model)
            opt = optimizer.SGD(0.1, parameters=model.parameters())
        elif how == "fleet":
            strategy = fleet.DistributedStrategy()
            fleet.init(is_collective=True, strategy=strategy)
            ddp = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(optimizer.SGD(0.1, parameters=model.parameters()))
            fleet.barrier_worker()
        else:
            # fleet.utils' glue: rank 1's weights moved, then rank 0's
            # broadcast over the dp group; gradients averaged by
            # fused_allreduce_gradients instead of apply_collective_grads
            hcg = fleet.get_hybrid_communicate_group()
            if rank == 1:
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(1.0)
            fleet.utils.broadcast_dp_parameters(model, hcg)
            ddp = model
            opt = optimizer.SGD(0.1, parameters=model.parameters())
        mse = nn.MSELoss()
        losses = []
        for _ in range(3):
            loss = mse(ddp(xl), yl)
            loss.backward()
            if how == "fused":
                fleet.utils.fused_allreduce_gradients(list(model.parameters()), hcg)
            else:
                ddp.apply_collective_grads()
            opt.step()
            opt.clear_grad()
            g = dist.all_gather([], torch.as_tensor(loss.numpy()).reshape(1))
            losses.append(float(np.mean([v.item() for v in g])))
        res[how] = losses
        res[how + "_params"] = {n: p.detach().numpy().tolist()
                                for n, p in model.named_parameters()}
    res["fleet"] = dict(worker_num=fleet.worker_num(), worker_index=fleet.worker_index(),
                        is_first_worker=fleet._fleet_singleton.is_first_worker(),
                        mode=fleet.get_hybrid_communicate_group().get_parallel_mode(),
                        losses=res["fleet"])
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def spawned(out):
    """``spawn(backend="cpu")``'s function: init, one all-reduce, a file."""
    dist.init_parallel_env()
    rank = dist.get_rank()
    t = dist.all_reduce(torch.tensor([rank + 1.0]))
    with open(os.path.join(out, f"spawned{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, world=dist.get_world_size(), sum=t.item(),
                       device=str(t.device), backend=os.environ["PADDLE_DISTRI_BACKEND"]), f)


def main():
    mode, out = sys.argv[1], sys.argv[2]
    paddle.set_device("cpu")
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    if mode == "collectives":
        run_collectives(rank, world, out)
    elif mode == "mesh_step":
        run_mesh_step(rank, world, out, sys.argv[3])
    elif mode == "bad_step":
        run_bad_step(rank, world, out, sys.argv[3])
    elif mode == "eager_ddp":
        run_eager_ddp(rank, world, out)
    else:
        raise SystemExit(f"unknown mode {mode}")
    dist.barrier()


if __name__ == "__main__":
    main()
