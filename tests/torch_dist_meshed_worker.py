"""The port's ranks for tests/test_torch_dist_meshed.py, started by the
port's launcher over gloo on the CPU (``torch_dist_worker.run_ranks``).
Each rank imports nothing of jax or the JAX package, trains what the test
built on the JAX side (the weights come as npz files in ``DATA``) and
writes what it holds to ``OUT/rank{r}.npz`` (and ``.json``).

Modes:
- ``meshed`` (2 ranks): the tiny BERT through ZeRO stages 0-3 on
  ``build_mesh(dp=1, sharding=2)`` (and the stage given by a strategy, by
  ``shard_optimizer``, by a layer's tag, and stage 2 with offload), FSDP
  over a tiny Sequential, the comm_opt modes over the MLP of
  tests/test_comm_opt.py on ``build_mesh(dp=2)``, a conv net with
  BatchNorm over that mesh, and ``group_sharded_parallel``'s eager step;
- ``zero4`` (4 ranks): the tiny BERT through ZeRO stages 0-3 on
  ``build_mesh(dp=2, sharding=2)``.
"""
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
from paddle_tpu_torch import nn, optimizer  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.core import random as prandom  # noqa: E402
from paddle_tpu_torch.distributed import comm_opt, sharding, spmd, topology  # noqa: E402
from paddle_tpu_torch.distributed.fleet import DistributedStrategy  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

# FSDP's tiny Sequential: an embedding, a trunk of identical encoder
# layers, a head to the vocabulary at every position
FSDP = dict(vocab=32, d=16, heads=2, ff=32, layers=3, seq=8, batch=8)
CONV = dict(batch=8, hw=8, classes=4, lr=0.1)
COMM_STEPS = dict(fp16=4, dgc=6, localsgd=4, adaptive=6)
DGC = {"sparsity": [0.8], "momentum": 0.9}
EAGER_STEPS = 3


def fsdp_model():
    f = FSDP
    return nn.Sequential(nn.Embedding(f["vocab"], f["d"]),
                         *[nn.TransformerEncoderLayer(f["d"], f["heads"], f["ff"], dropout=0.1)
                           for _ in range(f["layers"])],
                         nn.Linear(f["d"], f["vocab"]))


def fsdp_batch():
    rng = np.random.RandomState(5)
    f = FSDP
    return (rng.randint(0, f["vocab"], (f["batch"], f["seq"])).astype(np.int32),
            rng.randint(0, f["vocab"], (f["batch"], f["seq"])).astype(np.int32))


def mlp_model():
    return nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))


def mlp_data():
    """tests/test_comm_opt.py's data."""
    x = np.random.RandomState(0).rand(16, 8).astype(np.float32)
    y = np.random.RandomState(1).rand(16, 4).astype(np.float32)
    return x, y


def conv_model():
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4), nn.ReLU(),
                         nn.AdaptiveAvgPool2D(1), nn.Flatten(), nn.Linear(4, CONV["classes"]))


def conv_batch():
    rng = np.random.RandomState(9)
    c = CONV
    return (rng.randn(c["batch"], 3, c["hw"], c["hw"]).astype(np.float32),
            rng.randint(0, c["classes"], (c["batch"],)).astype(np.int32))


def ce_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0].mean()


def mse_loss(out, y):
    return torch.mean((out - y) ** 2)


def local(arrays, rank, world):
    b = arrays[0].shape[0] // world
    return [torch.from_numpy(a[rank * b:(rank + 1) * b]) for a in arrays]


def put(res, prefix, tree):
    """Flatten a {name: tensor or tuple of tensors} tree into ``res``, as
    copies (the steps update their tensors in place)."""
    for n, v in tree.items():
        if isinstance(v, dict):
            put(res, f"{prefix}{n}/", v)
        elif isinstance(v, (tuple, list)):
            for i, t in enumerate(v):
                res[f"{prefix}{n}/{i}"] = t.detach().numpy().copy()
        else:
            res[f"{prefix}{n}"] = v.detach().numpy().copy()


def nbytes(tree):
    return sum(t.numel() * t.element_size() for v in tree.values()
               for t in (v if isinstance(v, tuple) else (v,)))


def run_zero(res, rank, world, weights, variants):
    """The tiny BERT's three steps at each ZeRO variant; a run's losses,
    its rank's params and state blocks, its first step's moments and its
    bytes at rest."""
    mesh = (topology.build_mesh(dp=1, sharding=2) if world == 2
            else topology.build_mesh(dp=2, sharding=2))
    x, y = W.mesh_batch()
    x, y = local((x, y), rank, world)
    keys = W.step_keys()
    for name, kw in variants:
        build, args = W.mesh_parts(weights)
        wrapper, loss_fn, opt, _ = args
        if kw.pop("tag", None):
            wrapper._sharding_stage = 3
        step, init = build(wrapper, loss_fn, opt, mesh=mesh, **kw)
        params, state = init()
        res[f"{name}/bytes"] = np.array([nbytes(params), nbytes(state)])
        for i, key in enumerate(keys):
            loss, params, state = step(params, state, x, y, key=key)
            res[f"{name}/loss{i}"] = loss.numpy()
            if i == 0:
                put(res, f"{name}/moment0/", {n: st[0] for n, st in state.items()})
        put(res, f"{name}/param/", params)
        put(res, f"{name}/state/", state)
        res[f"{name}/dims"] = np.array([-1 if d is None else d for d in step.zero_dims.values()])


def run_fsdp(res, rank, world, weights):
    mesh = topology.build_mesh(dp=world)
    x, y = local(fsdp_batch(), rank, world)
    for recompute in (True, False):
        model = fsdp_model()
        load_numpy_state(model, dict(np.load(weights)))
        opt = optimizer.AdamW(W.LR, parameters=model.parameters(), weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        step, init = spmd.build_fsdp_train_step(model, ce_loss, opt, mesh=mesh,
                                                recompute=recompute)
        params, state = init()
        peaks = []
        for i, key in enumerate(W.step_keys()):
            step.tracker.reset()
            loss, params, state = step(params, state, x, y, key=key)
            peaks.append(step.tracker.peak)
            if recompute:
                res[f"fsdp/loss{i}"] = loss.numpy()
        tag = "fsdp" if recompute else "fsdp_plain"
        res[f"{tag}/peaks"] = np.array(peaks + [step.tracker.alive])
        if recompute:
            put(res, "fsdp/param/", params)
            put(res, "fsdp/state/", state)


def run_comm(res, rank, world, weights):
    """fp16_allreduce, DGC, LocalSGD and adaptive LocalSGD over the MLP;
    each mode's losses, the rank's params (its replica), DGC's (u, v) and
    adaptive LocalSGD's k at each step."""
    mesh = topology.build_mesh(dp=world)
    topology.set_global_mesh(mesh)
    x, y = local(mlp_data(), rank, world)
    modes = dict(fp16=dict(fp16_allreduce=True), dgc=dict(dgc_configs=dict(DGC)))
    s = DistributedStrategy()
    s.localsgd = True
    s.localsgd_configs = {"k_steps": 2}
    modes["localsgd"] = dict(strategy=s)
    s = DistributedStrategy()
    s.adaptive_localsgd = True
    s.adaptive_localsgd_configs = {"init_k_steps": 2, "begin_step": 2}
    modes["adaptive"] = dict(strategy=s)
    for mode, kw in modes.items():
        model = mlp_model()
        load_numpy_state(model, dict(np.load(weights)))
        opt = optimizer.SGD(0.2, parameters=model.parameters())
        step, init = spmd.build_train_step(model, mse_loss, opt, mesh=mesh, **kw)
        params, state = init()
        ks, snaps = [], []
        for i in range(COMM_STEPS[mode]):
            loss, params, state = step(params, state, x, y)
            res[f"{mode}/loss{i}"] = loss.numpy()
            if mode == "adaptive":
                ks.append(int(step.comm_state["comm"]["k"]))
            put(res, f"{mode}/step{i}/", params)
        res[f"{mode}/k"] = np.array(ks)
        if mode == "fp16":
            res["fp16/comm_bytes"] = np.array([step.comm_stats.get("float16", 0),
                                               step.comm_stats.get("float32", 0)])
        if mode == "dgc":
            put(res, "dgc/comm/", state["__comm__"])
        if mode == "localsgd":
            avg = comm_opt.average_params(params, model)
            put(res, "localsgd/avg/", avg)


def run_bn(res, rank, world, weights):
    mesh = topology.build_mesh(dp=world)
    x, y = local(conv_batch(), rank, world)
    model = conv_model()
    load_numpy_state(model, dict(np.load(weights)))
    opt = optimizer.SGD(CONV["lr"], parameters=model.parameters())
    step, init = spmd.build_train_step(model, ce_loss, opt, mesh=mesh)
    params, state = init()
    for i, key in enumerate(W.step_keys()):
        loss, params, state = step(params, state, x, y, key=key)
        res[f"bn/loss{i}"] = loss.numpy()
    put(res, "bn/param/", params)
    put(res, "bn/buffer/", dict(model.named_buffers()))


def run_eager(res, rank, world, out):
    """DataParallel with and without group_sharded_parallel('os_g'): the
    parameters after each step, and the accumulators' bytes."""
    x, y = local(mlp_data(), rank, world)
    topology.set_global_mesh(topology.build_mesh(dp=world))
    for how in ("plain", "sharded"):
        paddle.seed(5)
        model = mlp_model()
        ddp = dist.DataParallel(model)
        opt = optimizer.AdamW(0.01, parameters=model.parameters(),
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        if how == "sharded":
            ddp, opt, _ = sharding.group_sharded_parallel(ddp, opt, level="os_g")
        for i in range(EAGER_STEPS):
            loss = mse_loss(ddp(paddle.to_tensor(x)), paddle.to_tensor(y))
            loss.backward()
            ddp.apply_collective_grads()
            opt.step()
            opt.clear_grad()
            put(res, f"eager_{how}/step{i}/", dict(model.named_parameters()))
        res[f"eager_{how}/acc_bytes"] = np.array(nbytes(
            {str(k): v for k, v in opt._accumulators.items()}))
        # by position: the runs' parameters have names of their own
        put(res, f"eager_{how}/opt/", dict(enumerate(opt.state_dict()["accumulators"].values())))
        if how == "sharded":
            res["eager_sharded/stage"] = np.array([model._sharding_stage if hasattr(
                model, "_sharding_stage") else ddp._sharding_stage, opt._sharding_stage])
            sharding.save_group_sharded_model(ddp, os.path.join(out, "gsm"), opt)


def main():
    mode, out = sys.argv[1], sys.argv[2]
    paddle.set_device("cpu")
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    data = sys.argv[3]
    res = {}
    if mode == "meshed":
        run_zero(res, rank, world, os.path.join(data, "bert.npz"), [
            ("s0", {}), ("s1", dict(sharding_stage=1)), ("s2", dict(sharding_stage=2)),
            ("s3", dict(sharding_stage=3)), ("shard_optimizer", dict(shard_optimizer=True)),
            ("strategy2", dict(strategy=_sharding_strategy(2))), ("tag3", dict(tag=True)),
            ("offload2", dict(sharding_stage=2, offload=True))])
        run_fsdp(res, rank, world, os.path.join(data, "fsdp.npz"))
        run_comm(res, rank, world, os.path.join(data, "mlp.npz"))
        run_bn(res, rank, world, os.path.join(data, "conv.npz"))
        run_eager(res, rank, world, out)
    elif mode == "zero4":
        run_zero(res, rank, world, os.path.join(data, "bert.npz"),
                 [(f"s{k}", dict(sharding_stage=k)) for k in range(4)])
    else:
        raise SystemExit(f"unknown mode {mode}")
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, world=world), f)
    dist.barrier()


def _sharding_strategy(stage):
    s = DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"stage": stage}
    return s


if __name__ == "__main__":
    main()
