"""The port's ranks for tests/test_torch_moe.py and
tests/test_torch_sharded_checkpoint.py, started by the port's launcher
over gloo on the CPU (``torch_dist_worker.run_ranks``). Each rank imports
nothing of jax or the JAX package; the weights come from the port's seeded
initializers (the builders below), so the tests make the same arrays in
process for the JAX references. Each rank writes what it holds to
``OUT/rank{r}.npz``, and its checkpoints under ``OUT/ckpt-<run>``.

Modes:
- ``ep2`` (2 ranks): the MoE net over ``build_mesh(ep=2)`` in the dense,
  capacity and alltoall modes; Lamb and LARS under ZeRO-2 over dp=2 and
  over mp=2 (the three mp layers), and Lamb through
  ``build_fsdp_train_step`` over dp=2;
- ``ep4`` (4 ranks): the MoE blocks pipelined at pp=2 x ep=2 (SGD, and
  Lamb), and the capacity and alltoall nets at dp=2 x ep=2;
- ``ckpt`` (2 ranks): checkpoints through ``MultiProcessShardedManager``
  (``checkpoint.place`` by the step's layout) of a ZeRO-1 Adam run over
  dp=2 with a bf16 leaf, saved at steps 2 and 3; of the three mp layers
  at mp=2 (Adam); of the capacity net at ep=2; of the MoE pipeline at
  pp=2. Each run records its ``step_fn.layout``.
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
from paddle_tpu_torch.core import random as prandom  # noqa: E402
from paddle_tpu_torch.distributed import checkpoint, spmd, topology  # noqa: E402
from paddle_tpu_torch.distributed import pipeline as pipe  # noqa: E402
from paddle_tpu_torch.incubate.moe import MoELayer  # noqa: E402

import torch_dist_model_parallel_worker as MP  # noqa: E402

STEPS = 2
MOE_LR = 0.1  # SGD: the parameters compare at float32's sums
# (mode, experts, capacity factor) of the ep runs
MOE_RUNS = (("dense", 4, 1.25), ("capacity", 8, 1.25), ("alltoall", 8, 1.25))
TRUST = ("lamb", "lars")
TRUST_LR = 1e-2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


class MoENet(nn.Layer):
    """``x + moe(x)``, the reference's test net."""

    def __init__(self, mode, experts, cf, seed=3, hidden=8, ffn=16):
        super().__init__()
        self.moe = MoELayer(hidden, ffn, num_experts=experts, top_k=2, dispatch_mode=mode,
                            capacity_factor=cf, aux_weight=0.1, device="cpu",
                            generator=_gen(seed))

    def forward(self, x):
        return x + self.moe(x)


class MoEBlock(nn.Layer):
    """tests/test_llama_hybrid.py's pipelined MoE block."""

    def __init__(self, seed, hidden=16):
        super().__init__()
        self.moe = MoELayer(hidden, 32, num_experts=4, top_k=2, dispatch_mode="capacity",
                            capacity_factor=4.0, device="cpu", generator=_gen(seed))

    def forward(self, x):
        return x + self.moe(x)


def moe_pipe_layers():
    return ([nn.Linear(8, 16, device="cpu", generator=_gen(1))],
            [MoEBlock(40 + i) for i in range(4)],
            [nn.Linear(16, 4, device="cpu", generator=_gen(2))])


def moe_data(batch=8):
    rng = np.random.RandomState(0)
    return (rng.rand(batch, 6, 8).astype(np.float32), rng.rand(batch, 6, 8).astype(np.float32))


def moe_pipe_data():
    rng = np.random.RandomState(0)
    return rng.randn(8, 4, 8).astype(np.float32), rng.randn(8, 4, 4).astype(np.float32)


def trust_model():
    return nn.Sequential(nn.Linear(8, 16, device="cpu", generator=_gen(5)), nn.Tanh(),
                         nn.Linear(16, 4, device="cpu", generator=_gen(6)))


def trust_data():
    rng = np.random.RandomState(7)
    return rng.randn(8, 8).astype(np.float32), rng.randn(8, 4).astype(np.float32)


def trust_opt(kind, params):
    if kind == "lamb":
        return optimizer.Lamb(TRUST_LR, lamb_weight_decay=0.01, parameters=params)
    return optimizer.Lars(TRUST_LR, momentum=0.9, lars_coeff=0.05, parameters=params)


def fsdp_model():
    """A linear trunk of four identical blocks for build_fsdp_train_step."""
    return nn.Sequential(nn.Linear(8, 16, device="cpu", generator=_gen(10)),
                         *[nn.Linear(16, 16, device="cpu", generator=_gen(11 + i))
                           for i in range(4)],
                         nn.Linear(16, 4, device="cpu", generator=_gen(15)))


def zero1_model():
    """The checkpointed ZeRO-1 net."""
    return nn.Sequential(nn.Linear(8, 16, device="cpu", generator=_gen(8)), nn.Tanh(),
                         nn.Linear(16, 4, device="cpu", generator=_gen(9)))


def mse(o, t):
    return ((o.float() - t) ** 2).mean()


def put(res, prefix, tree):
    MP.put(res, prefix, tree)


def save(out, run, step_fn, params, st, step):
    """This rank's state through the sharded manager at ``step``."""
    manager = checkpoint.sharded_checkpoint_manager(os.path.join(out, f"ckpt-{run}"))
    manager.save(checkpoint.place({"params": params, "opt_state": st}, step_fn.layout), step)


def train(res, out, run, build, data, steps=STEPS, lr=None, ckpt=False):
    step_fn, init = build()
    params, st = init()
    x, y = (torch.from_numpy(a) for a in data)
    for i in range(steps):
        loss, params, st = step_fn(params, st, x, y, key=prandom.PRNGKey(0), lr=lr)
        res[f"{run}/loss{i}"] = np.array(float(loss))
    put(res, f"{run}/param/", params)
    put(res, f"{run}/state/", st)
    if ckpt:
        save(out, run, step_fn, params, st, steps)
        res[f"{run}/layout"] = np.array(json.dumps(step_fn.layout))
    return step_fn, params, st


def run_ep(res, out, mesh, tag, runs=MOE_RUNS, ckpt=False):
    dg = spmd.DataGroup(mesh)
    for mode, experts, cf in runs:
        net = MoENet(mode, experts, cf)
        x, y = moe_data()

        def build(net=net):
            return spmd.build_train_step(net, mse, optimizer.SGD(MOE_LR, parameters=net
                                                                  .parameters()), mesh=mesh)
        train(res, out, f"{tag}_{mode}", build, (MP.rows(x, dg.rank, dg.n),
                                                  MP.rows(y, dg.rank, dg.n)), ckpt=ckpt)
        assert net.moe.aux_loss is None  # collected into the loss, cleared


def run_trust(res, out, rank):
    for kind in TRUST:
        model = trust_model()
        x, y = trust_data()
        mesh = topology.build_mesh(dp=2)

        def build(model=model, kind=kind, mesh=mesh):
            return spmd.build_train_step(model, mse, trust_opt(kind, model.parameters()),
                                         mesh=mesh, sharding_stage=2)
        train(res, out, f"zero2_{kind}", build, (MP.rows(x, rank, 2), MP.rows(y, rank, 2)))
        model = MP.mp_layers_model()
        ids, y = MP.mp_layers_data()
        mesh = topology.build_mesh(mp=2)

        def build(model=model, kind=kind, mesh=mesh):
            return spmd.build_train_step(model, mse, trust_opt(kind, model.parameters()),
                                         mesh=mesh)
        train(res, out, f"mp2_{kind}", build, (ids, y))
    model = fsdp_model()
    x, y = trust_data()

    def build():
        return spmd.build_fsdp_train_step(model, mse, trust_opt("lamb", model.parameters()),
                                          mesh=topology.build_mesh(dp=2))
    train(res, out, "fsdp_lamb", build, (MP.rows(x, rank, 2), MP.rows(y, rank, 2)))


def run_mp_ckpt(res, out):
    model = MP.mp_layers_model()
    ids, y = MP.mp_layers_data()
    mesh = topology.build_mesh(mp=2)

    def build():
        return spmd.build_train_step(model, mse, optimizer.Adam(1e-2, parameters=model
                                                                .parameters()), mesh=mesh)
    train(res, out, "mp2", build, (ids, y), ckpt=True)


def run_zero1_bf16(res, out, rank):
    """ZeRO-1 Adam over dp=2; the saved state adds a bf16 copy of the
    parameters (a bf16 leaf)."""
    model = zero1_model()
    x, y = trust_data()
    mesh = topology.build_mesh(dp=2)
    step_fn, init = spmd.build_train_step(
        model, mse, optimizer.Adam(1e-2, parameters=model.parameters()), mesh=mesh,
        sharding_stage=1)
    params, st = init()
    xr, yr = (torch.from_numpy(MP.rows(a, rank, 2)) for a in (x, y))
    for i in range(STEPS):
        loss, params, st = step_fn(params, st, xr, yr, key=prandom.PRNGKey(0))
        res[f"zero1/loss{i}"] = np.array(float(loss))
    put(res, "zero1/param/", params)
    put(res, "zero1/state/", st)
    state = checkpoint.place({"params": params, "opt_state": st}, step_fn.layout)
    state["bf16"] = {n: p.to(torch.bfloat16) for n, p in params.items()}
    state["step"] = np.int64(STEPS)
    manager = checkpoint.sharded_checkpoint_manager(os.path.join(out, "ckpt-zero1"))
    manager.save(state, STEPS)
    # a second save of the same state at a later step: the test corrupts
    # it and the load falls back to the first
    manager.save(state, STEPS + 1)
    res["zero1/layout"] = np.array(json.dumps(step_fn.layout))


def run_pipe_ep(res, out, mesh, tag, ckpt=False, lamb=False):
    pre, trunk, post = moe_pipe_layers()
    dg = spmd.DataGroup(mesh)
    x, y = moe_pipe_data()

    def build():
        params = [p for l in pre + trunk + post for p in l.parameters()]
        opt = trust_opt("lamb", params) if lamb else optimizer.SGD(0.01, parameters=params)
        return pipe.build_pipeline_train_step(pre, trunk, post, mse, opt, mesh=mesh,
                                              num_micro=2, donate=False)
    train(res, out, tag, build, (MP.rows(x, dg.rank, dg.n), MP.rows(y, dg.rank, dg.n)),
          ckpt=ckpt)
    res[f"{tag}/coord"] = np.array([mesh.rank_in("pp"), mesh.rank_in("ep")])


def main():
    mode, out = sys.argv[1], sys.argv[2]
    paddle.set_device("cpu")
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {}
    if mode == "ep2":
        run_ep(res, out, topology.build_mesh(ep=2), "ep2")
        run_trust(res, out, rank)
    elif mode == "ep4":
        run_pipe_ep(res, out, topology.build_mesh(pp=2, ep=2), "pp2ep2")
        run_pipe_ep(res, out, topology.build_mesh(pp=2, ep=2), "pp2ep2_lamb", lamb=True)
        run_ep(res, out, topology.build_mesh(dp=2, ep=2), "dp2ep2", MOE_RUNS[1:])
    elif mode == "ckpt":
        run_zero1_bf16(res, out, rank)
        run_mp_ckpt(res, out)
        run_ep(res, out, topology.build_mesh(ep=2), "ep2", MOE_RUNS[1:2], ckpt=True)
        run_pipe_ep(res, out, topology.build_mesh(pp=2), "pp2", ckpt=True)
    else:
        raise SystemExit(f"unknown mode {mode}")
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, world=world), f)
    dist.barrier()


if __name__ == "__main__":
    main()
