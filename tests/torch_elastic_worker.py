"""An elastic pod trainer of the port for tests/test_torch_elastic.py (the
counterpart of tests/elastic_worker.py), started by the port's launcher
over gloo on the CPU. It imports nothing of jax or the JAX package.

Every rank trains one global dp=world mesh with ZeRO-1 (the optimizer
state is really sharded across the processes) and runs the elastic
protocol with a non-blocking client (training with collectives must not
park at a boundary). A consensus save goes through
``MultiProcessShardedManager`` with the client's barrier; the rank writes
its state (``REPORT/state-<rank>.npz``) and ``REPORT/rank-<rank>.json``
with the saved step and exits 143. A completed run writes its final step
and losses and exits 0.

argv: ckpt_root report_dir total_steps
env:  PADDLE_TPU_CHAOS  fault spec (``chaos.arm_from_env``; a SIGTERM at
      ``train.step`` on one rank is the preemption)
      PADDLE_TPU_ELASTIC_*  protocol knobs (``resilience.elastic``)
"""
import os
import signal
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
from paddle_tpu_torch import nn, optimizer  # noqa: E402
from paddle_tpu_torch.distributed import checkpoint, spmd, topology  # noqa: E402
from paddle_tpu_torch.obs import goodput  # noqa: E402
from paddle_tpu_torch.resilience import chaos, elastic, preemption  # noqa: E402
from paddle_tpu_torch.resilience.checkpoint import atomic_write_json  # noqa: E402

GLOBAL_BATCH = 16


def model_and_step(mesh):
    """The pod's model (seeded) and its ZeRO-1 Adam step over ``mesh``."""
    g = torch.Generator().manual_seed(7)
    model = nn.Sequential(nn.Linear(8, 16, device="cpu", generator=g), nn.Tanh(),
                          nn.Linear(16, 4, device="cpu", generator=g))
    opt = optimizer.Adam(1e-2, parameters=model.parameters())
    return spmd.build_train_step(model, lambda o, t: ((o - t) ** 2).mean(), opt, mesh=mesh,
                                 sharding_stage=1)


def batch(i, rank, world):
    rng = np.random.RandomState(1000 + i)
    x = rng.rand(GLOBAL_BATCH, 8).astype(np.float32)
    y = rng.rand(GLOBAL_BATCH, 4).astype(np.float32)
    k = GLOBAL_BATCH // world
    rows = slice(rank * k, (rank + 1) * k)
    return torch.from_numpy(x[rows]), torch.from_numpy(y[rows])


def flat(params, st):
    out = {f"param/{n}": p.numpy() for n, p in params.items()}
    out.update({f"state/{n}/{i}": a.numpy() for n, v in st.items() for i, a in enumerate(v)})
    return out


def main():
    ckpt_root, report_dir, total_steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
    paddle.set_device("cpu")
    chaos.arm_from_env()
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = topology.build_mesh(dp=world)
    step_fn, init_fn = model_and_step(mesh)
    params, st = init_fn()
    handler = preemption.get_preemption_handler()
    handler.install(signals=(signal.SIGTERM,))
    el = elastic.init_from_env(handler=handler, block=False)
    manager = checkpoint.sharded_checkpoint_manager(ckpt_root, rank=rank, world=world)
    os.makedirs(report_dir, exist_ok=True)

    def report(payload):
        atomic_write_json(os.path.join(report_dir, f"rank-{rank}.json"), payload)

    losses, step = [], 0
    try:
        while step < total_steps:
            t0 = time.perf_counter()
            chaos.hit("train.step")
            x, y = batch(step, rank, world)
            loss, params, st = step_fn(params, st, x, y)
            losses.append(float(loss))
            step += 1
            el.note_step(step, time.perf_counter() - t0)
            target = el.check_boundary(step)
            if target is not None and step >= target:
                t0 = time.perf_counter()
                manager.save(checkpoint.place({"params": params, "opt_state": st,
                                               "step": np.int64(step)}, step_fn.layout), step)
                save_s = time.perf_counter() - t0
                if rank == 0:
                    preemption.write_resume_marker(ckpt_root, step=step, world_size=world)
                el.saved(step)
                if rank == 0:
                    # the coordinator lives in this process: keep it until
                    # every rank is past its publish barrier
                    deadline = time.monotonic() + 30
                    while (len(el.status().get("saved", {})) < world
                           and time.monotonic() < deadline):
                        time.sleep(0.02)
                np.savez(os.path.join(report_dir, f"state-{rank}.npz"), **flat(params, st))
                report({"preempted": True, "step": step, "rank": rank, "losses": losses,
                        "save_s": save_s, "goodput_steps": goodput.report()["steps"]})
                el.close()
                raise preemption.PreemptedExit(step=step)
        target = el.finish_and_drain(step)
    except elastic.ElasticError as e:
        report({"aborted": str(e), "rank": rank})
        el.close()
        sys.exit(preemption.EXIT_CODE)
    report({"completed": True, "final_step": step, "rank": rank, "losses": losses,
            "drain": target})
    el.close()


if __name__ == "__main__":
    main()
