"""The port's ranks for tests/test_torch_dist_model_parallel.py and
tests/test_torch_ring_attention.py, started by the port's launcher over
gloo on the CPU (``torch_dist_worker.run_ranks``). Each rank imports
nothing of jax or the JAX package. The weights are made here, by the
port's seeded initializers on the CPU (the builders below), so the test loads
the same arrays into the JAX package's models without waiting for the
ranks. Each rank writes what it holds to ``OUT/rank{r}.npz``.

Modes:
- ``mp2`` (2 ranks): the three mp layers and ``split`` over
  ``build_mesh(mp=2)``; the tiny Llama of tests/test_llama_hybrid.py
  (``tensor_parallel=True``) through ``build_train_step`` at mp=2;
  ``broadcast_mp_parameters``; the pipeline at pp=2 (plain, amp O1,
  ``recompute=True``, a trunk block with dropout) and
  ``fleet.distributed_model(...).train_batch``;
- ``mp4`` (4 ranks): the Llama at mp=4 with ``num_kv_heads=2`` and at
  ``sharding=2, mp=2`` (ZeRO-2); the pipeline at pp=4, dp2 x pp2, pp2 x
  mp2 (Megatron blocks) and pp2 x sp2 (ring attention blocks);
- ``ring2`` / ``ring4``: ``ring_attention`` over sp = the world, causal and
  not, with gradients, at head_dim 8 and 128, its plain version, and
  ``fleet``'s ``sep_degree``.
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
from paddle_tpu_torch.distributed import collective, fleet, spmd, topology  # noqa: E402
from paddle_tpu_torch.distributed import pipeline as pipe  # noqa: E402
from paddle_tpu_torch.distributed.meta_parallel import (  # noqa: E402
    ColumnParallelLinear, PipelineLayer, RowParallelLinear, VocabParallelEmbedding, mp_layers)
from paddle_tpu_torch.ops import ring_attention as ra  # noqa: E402
from paddle_tpu_torch.text.models import LlamaDecoderLayer, LlamaModel, RMSNorm  # noqa: E402

# tests/test_llama_hybrid.py's tiny Llama and its batch
LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
             num_kv_heads=2, max_seq_len=32)
LLAMA_LR, LLAMA_STEPS = 1e-3, 3
# the pipelines: tests/test_llama_hybrid.py's and tests/test_pipeline_schedule.py's shapes
PIPE_STEPS = 2
RING_SHAPES = ((2, 2, 16, 8), (1, 2, 16, 128))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def numpy_state(layers):
    """{name: array} of a layer, or of a list of layers as "<i>.<name>"."""
    if isinstance(layers, (list, tuple)):
        return {f"{i}.{n}": p.detach().numpy().copy() for i, l in enumerate(layers)
                for n, p in l.named_parameters()}
    return {n: p.detach().numpy().copy() for n, p in layers.named_parameters()}


def llama_model(kv_heads=2, tensor_parallel=True):
    return LlamaModel(**dict(LLAMA, num_kv_heads=kv_heads), tensor_parallel=tensor_parallel,
                      device="cpu", generator=_gen(7))


def llama_batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 64, (8, 16)).astype(np.int32),
            rng.randint(0, 64, (8, 16)).astype(np.int32))


def lm_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def mse(o, t):
    return ((o - t) ** 2).mean()


class Head(nn.Layer):
    def __init__(self, hidden=32, vocab=64):
        super().__init__()
        self.norm = RMSNorm(hidden, device="cpu")
        self.head = nn.Linear(hidden, vocab, bias_attr=False, device="cpu", generator=_gen(3))

    def forward(self, x):
        return self.head(self.norm(x))


def llama_pipe_layers():
    """tests/test_llama_hybrid.py TestLlamaPipeline's model: the embedding,
    four identical decoder layers, the norm and head."""
    embed = nn.Embedding(64, 32, device="cpu", generator=_gen(11))
    blocks = [LlamaDecoderLayer(32, 4, 64, 2, device="cpu", generator=_gen(20 + i))
              for i in range(4)]
    return [embed], blocks, [Head()]


class TPBlock(nn.Layer):
    """tests/test_llama_hybrid.py's Megatron pipeline block."""

    def __init__(self, seed):
        super().__init__()
        self.col = ColumnParallelLinear(16, 32, has_bias=True, gather_output=False,
                                        device="cpu", generator=_gen(seed))
        self.row = RowParallelLinear(32, 16, input_is_parallel=True, device="cpu",
                                     generator=_gen(seed + 1))

    def forward(self, x):
        return x + self.row(torch.tanh(self.col(x)))


class RingBlock(nn.Layer):
    """tests/test_llama_hybrid.py's ring attention pipeline block."""

    def __init__(self, seed, hidden=16, heads=2):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden, device="cpu", generator=_gen(seed))
        self.out = nn.Linear(hidden, hidden, device="cpu", generator=_gen(seed + 1))

    def forward(self, x):
        b, s, h = x.shape
        d = h // self.heads
        q, k, v = (t.reshape(b, s, self.heads, d).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        att = ra.ring_attention_in_shard_map(q, k, v, causal=True)
        return x + self.out(att.transpose(1, 2).reshape(b, s, h))


class DropBlock(nn.Layer):
    """A trunk block with dropout: its masks come from the tick and stage
    keys."""

    def __init__(self, seed):
        super().__init__()
        self.fc = nn.Linear(16, 16, device="cpu", generator=_gen(seed))
        self.drop = nn.Dropout(0.3)

    def forward(self, x):
        return torch.tanh(self.drop(self.fc(x)))


def small_pipe_layers(kind):
    """(pre, trunk, post) of the small pipelines: "tp" Megatron blocks,
    "ring" ring attention blocks, "drop" dropout blocks."""
    block = dict(tp=TPBlock, ring=RingBlock, drop=DropBlock)[kind]
    return ([nn.Linear(8, 16, device="cpu", generator=_gen(1))],
            [block(100 + 10 * i) for i in range(4)],
            [nn.Linear(16, 4, device="cpu", generator=_gen(2))])


def small_pipe_data(kind):
    rng = np.random.RandomState(3 if kind == "tp" else 0)
    if kind == "ring":
        return rng.randn(4, 16, 8).astype(np.float32), rng.randn(4, 16, 4).astype(np.float32)
    return rng.randn(8, 8).astype(np.float32), rng.randn(8, 4).astype(np.float32)


def mp_layers_model():
    """The three mp layers in a row: vocab-parallel embedding, a column
    block without gather, a row block on its parallel input, a gathered
    column block."""
    return nn.Sequential(
        VocabParallelEmbedding(16, 8, device="cpu", generator=_gen(1)),
        ColumnParallelLinear(8, 12, has_bias=True, gather_output=False, device="cpu",
                             generator=_gen(2)),
        nn.Tanh(),
        RowParallelLinear(12, 8, input_is_parallel=True, device="cpu", generator=_gen(3)),
        ColumnParallelLinear(8, 6, has_bias=True, gather_output=True, device="cpu",
                             generator=_gen(4)))


def mp_layers_data():
    rng = np.random.RandomState(4)
    return rng.randint(0, 16, (4, 5)).astype(np.int32), rng.randn(4, 5, 6).astype(np.float32)


def ring_data(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]  # q, k, v, dO


def put(res, prefix, tree):
    for n, v in tree.items():
        if isinstance(v, (tuple, list)):
            for i, t in enumerate(v):
                res[f"{prefix}{n}/{i}"] = t.detach().numpy().copy()
        else:
            res[f"{prefix}{n}"] = v.detach().numpy().copy()


def rows(a, index, n):
    k = a.shape[0] // n
    return a[index * k:(index + 1) * k]


# ------------------------------------------------------------------ mp


def run_mp_layers(res, mesh):
    model = mp_layers_model()
    ids, y = mp_layers_data()
    opt = optimizer.SGD(0.1, parameters=model.parameters())
    step, init = spmd.build_train_step(model, mse, opt, mesh=mesh)
    params, st = init()
    for i in range(2):
        loss, params, st = step(params, st, torch.from_numpy(ids), torch.from_numpy(y))
        res[f"layers/loss{i}"] = np.array(float(loss))
    put(res, "layers/param/", params)
    res["layers/mp_rank"] = np.array(mesh.rank_in("mp"))
    # split: each layer's output whole, and in the parallel form through
    # its blocks inside a tensor-parallel scope
    x = torch.from_numpy(np.random.RandomState(6).randn(3, 8).astype(np.float32))
    for name, size, op, axis in (("col", (8, 6), "linear", 1), ("row", (8, 6), "linear", 0),
                                 ("emb", (16, 8), "embedding", 0)):
        inp = torch.from_numpy(ids[:, :3]) if op == "embedding" else x
        out = dist.split(inp, size, op, axis=axis, name=f"split_{name}")
        layer = collective._SPLIT_LAYERS[f"split_{name}"]
        assert dist.split(inp, size, op, axis=axis, name=f"split_{name}") is not None
        assert collective._SPLIT_LAYERS[f"split_{name}"] is layer
        res[f"split/{name}/out"] = out.detach().numpy()
        put(res, f"split/{name}/param/", dict(layer.named_parameters()))
        with mp_layers.tensor_parallel(mesh) as tp:
            blocks = {n: (tp.block(p, mp_layers.mp_dim(p.mp_spec))
                          if mp_layers.mp_dim(getattr(p, "mp_spec", None)) is not None else p)
                      for n, p in layer.named_parameters()}
            par = torch.func.functional_call(layer, blocks, (inp,))
        res[f"split/{name}/parallel"] = par.detach().numpy()


def run_llama(res, tag, mesh, kv_heads, **kw):
    """The tiny Llama's three AdamW steps (key PRNGKey(9) each, as the
    reference's test) over ``mesh``."""
    model = llama_model(kv_heads)
    opt = optimizer.AdamW(LLAMA_LR, parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    step, init = spmd.build_train_step(model, lm_loss, opt, mesh=mesh, **kw)
    params, st = init()
    x, y = llama_batch()
    data = spmd.DataGroup(mesh)
    x, y = (torch.from_numpy(rows(a, data.rank, data.n)) for a in (x, y))
    for i in range(LLAMA_STEPS):
        loss, params, st = step(params, st, x, y, key=prandom.PRNGKey(9))
        res[f"{tag}/loss{i}"] = np.array(float(loss))
    put(res, f"{tag}/param/", params)
    put(res, f"{tag}/state/", st)
    res[f"{tag}/coord"] = np.array([mesh.rank_in("mp"), data.rank])
    res[f"{tag}/bytes"] = np.array([sum(params[n].numel() for n in params
                                        if step.mp_dims[n] is not None),
                                    sum(p.numel() for n, p in model.named_parameters()
                                        if step.mp_dims[n] is not None)])


def run_broadcast(res, rank):
    """broadcast_mp_parameters over an mp=2 hcg: the mp blocks stay each
    rank's own, the replicated parameters become rank 0's."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    model = nn.Sequential(ColumnParallelLinear(4, 6, has_bias=True, device="cpu"),
                          nn.Linear(6, 3, device="cpu"))
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.fill_(10 * rank + i)
    fleet.utils.broadcast_mp_parameters(model, hcg)
    put(res, "broadcast/", dict(model.named_parameters()))
    res["broadcast/mode"] = np.array(hcg.get_parallel_mode())
    res["broadcast/wrapper"] = np.array(type(fleet.distributed_model(model)).__name__)


# ------------------------------------------------------------ pipelines


def run_pipe(res, tag, mesh, layers, data, opt_cls, lr, steps, loss_fn=mse, **kw):
    pre, trunk, post = layers
    opt = opt_cls(lr, parameters=[p for l in pre + trunk + post for p in l.parameters()])
    step, init = pipe.build_pipeline_train_step(pre, trunk, post, loss_fn, opt, mesh=mesh,
                                                num_micro=2, **kw)
    params, st = init()
    dg = spmd.DataGroup(mesh)
    x, y = (torch.from_numpy(rows(a, dg.rank, dg.n)) for a in data)
    for i in range(steps):
        loss, params, st = step(params, st, x, y, key=prandom.PRNGKey(0))
        res[f"{tag}/loss{i}"] = np.array(float(loss))
    put(res, f"{tag}/param/", params)
    put(res, f"{tag}/state/", st)
    res[f"{tag}/coord"] = np.array([mesh.rank_in("pp"), mesh.rank_in("mp"), dg.rank])
    res[f"{tag}/schedule"] = np.array([step.schedule["ticks"],
                                       step.schedule["bubble_fraction"]])


def run_pipes2(res, rank):
    mesh = topology.build_mesh(pp=2)
    llama = llama_pipe_layers()
    ids, labels = llama_batch()
    for tag, kw in (("pp2", {}), ("pp2_recompute", dict(recompute=True)),
                    ("pp2_o1", dict(amp_level="O1", amp_dtype="float16"))):
        run_pipe(res, tag, mesh, llama, (ids, labels), optimizer.SGD, 0.1, PIPE_STEPS,
                 loss_fn=lm_loss, **kw)
    run_pipe(res, "pp2_drop", mesh, small_pipe_layers("drop"), small_pipe_data("drop"),
             optimizer.SGD, 0.1, PIPE_STEPS)
    # fleet: PipelineLayer + distributed_model(...).train_batch
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": 2}
    fleet.init(is_collective=True, strategy=strategy)
    pre, trunk, post = llama_pipe_layers()
    model = PipelineLayer(pre + trunk + post, num_stages=2, loss_fn=lm_loss)
    pp_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optimizer.SGD(0.1, parameters=model.parameters()))
    res["fleet/wrapper"] = np.array(type(pp_model).__name__)
    for i in range(PIPE_STEPS):
        loss = pp_model.train_batch((torch.from_numpy(ids), torch.from_numpy(labels)), opt)
        res[f"fleet/loss{i}"] = np.array(float(loss))
    res["fleet/state"] = np.array(sorted(pp_model.state_dict()))
    put(res, "fleet/param/", dict(model.named_parameters()))
    try:
        pp_model.train_batch((torch.from_numpy(ids[:3]), torch.from_numpy(labels[:3])), opt)
    except ValueError as e:
        res["fleet/divisibility"] = np.array(str(e))
    topology.set_global_mesh(topology.build_mesh(dp=2))


def run_pipes4(res, rank):
    ids, labels = llama_batch()
    run_pipe(res, "pp4", topology.build_mesh(pp=4), llama_pipe_layers(), (ids, labels),
             optimizer.SGD, 0.1, PIPE_STEPS, loss_fn=lm_loss)
    run_pipe(res, "dp2pp2", topology.build_mesh(dp=2, pp=2), llama_pipe_layers(),
             (ids, labels), optimizer.Adam, 1e-2, PIPE_STEPS, loss_fn=lm_loss)
    run_pipe(res, "pp2mp2", topology.build_mesh(pp=2, mp=2), small_pipe_layers("tp"),
             small_pipe_data("tp"), optimizer.SGD, 0.01, PIPE_STEPS)
    mesh = topology.build_mesh(pp=2, sp=2)
    run_pipe(res, "pp2sp2", mesh, small_pipe_layers("ring"), small_pipe_data("ring"),
             optimizer.Adam, 1e-2, 3)
    # rank-1 labels keep the data layout: a mean-pooled head and [B] labels
    x, _ = small_pipe_data("ring")
    y1 = np.random.RandomState(1).randn(4).astype(np.float32)
    run_pipe(res, "pp2sp2_rank1", mesh, small_pipe_layers("ring"), (x, y1), optimizer.Adam,
             1e-2, 1, loss_fn=lambda o, t: ((o.mean(dim=1)[:, 0] - t) ** 2).mean())


# ----------------------------------------------------------------- ring


def run_ring(res, rank, world):
    mesh = topology.build_mesh(sp=world)
    for shape in RING_SHAPES:
        for causal in (False, True):
            tag = f"ring/{shape[-1]}/{int(causal)}"
            q, k, v, do = (torch.from_numpy(np.ascontiguousarray(
                a[:, :, rank * shape[2] // world:(rank + 1) * shape[2] // world]))
                for a in ring_data(shape, 5))
            for how, fn in (("kernel", ra.ring_attention), ("plain", ra.ring_attention_reference)):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                ra.hop_seconds.clear()
                out = fn(*leaves, mesh=mesh, causal=causal)
                hops_fwd = len(ra.hop_seconds)
                dq, dk, dv = torch.autograd.grad(out, leaves, do)
                put(res, f"{tag}/{how}/", dict(out=out, dq=dq, dk=dk, dv=dv))
                res[f"{tag}/{how}/hops"] = np.array([hops_fwd, len(ra.hop_seconds) - hops_fwd])
    # fleet's sep_degree: the global mesh's sp axis is the ring
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": world}
    fleet.init(is_collective=True, strategy=strategy)
    shape = RING_SHAPES[0]
    q, k, v, _ = (torch.from_numpy(np.ascontiguousarray(
        a[:, :, rank * shape[2] // world:(rank + 1) * shape[2] // world]))
        for a in ring_data(shape, 5))
    res["ring/sep/out"] = dist.ring_attention(q, k, v, causal=True).numpy()
    res["ring/sep/degree"] = np.array(
        fleet.get_hybrid_communicate_group().get_sep_parallel_world_size())


def main():
    mode, out = sys.argv[1], sys.argv[2]
    paddle.set_device("cpu")
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {}
    if mode == "mp2":
        run_mp_layers(res, topology.build_mesh(mp=2))
        run_llama(res, "llama_mp2", topology.build_mesh(mp=2), 2)
        run_broadcast(res, rank)
        run_pipes2(res, rank)
    elif mode == "mp4":
        run_llama(res, "llama_mp4", topology.build_mesh(mp=4), 2)
        run_llama(res, "llama_mp2sh2", topology.build_mesh(sharding=2, mp=2), 2,
                  sharding_stage=2)
        run_pipes4(res, rank)
    elif mode in ("ring2", "ring4"):
        run_ring(res, rank, world)
    else:
        raise SystemExit(f"unknown mode {mode}")
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, world=world), f)
    dist.barrier()


if __name__ == "__main__":
    main()
