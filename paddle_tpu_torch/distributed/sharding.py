"""ZeRO helpers (counterpart of paddle_tpu/distributed/sharding.py;
reference: fleet/meta_optimizers/sharding_optimizer.py:40, dygraph
sharding/group_sharded.py).

The compiled step's ZeRO stages are ``spmd.build_train_step``'s
(``sharding_stage``); ``group_sharded_parallel`` tags a model and its
optimizer with a stage for it, and shards the optimizer's eager step.
Every tensor is sharded over the global mesh's data axes ("dp" and
"sharding" combined) on its first dimension their number of ranks
divides (``spmd.zero_dim``), else kept whole.
"""
import torch

from .. import framework
from . import collective, topology
from .spmd import DataGroup, block_sum_sq, zero_dim

LEVEL_TO_STAGE = {"os": 1, "os_g": 2, "p_g_os": 3}


def _data():
    return DataGroup(topology.get_global_mesh())


def shard_arrays(tree, mesh=None, axes=("dp", "sharding")):
    """This rank's block of every tensor in a (nested dict/list/tuple)
    tree: on its first dimension that the ranks over ``axes`` divide,
    else whole (the reference's placement of the global array; its
    addressable shard)."""
    mesh = mesh or topology.get_global_mesh()
    n, rank = mesh.axis_size(axes), mesh.rank_in(axes)

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(one(v) for v in t)
        return collective.shard(t, zero_dim(tuple(t.shape), n), rank, n)

    return one(tree)


def group_sharded_parallel(model, optimizer, level="os", scaler=None, group=None,
                           offload=False, sync_buffers=False, buffer_max_size=2 ** 23,
                           segment_size=2 ** 20, sync_comm=False):
    """reference: group_sharded.py. level: 'os' (ZeRO-1) | 'os_g' (ZeRO-2)
    | 'p_g_os' (ZeRO-3). Tags the model and the optimizer with the stage
    (``build_train_step`` takes the model's), and shards the optimizer's
    eager ``step``: each rank keeps and updates only its block of every
    parameter's accumulators (the reference keeps them sharded after each
    eager step), then all-gathers the parameter, so the parameters are
    bitwise the unsharded step's. Its ``state_dict`` gathers the
    accumulators whole first (every rank calls it), so a saved state has
    the reference's layout; a whole state loaded with ``set_state_dict``
    is cut to the blocks at the next step. The gradients are the caller's
    to average (``DataParallel``). The reference's other knobs are not
    read there: other values than their defaults raise."""
    stage = LEVEL_TO_STAGE.get(level)
    if stage is None:
        raise ValueError(f"level must be one of {sorted(LEVEL_TO_STAGE)}, got {level!r}")
    unread = [k for k, v, d in (("group", group, None), ("offload", offload, False),
                                ("sync_buffers", sync_buffers, False),
                                ("buffer_max_size", buffer_max_size, 2 ** 23),
                                ("segment_size", segment_size, 2 ** 20),
                                ("sync_comm", sync_comm, False)) if v != d]
    if unread:
        raise NotImplementedError(f"group_sharded_parallel: the reference never reads {unread}")
    optimizer._sharding_level = level
    optimizer._sharding_stage = stage
    model._sharding_stage = stage
    whole_state_dict = optimizer.state_dict

    @torch.no_grad()
    def step():
        optimizer._step_count += 1
        params = [p for p in optimizer._params if p.requires_grad and p.grad is not None]
        if not params:
            return
        data = _data()
        dims = [zero_dim(tuple(p.shape), data.n) for p in params]
        grads = [p.grad for p in params]
        if optimizer._grad_clip is not None:
            grads = optimizer._grad_clip.clip_arrays(grads)
        views = [collective.shard(p, d, data.rank, data.n) for p, d in zip(params, dims)]
        for p, d in zip(params, dims):
            state = optimizer._accumulators.get(id(p))
            if d is not None and state is not None and any(
                    a.dim() and tuple(a.shape) == tuple(p.shape) for a in state):
                # a whole state (loaded, or from before the tagging): its block
                optimizer._accumulators[id(p)] = tuple(
                    collective.shard(a, d, data.rank, data.n).clone() if a.dim() else a
                    for a in state)
        optimizer._apply(params, [collective.shard(g, d, data.rank, data.n)
                                  for g, d in zip(grads, dims)], optimizer.get_lr(),
                         views=views,
                         sum_sq=[block_sum_sq([data.group if d is not None else None])
                                 for d in dims])
        live = [i for i, d in enumerate(dims) if d is not None]
        wholes = collective.coalesced_all_gather([views[i] for i in live],
                                                 [dims[i] for i in live], data.group)
        for i, w in zip(live, wholes):
            params[i].copy_(w)

    def state_dict():
        d = whole_state_dict()
        data = _data()
        blocks = []  # (accumulator list, index, dim) of each block to gather
        for p, name in zip(optimizer._params, optimizer._names()):
            dim = zero_dim(tuple(p.shape), data.n)
            acc = d["accumulators"].get(name)
            if acc is not None and dim is not None:
                blocks += [(acc, i, dim) for i, a in enumerate(acc)
                           if a.dim() and tuple(a.shape) != tuple(p.shape)]
        wholes = collective.coalesced_all_gather([acc[i] for acc, i, _ in blocks],
                                                 [dim for *_, dim in blocks], data.group)
        for (acc, i, _), w in zip(blocks, wholes):
            acc[i] = w
        return d

    optimizer.step = step
    optimizer.state_dict = state_dict
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """reference: group_sharded.py: ``output.pdparams`` and, with the
    optimizer, ``output.pdopt``, whose accumulators are gathered whole
    (the reference's layout: either package loads the other's). Every rank
    calls it; the group's first rank writes."""
    state = optimizer.state_dict() if optimizer is not None else None
    data = _data()
    if data.rank == 0:
        framework.save(model.state_dict(), output + ".pdparams")
        if state is not None:
            framework.save(state, output + ".pdopt")
    if data.group is not None:
        collective.barrier(data.group)
