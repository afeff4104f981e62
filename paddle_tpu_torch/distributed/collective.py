"""Collective communication (counterpart of
paddle_tpu/distributed/collective.py; reference:
python/paddle/distributed/collective.py: all_reduce:405, broadcast:338,
all_gather:580, scatter:658, barrier:166, send:1253/recv:1302).

The group of the reference is a mesh axis name here too: ``group=None``
is the global mesh's "dp" axis, a string names an axis, a ``Group`` is a
``new_group``'s ranks. Each op runs the ``torch.distributed`` collective
over that axis's process group (topology.Mesh), in place on the caller's
tensor as the reference's ops are. Where the axis has size 1, or the
process is in no job, there is one rank and each op is the reference's
one-process identity (collective.py:13-16): a sum over one copy is the
copy.

gloo has no CUDA form of ``reduce``, ``scatter``, ``send``/``recv`` and
``all_to_all`` (its CUDA work covers all-reduce, broadcast and
all-gather). Over a gloo group those ops stage a CUDA tensor through
the host on purpose: ``_staged`` copies it to the CPU, the op runs there,
and the result is copied back into the caller's tensor, which stays on
its card. NCCL takes every op on the card as it is. The in-graph names
of the reference (``psum``, ``pmean``, ``pmax``, ``all_gather_spmd``,
``ppermute``, ``all_to_all_spmd``) are the same collectives over the
named axis, returning new tensors.

The training steps' own helpers (spmd.py, comm_opt.py, sharding.py,
pipeline.py): ``coalesced_mean`` (one all-reduce mean per dtype),
``coalesced_sum`` (the same sum undivided), ``shard`` (a rank's
block of a tensor along a dimension), ``coalesced_reduce_scatter`` (the
group's mean, of which each rank keeps its blocks: NCCL's
``reduce_scatter_tensor``; over gloo, which has no CUDA reduce-scatter,
one all-reduce and the rank's part, on purpose),
``coalesced_all_gather`` (each rank's blocks joined whole again) and
``AllReduceSum`` (a sum over the group that autograd differentiates:
batch norm's global statistics). A group there may stand for a tuple of
axes (the data axes, "dp" and "sharding" combined).
"""
import contextlib
import itertools

import torch
import torch.distributed as dist

from . import topology

_GROUP_IDS = itertools.count(1)
# ops gloo runs on host tensors only (see the module docstring)
_GLOO_HOST_OPS = frozenset({"reduce", "scatter", "send", "recv", "all_to_all"})


class Group:
    """A ``new_group``'s ranks (reference collective.py Group); ``axis``
    is the mesh axis the group stands for when it is built from one."""

    def __init__(self, ranks=None, axis="dp", id=0, process_group=None):
        self.ranks = ranks
        self.axis = axis
        self.id = id
        self.process_group = process_group

    @property
    def nranks(self):
        if self.ranks is not None:
            return len(self.ranks)
        return topology.get_global_mesh().axis_size(self.axis)


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


# AVG is a SUM divided by the group's size: gloo has no AVG
_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
              "prod": dist.ReduceOp.PRODUCT, "avg": dist.ReduceOp.SUM}


def _axis_of(group):
    if group is None:
        return "dp"
    if isinstance(group, str):
        return group
    if isinstance(group, Group):
        return group.axis
    return "dp"


def _pg(group):
    """(process group or None for one rank, size, this rank's position)."""
    if isinstance(group, Group) and group.process_group is not None:
        pg = group.process_group
        return pg, dist.get_world_size(pg), dist.get_rank(pg)
    mesh = topology.get_global_mesh()
    axis = _axis_of(group)
    pg = mesh.group(axis)
    if pg is None:
        return None, 1, 0
    return pg, dist.get_world_size(pg), dist.get_rank(pg)


def _global(pg, rank):
    """The job's rank of ``rank`` in ``pg``."""
    return dist.get_global_rank(pg, rank) if pg is not dist.group.WORLD else rank


@contextlib.contextmanager
def _staged(op, pg, *tensors, inputs=0):
    """Yield the tensors the op runs on: over a gloo group, for an op gloo
    runs on the host only, CPU copies of the CUDA ones, copied back into
    the originals when the op is done (all but the first ``inputs``, which
    the op only reads: an input is never written, so autograd's saved
    tensors keep their version); else the tensors themselves."""
    host = (any(t.is_cuda for t in tensors) and op in _GLOO_HOST_OPS
            and dist.get_backend(pg) == "gloo")
    if not host:
        yield tensors
        return
    copies = tuple(t.cpu() if t.is_cuda else t for t in tensors)
    yield copies
    for t, c in list(zip(tensors, copies))[inputs:]:
        if c is not t:
            t.copy_(c)


def new_group(ranks=None, backend=None, timeout=None):
    """reference: collective.py:206. In a job every rank calls it, as
    ``torch.distributed.new_group`` wants; outside one it is a group of
    this process alone."""
    pg = None
    if dist.is_available() and dist.is_initialized():
        ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
        pg = dist.new_group(ranks, backend=backend)
        if dist.get_rank() not in ranks:
            pg = None
    return Group(ranks=ranks, axis="dp", id=next(_GROUP_IDS), process_group=pg)


def is_initialized():
    return True


def get_rank_in(group=None):
    """This process's rank in the group (0 with one rank)."""
    return _pg(group)[2]


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """reference: collective.py:405. In place; AVG divides the sum by the
    group's size (a floating tensor only)."""
    pg, n, _ = _pg(group)
    if pg is None:
        return tensor
    if op == ReduceOp.AVG and not tensor.is_floating_point():
        raise TypeError(f"all_reduce AVG takes a floating tensor, got {tensor.dtype}")
    dist.all_reduce(tensor, _TORCH_OPS[op], group=pg)
    if op == ReduceOp.AVG:
        tensor.div_(n)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """reference: collective.py:580: appends each rank's tensor, in rank
    order, to ``tensor_list``."""
    pg, n, _ = _pg(group)
    if pg is None:
        tensor_list.append(tensor.clone())
        return tensor_list
    out = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(out, tensor.contiguous(), group=pg)
    tensor_list.extend(out)
    return tensor_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """reference: collective.py:338; ``src`` is the rank in the group."""
    pg, _, _ = _pg(group)
    if pg is not None:
        dist.broadcast(tensor, _global(pg, src), group=pg)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """reference: collective.py (c_reduce): the reduced value lands on
    rank ``dst`` of the group; the others keep what the backend leaves."""
    pg, n, me = _pg(group)
    if pg is None:
        return tensor
    if op == ReduceOp.AVG and not tensor.is_floating_point():
        raise TypeError(f"reduce AVG takes a floating tensor, got {tensor.dtype}")
    with _staged("reduce", pg, tensor) as (t,):
        dist.reduce(t, _global(pg, dst), _TORCH_OPS[op], group=pg)
        if op == ReduceOp.AVG and me == dst:
            t.div_(n)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """reference: collective.py:658: rank r of the group receives
    ``tensor_list[r]`` of rank ``src`` into ``tensor``."""
    pg, n, me = _pg(group)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    if me == src and (tensor_list is None or len(tensor_list) != n):
        raise ValueError(f"scatter needs {n} tensors on its source, got "
                         f"{0 if tensor_list is None else len(tensor_list)}")
    parts = list(tensor_list) if me == src else []
    with _staged("scatter", pg, *parts, tensor, inputs=len(parts)) as (*ps, t):
        dist.scatter(t, [p.contiguous() for p in ps] if me == src else None,
                     src=_global(pg, src), group=pg)
    return tensor


def coalesced_mean(tensors, group=None):
    """Average each tensor over the group in place, one all-reduce per
    (dtype, device): the tensors are packed into one flat buffer, summed
    over the group and divided by its size (the reference's mean over
    processes; with two ranks (a + b) / 2 bitwise). One rank: nothing."""
    return _coalesced_reduce(tensors, group, mean=True)


def coalesced_sum(tensors, group=None):
    """``coalesced_mean`` without the division: each tensor summed over the
    group in place."""
    return _coalesced_reduce(tensors, group, mean=False)


def _coalesced_reduce(tensors, group, mean):
    pg, n, _ = _pg(group)
    if pg is None:
        return tensors
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, dist.ReduceOp.SUM, group=pg)
        if mean:
            flat.div_(n)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


def shard(t, dim, rank, n):
    """Rank ``rank``'s block of ``t`` split in ``n`` along ``dim`` (a view;
    ``t`` whole where ``dim`` is None)."""
    if dim is None:
        return t
    k = t.shape[dim] // n
    return t.narrow(dim, rank * k, k)


def _bucketed(items):
    """{(dtype, device): [index, ...]} over tensors-bearing items."""
    buckets = {}
    for i, t in enumerate(items):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    return buckets.values()


def coalesced_reduce_scatter(tensors, dims, group=None):
    """The group's mean of each tensor, of which this rank keeps its block
    along ``dims[i]`` (an int; ``shard``): returns the blocks, new tensors. One
    collective per (dtype, device) over a buffer laid out as rank 0's
    blocks of every tensor, then rank 1's, and so on. Over NCCL it is
    ``reduce_scatter_tensor``; gloo has no CUDA reduce-scatter, so there
    it is one all-reduce of the whole buffer and the rank's part of it, on
    purpose. Either way a block is summed, then divided by the group's
    size: with two ranks it is bitwise the rank's block of
    ``coalesced_mean``. One rank: the tensors as they are."""
    pg, n, me = _pg(group)
    if pg is None:
        return list(tensors)
    out = [None] * len(tensors)
    for idx in _bucketed(tensors):
        parts = [shard(tensors[i], dims[i], 0, n) for i in idx]
        m = sum(p.numel() for p in parts)
        flat = torch.cat([shard(tensors[i], dims[i], r, n).reshape(-1)
                          for r in range(n) for i in idx])
        if dist.get_backend(pg) == "nccl":
            mine = torch.empty(m, dtype=flat.dtype, device=flat.device)
            dist.reduce_scatter_tensor(mine, flat, dist.ReduceOp.SUM, group=pg)
        else:
            dist.all_reduce(flat, dist.ReduceOp.SUM, group=pg)
            mine = flat[me * m:(me + 1) * m].clone()
        del flat
        mine.div_(n)
        off = 0
        for i, p in zip(idx, parts):
            out[i] = mine[off:off + p.numel()].view(p.shape)
            off += p.numel()
    return out


def coalesced_all_gather(blocks, dims, group=None):
    """The inverse of ``coalesced_reduce_scatter``'s split: each rank gives
    its block of every tensor, and each tensor comes back whole, its ranks'
    blocks joined along ``dims[i]``, in new tensors. One all-gather per
    (dtype, device). One rank: the blocks as they are."""
    pg, n, _ = _pg(group)
    if pg is None:
        return list(blocks)
    out = [None] * len(blocks)
    for idx in _bucketed(blocks):
        flat = torch.cat([blocks[i].reshape(-1) for i in idx])
        m = flat.numel()
        whole = torch.empty(n * m, dtype=flat.dtype, device=flat.device)
        if dist.get_backend(pg) == "nccl":
            dist.all_gather_into_tensor(whole, flat, group=pg)
        else:
            dist.all_gather(list(whole.chunk(n)), flat, group=pg)
        off = 0
        for i in idx:
            b = blocks[i]
            pieces = [whole[r * m + off:r * m + off + b.numel()].view(b.shape) for r in range(n)]
            out[i] = torch.cat(pieces, dim=dims[i])
            off += b.numel()
    return out


class AllReduceSum(torch.autograd.Function):
    """A differentiable sum over the group: the forward all-reduces its
    input, the backward the incoming gradient (each rank's loss reads the
    sum, so each rank's input reaches every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ReduceOp.SUM, ctx.group), None


def barrier(group=None):
    """reference: collective.py:166."""
    pg, _, _ = _pg(group)
    if pg is not None:
        dist.barrier(group=pg)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """reference: collective.py (alltoall): rank j's out[i] = rank i's
    in[j]."""
    pg, n, me = _pg(group)
    if len(in_tensor_list) != n:
        raise ValueError(f"all_to_all needs {n} tensors, got {len(in_tensor_list)}")
    if pg is None:
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return out_tensor_list
    outs = [torch.empty_like(t) for t in in_tensor_list]
    with _staged("all_to_all", pg, *in_tensor_list, *outs, inputs=n) as staged:
        ins, os_ = list(staged[:n]), list(staged[n:])
        # gloo has no all_to_all: each rank scatters its list, in turn
        if dist.get_backend(pg) == "gloo":
            for src in range(n):
                dist.scatter(os_[src], [t.contiguous() for t in ins] if src == me else None,
                             src=_global(pg, src), group=pg)
        else:
            dist.all_to_all(os_, [t.contiguous() for t in ins], group=pg)
    out_tensor_list.extend(outs)
    return out_tensor_list


def alltoall_single(out_tensor, in_tensor, group=None, sync_op=True):
    """All-to-all of dim-0 blocks: this rank's k-th block of ``in_tensor``
    goes to rank k's block at this rank's position in ``out_tensor``."""
    pg, n, _ = _pg(group)
    if pg is None:
        out_tensor.copy_(in_tensor)
        return out_tensor
    outs = []
    all_to_all(outs, list(in_tensor.chunk(n, dim=0)), group=group)
    out_tensor.copy_(torch.cat(outs, dim=0))
    return out_tensor


def send(tensor, dst=0, group=None, sync_op=True):
    """reference: collective.py:1253; ``dst`` is the rank in the group."""
    pg, _, _ = _pg(group)
    if pg is None:
        raise RuntimeError("send needs a peer: this process is the group's one rank")
    with _staged("send", pg, tensor, inputs=1) as (t,):
        dist.send(t.contiguous(), _global(pg, dst), group=pg)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """reference: collective.py:1302: blocks until the matching send."""
    pg, _, _ = _pg(group)
    if pg is None:
        raise RuntimeError("recv needs a peer: this process is the group's one rank")
    with _staged("recv", pg, tensor) as (t,):
        dist.recv(t, _global(pg, src), group=pg)
    return tensor


_SPLIT_LAYERS = {}


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True, weight_attr=None,
          bias_attr=None, name=None):
    """reference: collective.py:1021 paddle.distributed.split — build and
    apply a tensor-parallel fc or embedding over 'mp'
    (``meta_parallel.mp_layers``). operation "linear": axis 0 shards the
    input dimension (RowParallelLinear), axis 1 the output dimension
    (ColumnParallelLinear, ``gather_out``); "embedding": the vocabulary
    (VocabParallelEmbedding). A named layer is cached by ``name``, so
    repeated calls reuse its weights; an anonymous one is built anew, on
    ``x``'s device. Its weights are whole, as the reference's; inside a
    tensor-parallel scope they are the rank's blocks."""
    from .meta_parallel import ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding

    layer = _SPLIT_LAYERS.get(name) if name else None
    if layer is None:
        dev = x.device if isinstance(x, torch.Tensor) else None
        if operation == "linear":
            in_f, out_f = size
            if axis == 1:
                layer = ColumnParallelLinear(in_f, out_f, has_bias=bias_attr is not False,
                                             gather_output=gather_out, device=dev)
            elif axis == 0:
                layer = RowParallelLinear(in_f, out_f, has_bias=bias_attr is not False,
                                          input_is_parallel=False, device=dev)
            else:
                raise ValueError(f"linear split axis must be 0 or 1, got {axis}")
        elif operation == "embedding":
            vocab, dim = size
            layer = VocabParallelEmbedding(vocab, dim, device=dev)
        else:
            raise ValueError(f"unknown split operation {operation!r}")
        if name:
            _SPLIT_LAYERS[name] = layer
    return layer(x)


# ------------------------------------------------ the reference's in-graph names


def psum(x, axis):
    return all_reduce(x.clone(), ReduceOp.SUM, axis)


def pmean(x, axis):
    return all_reduce(x.clone(), ReduceOp.AVG, axis)


def pmax(x, axis):
    return all_reduce(x.clone(), ReduceOp.MAX, axis)


def all_gather_spmd(x, axis, gather_axis=0):
    return torch.cat(all_gather([], x, axis), dim=gather_axis)


def ppermute(x, axis, perm):
    """Each (src, dst) of ``perm``: rank src's ``x`` goes to rank dst; a
    rank no pair sends to gets zeros (jax.lax.ppermute)."""
    pg, n, me = _pg(axis)
    out = torch.zeros_like(x)
    if pg is None:
        return x.clone() if (0, 0) in [tuple(p) for p in perm] else out
    with _staged("send", pg, x.contiguous(), out, inputs=1) as (xs, os_):
        ops = []
        for src, dst in perm:
            if src == me:
                ops.append(dist.P2POp(dist.isend, xs, _global(pg, dst), group=pg))
            if dst == me:
                ops.append(dist.P2POp(dist.irecv, os_, _global(pg, src), group=pg))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    return out


def all_to_all_spmd(x, axis, split_axis, concat_axis):
    pg, n, _ = _pg(axis)
    outs = []
    all_to_all(outs, list(x.chunk(n, dim=split_axis)), axis)
    return torch.cat(outs, dim=concat_axis)
