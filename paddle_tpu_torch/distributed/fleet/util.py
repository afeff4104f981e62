"""Fleet util (counterpart of paddle_tpu/distributed/fleet/util.py;
reference: python/paddle/distributed/fleet/base/util_factory.py UtilBase
— gloo collectives of host values over the trainers, and file sharding).

Host values ride a gloo group, as the reference's do: the job's default
group where its backend is gloo, else one gloo group over every rank made
at the first call (every rank calls these collectively). Values reduce
in float64, as the reference's gloo path does; outside a job each is the
identity.
"""
import numpy as np
import torch
import torch.distributed as dist

__all__ = ["UtilBase"]

_HOST_GROUP = []


def _host_group():
    if not _HOST_GROUP:
        _HOST_GROUP.append(dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))
    return _HOST_GROUP[0]


class UtilBase:
    def __init__(self, role_maker=None):
        self.role_maker = role_maker

    def _world(self):
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size(), dist.get_rank()
        return 1, 0

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        """Reduce a host value across trainers (reference
        util_factory.py:60); every rank gets the global value."""
        if mode not in ("sum", "max", "min"):
            raise ValueError(f"all_reduce mode must be sum/max/min, got {mode!r}")
        n, _ = self._world()
        arr = np.asarray(input)
        if n == 1:
            return arr
        t = torch.from_numpy(np.array(arr, dtype=np.float64, copy=True))
        op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
        dist.all_reduce(t, op[mode], group=_host_group())
        return t.numpy()

    def all_gather(self, input, comm_world="worker"):
        """Every trainer's value, in rank order (the same shape on each)."""
        n, _ = self._world()
        arr = np.asarray(input)
        if n == 1:
            return [arr]
        t = torch.from_numpy(np.array(arr, copy=True))
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t, group=_host_group())
        return [o.numpy() for o in out]

    def barrier(self, comm_world="worker"):
        if self._world()[0] > 1:
            dist.barrier(group=_host_group())

    def get_file_shard(self, files):
        """Split a file list evenly across trainers (reference
        util_factory.py:206): trainer i takes blocks[i]."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file paths")
        n, rank = self._world()
        base = len(files) // n
        rem = len(files) % n
        blocks = [base + (1 if i < rem else 0) for i in range(n)]
        start = sum(blocks[:rank])
        return files[start:start + blocks[rank]]

    def print_on_rank(self, message, rank_id=0):
        _, rank = self._world()
        if rank == rank_id:
            print(message)
