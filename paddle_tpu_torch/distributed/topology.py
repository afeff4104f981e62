"""Hybrid parallel topology over the processes of a ``torch.distributed``
job (counterpart of paddle_tpu/distributed/topology.py; reference:
python/paddle/distributed/fleet/base/topology.py:35 CommunicateTopology,
:111 HybridCommunicateGroup).

The JAX package's mesh is an array of devices driven by one program. The
port's ``Mesh`` is the same arrangement of ranks, one process (and one
card) per rank, as the reference's one-proc-per-GPU trainers: it keeps
the axis names, the shape, and for each axis the process group of this
rank's comm list along it (``torch.distributed.new_group``), which the
collectives of ``collective.py`` run over. An axis of size 1 needs no
group; an axis whose one comm list is the whole job uses the default
group. A process that is not in a job is a one-rank mesh, as the
reference's ``build_mesh(dp=len(jax.devices()))`` is on one chip.

The batch and the ZeRO state are sharded over the data axes combined
(``data_axes``: "dp" and "sharding", the reference's ``P(("dp",
"sharding"))``). ``group``, ``axis_size`` and ``rank_in`` take such a
tuple of axes too: its group is this rank's comm list over both, and its
index is ``dp_idx * sharding + sharding_idx``, the position of this
rank's block in a dimension the reference shards over the pair.
``AxisGroup`` is one axis as this rank sees it (its index, the axis's
size, the collectives' group), which the mp layers, the pipeline and
the ring take their blocks and collectives from.
"""
import numpy as np
import torch.distributed as dist

_HYBRID_GROUP = None
_GLOBAL_MESH = None

AXIS_ORDER = ("dp", "pp", "sharding", "sp", "ep", "mp")


def _world():
    """(world size, rank) of the job, (1, 0) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Ranks arranged over ``AXIS_ORDER``: ``ranks`` is the int array of
    global ranks in that shape, ``shape`` maps each axis to its size (as
    a jax Mesh's does), ``coord`` is this rank's position (None for a rank
    outside the mesh) and ``group(axis)`` the process group of its comm
    list along ``axis`` (None where the axis has size 1)."""

    def __init__(self, dims, axis_names=AXIS_ORDER):
        self.axis_names = tuple(axis_names)
        self.ranks = np.arange(int(np.prod(dims))).reshape(dims)
        self.shape = dict(zip(self.axis_names, (int(d) for d in dims)))
        self.size = int(self.ranks.size)
        world, me = _world()
        where = np.argwhere(self.ranks == me)
        self.coord = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups = {}
        if not (dist.is_available() and dist.is_initialized()):
            return
        for i, axis in enumerate(self.axis_names):
            lists = [row.tolist() for row in np.moveaxis(self.ranks, i, -1).reshape(-1, dims[i])]
            self._make_groups(axis, lists, dims[i], world, me)
        dp, sh = (self.axis_names.index(a) for a in ("dp", "sharding"))
        if dims[dp] > 1 and dims[sh] > 1:
            # the data axes combined: the ranks that share every other
            # coordinate, ordered by (dp, sharding)
            rest = [i for i in range(len(dims)) if i not in (dp, sh)]
            n = dims[dp] * dims[sh]
            lists = [row.tolist() for row in
                     np.transpose(self.ranks, rest + [dp, sh]).reshape(-1, n)]
            self._make_groups(("dp", "sharding"), lists, n, world, me)

    def _make_groups(self, key, lists, n, world, me):
        if len(lists) == 1 and lists[0] == list(range(world)):
            self._groups[key] = dist.group.WORLD  # the whole job: the default group
        elif n > 1:
            for ranks in lists:
                # every rank takes part in every new_group, in one order
                pg = dist.new_group(ranks)
                if me in ranks:
                    self._groups[key] = pg

    def group(self, axes):
        """The process group of this rank's comm list along ``axes``, an
        axis name or a tuple of them (of which the axes of size 1 are
        dropped); None where that is one rank."""
        if isinstance(axes, str):
            return self._groups.get(axes)
        live = tuple(a for a in axes if self.shape.get(a, 1) > 1)
        return self._groups.get(live[0] if len(live) == 1 else live) if live else None

    def axis_size(self, axes):
        return int(np.prod([self.shape.get(a, 1) for a in
                            ((axes,) if isinstance(axes, str) else axes)]))

    def rank_in(self, axes):
        """This rank's index along ``axes`` (an axis or a tuple of them,
        row-major over the tuple; 0 outside the mesh)."""
        if self.coord is None:
            return 0
        index = 0
        for a in ((axes,) if isinstance(axes, str) else axes):
            if a in self.axis_names:
                index = index * self.shape[a] + self.coord[self.axis_names.index(a)]
        return index

    def __repr__(self):
        return f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items() if n > 1) or 'one rank'})"


class AxisGroup:
    """A mesh axis ("mp" by default) as this rank sees it: ``n`` ranks,
    this rank's ``rank`` (``mesh.rank_in(axis)``, never the hcg's
    model-parallel rank) and the collectives' ``group`` (None for one
    rank)."""

    def __init__(self, mesh, axis="mp"):
        self.n = mesh.axis_size(axis)
        self.rank = mesh.rank_in(axis)
        self.group = None
        if self.n > 1:
            pg = mesh.group(axis)
            if pg is None:
                raise RuntimeError(f"{mesh} has {self.n} {axis} ranks but this process has no "
                                   "group over them (call init_parallel_env)")
            from . import collective

            self.group = collective.Group(axis=axis, process_group=pg)

    def block(self, t, dim):
        """This rank's block of ``t`` along ``dim``."""
        from . import collective

        return collective.shard(t, dim, self.rank, self.n)


def build_mesh(dp=1, mp=1, pp=1, sharding=1, sp=1, ep=1, devices=None):
    """A ``Mesh`` of dp x pp x sharding x sp x ep x mp ranks of the job
    (all ranks of the job take part in the call). As in the reference a
    1 x ... x 1 request in a job of several ranks gives dp = the job's
    size. ``devices``: a count of ranks to use, or a sequence whose length
    is that count (the reference's device list), else the whole job."""
    world, _ = _world()
    if devices is not None:
        world = min(world, devices if isinstance(devices, int) else len(devices))
    n = dp * mp * pp * sharding * sp * ep
    if n == 1 and world > 1:
        dp = n = world
    if n > world:
        raise ValueError(f"topology dp{dp}xpp{pp}xsharding{sharding}xsp{sp}xep{ep}xmp{mp}={n} "
                         f"needs {n} ranks, the job has {world}")
    return Mesh((dp, pp, sharding, sp, ep, mp))


def data_axes(mesh):
    """The mesh axes that shard the batch dimension (shard_batch and
    every consumer of its layout must agree on this set)."""
    return tuple(ax for ax in ("dp", "sharding") if mesh.shape.get(ax, 1) > 1)


def set_global_mesh(mesh):
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh():
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        _GLOBAL_MESH = build_mesh()
    return _GLOBAL_MESH


class CommunicateTopology:
    """reference: topology.py:35."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = int(np.prod(dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coords, self._dims))

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r in range(self._world) if self.get_coord(r)[axis] == index]

    def get_comm_list(self, axis_name):
        """All rank-groups along `axis_name` (reference topology.py:85)."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for flat in range(int(np.prod(other_dims)) if other_dims else 1):
            coords_other = np.unravel_index(flat, other_dims) if other_dims else ()
            group = []
            for k in range(self._dims[axis]):
                coord = list(coords_other[:axis]) + [k] + list(coords_other[axis:])
                group.append(self.get_rank(**dict(zip(self._parallel_names, coord))))
            groups.append(group)
        return groups


class HybridCommunicateGroup:
    """reference: topology.py:111. Builds the job's ``Mesh`` (so every
    rank must construct it, as the reference's comm rings are made by all
    ranks) and sets it as the global mesh; the per-axis "groups" it hands
    out are the mesh's axis names, which the collectives take."""

    def __init__(self, topology=None, dp=1, mp=1, pp=1, sharding=1, sp=1):
        if topology is not None:
            dims = [topology.get_dim(n) for n in topology.get_hybrid_group_names()]
            if len(dims) == 4:
                dp, pp, sharding, mp = dims
            else:
                dp, pp, sharding, sp, mp = dims
        self._dp_degree = dp
        self._mp_degree = mp
        self._pp_degree = pp
        self._sharding_degree = sharding
        self._sp_degree = sp
        self._topo = CommunicateTopology(
            ("data", "pipe", "sharding", "sep", "model"), (dp, pp, sharding, sp, mp))
        self.mesh = build_mesh(dp=dp, mp=mp, pp=pp, sharding=sharding, sp=sp)
        set_global_mesh(self.mesh)
        self.global_rank = _world()[1]
        self._coord = self._topo.get_coord(min(self.global_rank, self._topo.world_size() - 1))

    # --- degree getters (reference :209-254) ---
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sp_degree

    def get_sep_parallel_group(self):
        return "sp"

    def get_data_parallel_rank(self):
        return self._coord[0]

    def get_pipe_parallel_rank(self):
        return self._coord[1]

    def get_sharding_parallel_rank(self):
        return self._coord[2]

    def get_model_parallel_rank(self):
        return self._coord[3]

    # mesh axis names usable in collectives
    def get_data_parallel_group(self):
        return "dp"

    def get_model_parallel_group(self):
        return "mp"

    def get_pipe_parallel_group(self):
        return "pp"

    def get_sharding_parallel_group(self):
        return "sharding"

    def get_check_parallel_group(self):
        return None

    def get_data_parallel_group_src_rank(self):
        return 0

    def get_model_parallel_group_src_rank(self):
        return 0

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and self._dp_degree > 1:
            return "data"
        if self._mp_degree > 1 and self._pp_degree == 1:
            return "model" if self._dp_degree == 1 else "hybrid"
        if self._pp_degree > 1:
            return "pipe" if self._dp_degree == 1 and self._mp_degree == 1 else "hybrid"
        return "single"


def set_hybrid_communicate_group(hcg):
    global _HYBRID_GROUP
    _HYBRID_GROUP = hcg


def get_hybrid_communicate_group():
    return _HYBRID_GROUP
