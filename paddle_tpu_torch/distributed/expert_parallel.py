"""Expert parallelism over a mesh's "ep" axis: the scope a training step
opens around its forward for ``incubate.moe.MoELayer`` (the reference
has none: its MoE layer is one SPMD program that XLA partitions).

A parameter whose ``mp_spec`` names "ep" (``MoELayer``'s stacked experts
``w_up [E, H, F]`` and ``w_down [E, F, H]``, ``mp_spec = ("ep",)``) is
held by each rank of the ep axis as its block on that dimension: rank r
keeps experts ``[r * E / ep, (r + 1) * E / ep)``. Inside
``expert_parallel(mesh, data)`` the layer runs its experts over the ep
group (``scope().ep``, an ``AxisGroup``) with the mp layers' Megatron
Functions (``mp_layers.CopyToMP``/``ReduceFromMP``/``ScatterToMP``/
``GatherFromMP``, which take any axis) and ``AllToAll``; ``scope().data``
is the step's ``DataGroup`` where the forward is the reference's global
program over several data ranks (the capacity slots and the aux loss's
means then count every data rank's tokens), else None (a local batch:
the pipeline's stage interior, the local-gradient modes).
"""
import contextlib
import contextvars

import torch

from . import collective
from .topology import AxisGroup

_SCOPE = contextvars.ContextVar("expert_parallel", default=None)


class ExpertScope:
    """``ep``: the ep ``AxisGroup`` (None: this rank holds every expert);
    ``data``: the step's ``DataGroup`` when the forward is the global
    program over several data ranks, else None."""

    def __init__(self, ep=None, data=None):
        self.ep = ep
        self.data = data


@contextlib.contextmanager
def expert_parallel(mesh=None, data=None):
    """Run the enclosed forward with the MoE layers over ``mesh``'s ep axis
    (when it has more than one rank) and ``data`` (a ``DataGroup`` of more
    than one rank, or None). Yields the scope, or None when there is
    neither."""
    ep = AxisGroup(mesh, "ep") if mesh is not None and mesh.axis_size("ep") > 1 else None
    if data is not None and data.n == 1:
        data = None
    if ep is None and data is None:
        yield None
        return
    token = _SCOPE.set(ExpertScope(ep, data))
    try:
        yield _SCOPE.get()
    finally:
        _SCOPE.reset(token)


def scope():
    """The active ``ExpertScope``, or None."""
    return _SCOPE.get()


class AllToAll(torch.autograd.Function):
    """``collective.all_to_all_spmd`` over ``group`` (the reference's
    ``lax.all_to_all(tiled=True)``): ``x`` split in the group's size along
    ``split``, block j to rank j, the blocks received concatenated along
    ``concat`` in rank order; the backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return collective.all_to_all_spmd(x.contiguous(), group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (collective.all_to_all_spmd(g.contiguous(), ctx.group, ctx.concat, ctx.split),
                None, None, None)
