"""Hybrid-parallel glue (counterpart of
paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py; reference:
fleet/utils/hybrid_parallel_util.py: broadcast_mp_parameters:93,
fused_allreduce_gradients:107).

The JAX package's functions are no-ops: XLA has already averaged the
gradients inside its compiled step, and its parameters are global arrays
(hybrid_parallel_util.py:1-9). The port's eager ranks hold local
gradients and their own copies of the parameters, so here these do what
the reference's do on its GPUs: ``fused_allreduce_gradients`` averages
every gradient over the data-parallel group (one coalesced all-reduce a
dtype), and the broadcasts copy rank 0's parameters of the group to the
others. The result is the JAX package's. ``broadcast_mp_parameters``
skips the tensor-parallel parameters (``is_distributed``, or an
``mp_spec`` over "mp"), as Paddle's own does: each mp rank's block is its
own and must not be overwritten by rank 0's.
"""
import torch

from ...topology import get_hybrid_communicate_group
from ... import collective
from ...meta_parallel.mp_layers import mp_dim


def _axis_group(hcg, getter):
    hcg = hcg or get_hybrid_communicate_group()
    return getattr(hcg, getter)() if hcg is not None else "dp"


def fused_allreduce_gradients(parameter_list, hcg):
    grads = [p.grad for p in parameter_list if p.grad is not None]
    collective.coalesced_mean(grads, _axis_group(hcg, "get_data_parallel_group"))


def _broadcast_parameters(model, group, skip=lambda p: False):
    with torch.no_grad():
        for p in torch.nn.Module.parameters(model):
            if not skip(p):
                collective.broadcast(p.data, 0, group)


def _mp_sharded(p):
    return getattr(p, "is_distributed", False) or mp_dim(getattr(p, "mp_spec", None)) is not None


def broadcast_mp_parameters(model, hcg):
    _broadcast_parameters(model, _axis_group(hcg, "get_model_parallel_group"), _mp_sharded)


def broadcast_dp_parameters(model, hcg):
    _broadcast_parameters(model, _axis_group(hcg, "get_data_parallel_group"))


def broadcast_sharding_parameters(model, hcg):
    _broadcast_parameters(model, _axis_group(hcg, "get_sharding_parallel_group"))
