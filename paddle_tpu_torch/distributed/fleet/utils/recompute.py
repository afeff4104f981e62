"""Activation recompute (counterpart of
paddle_tpu/distributed/fleet/utils/recompute.py; reference:
fleet/utils/recompute.py PyLayer-based RecomputeFunction).

The reference's eager form runs the segment as it is (its tape already
recomputes each op's forward in the backward), and its traced form is
jax.checkpoint inside a compiled step. The port's step has its own
``recompute=True`` (torch.utils.checkpoint around the whole loss, with
the dropout keys replayed); called eagerly, ``recompute`` runs the
segment as the reference's eager form does, so its dropout draws the
same keys once.
"""


def recompute(function, *args, **kwargs):
    kwargs.pop("preserve_rng_state", True)
    return function(*args, **kwargs)
