"""The pipeline's layer helpers that ZeRO-3's ``build_fsdp_train_step``
shares (counterpart of ``_functional_apply`` and ``split_pre_trunk_post``
in paddle_tpu/distributed/pipeline.py:34, :58). The pipeline-parallel
step itself is the model-parallel slice's.
"""
import contextlib

import torch

from ..amp.auto_cast import auto_cast
from ..core import random as random_core


def functional_apply(layer, params, x, key, amp=None):
    """``layer``'s forward on ``x`` with ``params`` ({name: tensor}) in
    place of its own, its random ops under ``rng_guard(key)``; ``amp``:
    (level, dtype) to run it under ``auto_cast``, or None."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(random_core.rng_guard(key))
        if amp is not None:
            stack.enter_context(auto_cast(enable=True, level=amp[0], dtype=amp[1]))
        return torch.func.functional_call(layer, params, (x,))


def _layer_signature(layer):
    """Structural identity for homogeneity: class + param shapes/dtypes."""
    return (type(layer).__name__,
            tuple((n, tuple(p.shape), str(p.dtype)) for n, p in layer.named_parameters()))


def split_pre_trunk_post(layers, num_stages):
    """Find the longest contiguous run of structurally identical layers
    whose length divides into num_stages equal segments (right-aligned
    in its run). Returns (pre_layers, trunk_layers, post_layers)."""
    n = len(layers)
    sigs = [_layer_signature(l) for l in layers]
    best = None  # (length, start)
    i = 0
    while i < n:
        j = i
        while j < n and sigs[j] == sigs[i]:
            j += 1
        usable = ((j - i) // num_stages) * num_stages
        if usable >= num_stages and (best is None or usable > best[0]):
            best = (usable, i + (j - i - usable))
        i = j
    if best is None:
        raise ValueError(f"no contiguous run of {num_stages}+ structurally-identical layers "
                         "found; pipeline needs a homogeneous trunk")
    length, start = best
    return (list(layers[:start]), list(layers[start:start + length]),
            list(layers[start + length:]))
