"""Auxiliary-loss plumbing for layers whose forward emits a side loss
(counterpart of paddle_tpu/nn/aux_loss.py; MoE load balancing, GShard's
aux loss).

A layer's forward calls ``emit_aux_loss(self, value)``; where the value
goes depends on the context:

- under ``collect_aux_losses()`` (the training steps of
  ``distributed.spmd`` and ``comm_opt``) it joins the collector's list,
  which the step adds to its loss, and ``layer.aux_loss`` is cleared;
- under ``drop_aux_losses()`` (the pipeline's and FSDP's per-stage
  applies, as the reference drops it there) or inside a
  ``torch.compile``/``torch.export`` capture, it is dropped;
- otherwise (eager) it is stored on ``layer.aux_loss`` for the caller to
  add to the loss.
"""
import contextlib
import contextvars

import torch

_DROP = object()
_COLLECTOR = contextvars.ContextVar("aux_loss_collector", default=None)


@contextlib.contextmanager
def collect_aux_losses():
    """Collect every aux loss emitted during the block; yields the list
    to add to the training objective."""
    acc = []
    token = _COLLECTOR.set(acc)
    try:
        yield acc
    finally:
        _COLLECTOR.reset(token)


@contextlib.contextmanager
def drop_aux_losses():
    """Drop every aux loss emitted during the block."""
    token = _COLLECTOR.set(_DROP)
    try:
        yield
    finally:
        _COLLECTOR.reset(token)


def emit_aux_loss(layer, value):
    """Called by a layer's forward with its auxiliary loss contribution."""
    acc = _COLLECTOR.get()
    if isinstance(acc, list):
        acc.append(value)
        layer.aux_loss = None
    elif acc is _DROP or torch.compiler.is_compiling():
        layer.aux_loss = None
    else:
        layer.aux_loss = value


def total_aux_loss(collected):
    """Sum a collector's list (0.0 when nothing was emitted)."""
    total = None
    for v in collected:
        total = v if total is None else total + v
    return 0.0 if total is None else total


def clear_direct_aux_losses(layer):
    """Null every sublayer's ``aux_loss`` before a step's forward, so the
    sweep after it sees only the losses this forward emitted."""
    for sub in layer.modules():
        if getattr(sub, "aux_loss", None) is not None:
            sub.aux_loss = None


def sweep_direct_aux_losses(layer, collected):
    """Layers that assign ``self.aux_loss`` directly (without
    ``emit_aux_loss``) still get their term collected, and cleared. Call
    ``clear_direct_aux_losses`` before the forward and this after it."""
    for sub in layer.modules():
        aux = getattr(sub, "aux_loss", None)
        if aux is not None:
            collected.append(aux)
            sub.aux_loss = None
