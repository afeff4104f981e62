"""Reverse-mode autograd (counterpart of paddle_tpu/core/tape.py), mapped
onto torch autograd.

``backward(tensors, grad_tensors, retain_graph)`` accumulates into the
leaves' ``.grad`` (gradients add up across backwards until
``clear_grad``), running each tensor's hooks first, as the reference's
engine does. ``grad(outputs, inputs, ...)`` returns the gradients without
touching ``.grad``; ``create_graph=True`` records the backward so the
result is differentiable again (double grad). A non-scalar output without
its gradient, and an input the outputs do not reach (unless
``allow_unused``), raise InvalidArgumentError as in the reference.
"""
import torch

from . import errors
from .tensor import Tensor, plain, wrap

_base = torch.Tensor


def _as_list(x):
    if x is None:
        return None
    if isinstance(x, _base):
        return [x]
    return list(x)


def _grad_arg(g, like):
    if g is None:
        return None
    if isinstance(g, _base):
        return plain(g)
    return torch.as_tensor(g, dtype=like.dtype, device=like.device)


def _roots(tensors, grads, what):
    outs, gs = [], []
    for t, g in zip(tensors, grads):
        if not t.requires_grad:  # stop_gradient and no graph: nothing to do
            continue
        if g is None and t.numel() != 1:
            raise errors.InvalidArgumentError(
                f"{what} on a non-scalar tensor requires its gradient")
        outs.append(t)  # the graph's own tensor: an alias would not be its input
        gs.append(torch.ones_like(plain(t)) if g is None else _grad_arg(g, t))
    return outs, gs


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward (reference: imperative/basic_engine.cc)."""
    tensors = _as_list(tensors)
    grads = _as_list(grad_tensors) or [None] * len(tensors)
    outs, gs = _roots(tensors, grads, "backward()")
    if outs:
        torch.autograd.backward(outs, gs, retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         only_inputs=True, allow_unused=False):
    """paddle.grad — gradients of ``outputs`` w.r.t. ``inputs`` (reference:
    imperative/partial_grad_engine.cc)."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    grads = _as_list(grad_outputs) or [None] * len(outputs)
    outs, gs = _roots(outputs, grads, "grad()")
    if outs:
        res = torch.autograd.grad(outs, inputs, gs, retain_graph=retain_graph,
                                  create_graph=create_graph, allow_unused=True)
    else:
        res = [None] * len(inputs)
    out = []
    for g in res:
        if g is None and not allow_unused:
            raise errors.InvalidArgumentError(
                "an input tensor received no gradient; pass allow_unused=True")
        out.append(None if g is None else wrap(g))
    return out
