"""Explicit control flow (counterpart of paddle_tpu/static/
nn_control_flow.py; reference: operators/controlflow/
conditional_block_op.cc, while_op.cc, exposed as fluid/layers/
control_flow.py cond, while_loop, case, switch_case).

They reuse dy2static's converters (jit/dy2static.py): a predicate that is
a Python value, or a tensor outside a ``torch.export`` capture, picks its
branch in Python, so a recording Program keeps the branch its
placeholders pick at build time, as the reference's does; under a
capture (``to_static``, ``jit.save``) a tensor predicate lowers to
torch's ``cond``/``while_loop`` operators (``case`` and ``switch_case``
to a selection among their computed branches).
"""
import torch
from torch.utils import _pytree as pytree

from ..core.tensor import capturing, plain, wrap_all
from ..jit.dy2static import _pred_value, convert_ifelse, convert_while


def _single(out):
    return out[0] if isinstance(out, tuple) and len(out) == 1 else out


def cond(pred, true_fn=None, false_fn=None, name=None):
    """reference: layers.cond — the branches take no arguments and
    return outputs of one structure; a None branch returns None."""
    true_fn = true_fn or (lambda: None)
    false_fn = false_fn or (lambda: None)
    kind, p = _pred_value(pred)
    if kind == "py":
        return true_fn() if p else false_fn()
    return wrap_all(_single(convert_ifelse(p, true_fn, false_fn, ())))


def while_loop(cond, body, loop_vars, is_test=False, name=None, maximum_iterations=None):
    """reference: layers.while_loop — ``body`` returns the next loop_vars;
    shapes and dtypes are loop-invariant (while_op's contract).
    ``maximum_iterations`` bounds the loop."""
    cond_fn, body_fn = cond, body
    out = convert_while(lambda *vs: cond_fn(*vs), lambda *vs: tuple(body_fn(*vs)),
                        tuple(loop_vars), maximum_iterations=maximum_iterations)
    return list(wrap_all(tuple(out)))


def _select(preds, fns, fallback):
    """Under a capture: every branch computed, the first true predicate's
    output selected (torch has no multi-way cond operator, and a cond
    nested in a cond's branch does not run)."""
    leaves, spec = pytree.tree_flatten(fallback())
    for p, fn in reversed(list(zip(preds, fns))):
        other = pytree.tree_leaves(fn())
        leaves = [torch.where(p, plain(o), plain(v)) for o, v in zip(other, leaves)]
    return wrap_all(pytree.tree_unflatten(leaves, spec))


def case(pred_fn_pairs, default=None, name=None):
    """reference: layers.case — the first true predicate wins; without
    ``default`` the last pair's function is the fallback. A traced
    predicate selects as ``_select`` says."""
    if not pred_fn_pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")
    fallback = default if default is not None else pred_fn_pairs[-1][1]
    preds, fns = [], []
    for pred, fn in pred_fn_pairs:
        kind, p = _pred_value(pred)
        if kind == "py":
            if p:
                fallback = fn
                break
            continue
        preds.append(p.to(torch.bool))
        fns.append(fn)
    if not preds:
        return fallback()
    return _select(preds, fns, fallback)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """reference: layers.switch_case — the branch of key
    ``branch_index``; an index with no branch takes ``default``, else the
    largest key's branch."""
    if not branch_fns:
        raise ValueError("switch_case: branch_fns must be non-empty")
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = (list(enumerate(branch_fns)) if callable(branch_fns[0])
                 else sorted(branch_fns))
    keys = [k for k, _ in items]
    fns = [f for _, f in items]
    fallback = default if default is not None else fns[-1]
    kind, idx = _index_value(branch_index)
    if kind == "py":
        return fns[keys.index(idx)]() if idx in keys else fallback()
    return _select([idx == k for k in keys], fns, fallback)


def _index_value(index):
    """-> ('py', int) | ('traced', 0-d tensor) for a branch index."""
    if isinstance(index, torch.Tensor):
        t = plain(index).reshape(())
        return ("traced", t) if capturing() else ("py", int(t))
    return "py", int(index)
