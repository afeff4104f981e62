"""Functional autograd transforms (counterpart of
paddle_tpu/incubate/autograd.py): ``vjp``, ``jvp``, ``jacobian`` and
``hessian`` over ``torch.func``.

``func`` is a Paddle function of Tensors. It is functionalized as the
reference functionalizes it: the transform sees a function of plain
tensors, which wraps its inputs as Tensors for ``func`` and unwraps what
``func`` returns (the port's Tensor turns ``__torch_function__`` off, so
``torch.func`` must not see one). The results are Tensors, in the
reference's structures: ``vjp`` -> (out, [grads]), ``jvp`` -> (out,
tangent_out), ``jacobian`` -> one Tensor for a single input, a list for a
list, and ``hessian`` -> one Tensor for a single input, the nested
tuple-of-tuples ``H[i][j]`` (plain tensors, as the reference returns its
raw arrays) for a list.
"""
import torch
import torch.func

from ..core.tensor import plain, wrap, wrap_all

__all__ = ["vjp", "jvp", "jacobian", "hessian"]


def _functionalize(fn):
    def pure(*arrays):
        out = fn(*[wrap(a) for a in arrays])
        if isinstance(out, (tuple, list)):
            return tuple(plain(o) for o in out)
        return plain(out)

    return pure


def _inputs(xs):
    xs_list = xs if isinstance(xs, (list, tuple)) else [xs]
    return [plain(x).detach() for x in xs_list]


def vjp(func, xs, v=None):
    arrs = _inputs(xs)
    out, vjp_fn = torch.func.vjp(_functionalize(func), *arrs)
    v = torch.ones_like(out) if v is None else plain(v)
    return wrap(out), [wrap(g) for g in vjp_fn(v)]


def jvp(func, xs, v=None):
    arrs = _inputs(xs)
    if v is None:
        tangents = [torch.ones_like(a) for a in arrs]
    else:
        tangents = [plain(t) for t in (v if isinstance(v, (list, tuple)) else [v])]
    out, tangent_out = torch.func.jvp(_functionalize(func), tuple(arrs), tuple(tangents))
    return wrap(out), wrap(tangent_out)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    arrs = _inputs(xs)
    jac = torch.func.jacrev(_functionalize(func), argnums=tuple(range(len(arrs))))(*arrs)
    if not isinstance(xs, (list, tuple)):
        return wrap(jac[0])
    return [wrap(j) for j in jac]


def hessian(func, xs, create_graph=False, allow_unused=False):
    arrs = _inputs(xs)
    hess = torch.func.hessian(_functionalize(func), argnums=tuple(range(len(arrs))))(*arrs)
    if not isinstance(xs, (list, tuple)):
        return wrap_all(hess[0][0])
    return hess
