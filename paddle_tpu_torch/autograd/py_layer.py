"""PyLayer — user-defined forward and backward (counterpart of
paddle_tpu/autograd/py_layer.py), built over ``torch.autograd.Function``.

``forward(ctx, *args, **kwargs)`` runs with grad off and sees the
arguments as given; ``backward(ctx, *grads)`` gets one gradient per
output (as Tensors) and returns one per Tensor argument of ``forward``,
in order. Saved tensors go through torch's ``save_for_backward`` (so a
backward under ``paddle.grad(..., create_graph=True)`` is differentiable
again, the reference's double-grad path); anything else saved is kept
as given.
"""
import torch

from ..core.tensor import wrap, wrap_all

_base = torch.Tensor


class PyLayerContext:
    def __init__(self, fn_ctx=None):
        self._ctx = fn_ctx
        self.container = None
        self._materialize_grads = True

    def save_for_backward(self, *tensors):
        if self._ctx is not None and all(t is None or isinstance(t, _base) for t in tensors):
            self._ctx.save_for_backward(*tensors)
            self.container = None
        else:
            self.container = tensors

    def saved_tensor(self):
        if self.container is not None:
            return self.container
        return tuple(wrap(t) for t in self._ctx.saved_tensors)

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        if self._ctx is not None:
            self._ctx.mark_non_differentiable(*args)

    def set_materialize_grads(self, value):
        self._materialize_grads = bool(value)
        if self._ctx is not None:
            self._ctx.set_materialize_grads(bool(value))


def _function_of(cls):
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kwargs, *args):
            pctx = PyLayerContext(ctx)
            ctx.pylayer_ctx = pctx
            ctx.is_tensor = [isinstance(a, _base) for a in args]
            out = cls.forward(pctx, *args, **kwargs)
            return out

        @staticmethod
        def backward(ctx, *grads):
            grads = tuple(None if g is None else wrap(g) for g in grads)
            res = cls.backward(ctx.pylayer_ctx, *grads)
            if not isinstance(res, (tuple, list)):
                res = (res,)
            res = iter(res)
            out = [None]
            for is_t in ctx.is_tensor:
                out.append(next(res, None) if is_t else None)
            return tuple(out)

    _Fn.__name__ = f"PyLayer_{cls.__name__}"
    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    @classmethod
    def apply(cls, *args, **kwargs):
        return wrap_all(_function_of(cls).apply(kwargs, *args))

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError
