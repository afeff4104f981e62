"""Parameter-averaging optimizer wrappers (counterpart of
paddle_tpu/optimizer/wrappers.py): ``ExponentialMovingAverage``,
``LookAhead`` and ``ModelAverage``.

Eager wrappers over a layer's parameters: their shadow state is a tensor
per parameter on the parameter's device, and ``apply()`` copies it into
the parameters in place (``restore()`` copies the backup back), the
reference's apply/restore contract. The arithmetic is the reference's, in
its order, in the parameters' dtype, so the same steps give the same bits.
"""
import contextlib

import torch


def _restoring(wrapper, need_restore):
    @contextlib.contextmanager
    def guard():
        try:
            yield
        finally:
            if need_restore:
                wrapper.restore()

    return guard()


class _Swapping:
    """apply()/restore() around evaluation: ``_swap_in()`` gives the
    values to put into the parameters."""

    def apply(self, executor=None, need_restore=True):
        """Put the averaged weights in; ``with wrapper.apply():`` restores
        them on exit when ``need_restore``."""
        with torch.no_grad():
            self._backup = {id(p): p.detach().clone() for p in self._params}
            for p, value in zip(self._params, self._swap_in()):
                p.copy_(value)
        return _restoring(self, need_restore)

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup[id(p)])
        self._backup = {}


class ExponentialMovingAverage(_Swapping):
    """shadow = d * shadow + (1 - d) * param after each ``update()``, with
    d = min(decay, (1 + t) / (10 + t)) (the reference's zero-debias);
    ``apply()`` puts the shadow weights in."""

    def __init__(self, decay=0.999, thres_steps=None, parameters=None, layer=None, name=None):
        if layer is not None:
            parameters = list(layer.parameters())
        if not parameters:
            raise ValueError("EMA needs parameters= or layer=")
        self._params = list(parameters)
        self._decay = decay
        self._step = 0
        self._shadow = {id(p): p.detach().clone() for p in self._params}
        self._backup = {}

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        for p in self._params:
            self._shadow[id(p)] = d * self._shadow[id(p)] + (1 - d) * p.detach()

    def _swap_in(self):
        return [self._shadow[id(p)] for p in self._params]


class LookAhead:
    """The inner optimizer's fast weights step every iteration; every
    ``k`` steps slow += alpha * (fast - slow) and fast = slow."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        self.inner_optimizer = inner_optimizer
        self._alpha = alpha
        self._k = int(k)
        self._step = 0
        self._params = list(inner_optimizer._parameter_list or [])
        self._slow = {id(p): p.detach().clone() for p in self._params}

    def step(self):
        self.inner_optimizer.step()
        self._step += 1
        if self._step % self._k == 0:
            with torch.no_grad():
                for p in self._params:
                    slow = self._slow[id(p)] + self._alpha * (p.detach() - self._slow[id(p)])
                    self._slow[id(p)] = slow
                    p.copy_(slow)

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage(_Swapping):
    """A running sum of the parameters over a window of updates (restarted
    from the current weights once the window is passed twice, the
    reference's simplification of average_accumulates); ``apply()`` puts
    the average in."""

    def __init__(self, average_window_rate=0.15, parameters=None, layer=None,
                 min_average_window=10000, max_average_window=10000000, name=None):
        if layer is not None:
            parameters = list(layer.parameters())
        if not parameters:
            raise ValueError("ModelAverage needs parameters= or layer=")
        self._params = list(parameters)
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._n = 0
        self._sum = {id(p): torch.zeros_like(p.detach()) for p in self._params}
        self._backup = {}

    @torch.no_grad()
    def update(self):
        self._n += 1
        window = max(self._min_w, min(self._max_w, int(self._n * self._rate) or 1))
        for p in self._params:
            s = self._sum[id(p)] + p.detach()
            if self._n > window * 2:
                s = p.detach().to(s.dtype, copy=True)
            self._sum[id(p)] = s
        if self._n > window * 2:
            self._n = 1

    def _swap_in(self):
        n = max(self._n, 1)
        return [(self._sum[id(p)] / n).to(p.dtype) for p in self._params]
