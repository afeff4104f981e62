"""Optimizers (counterpart of the ``Optimizer``, ``Adam`` and ``AdamW`` of
paddle_tpu/optimizer/optimizer.py).

Each optimizer is the reference's functional core, a per-parameter
``_update(p, g, lr, *state, **hypers) -> (new_p, *new_state)`` written on
torch tensors in the reference's own order of operations (``t`` is a
float32 scalar state), plus the Paddle-style mutable shell
(``step()``, ``clear_grad()``). ``torch.optim`` is not used: its AdamW
orders the update differently and would not hold parity. The training step
(distributed/spmd.py) calls the same ``_update``.

Not ported yet: learning-rate schedulers (``optimizer/lr.py``) and
regularizer objects as ``weight_decay``; both raise.
"""
import torch


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers (optimizer/lr.py) are not ported yet; "
                "pass a float learning_rate")
        self._parameter_list = list(parameters) if parameters is not None else None
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        if weight_decay is None:
            self._coupled_wd = 0.0
        elif isinstance(weight_decay, float):
            self._coupled_wd = weight_decay
        else:
            raise NotImplementedError(
                "regularizer objects (L1Decay/L2Decay) are not ported yet; pass a "
                "float weight_decay")
        self._accumulators = {}

    def get_lr(self):
        return self._learning_rate

    # ------------------------------------------------------------ functional core
    def _init_state(self, p):
        """The tuple of state tensors for one parameter."""
        return ()

    @staticmethod
    def _update(p, g, lr, *state, **hypers):
        raise NotImplementedError

    def _hypers(self):
        return {"l2": self._coupled_wd}

    # ------------------------------------------------------------ eager step
    @property
    def _params(self):
        if self._parameter_list is None:
            raise ValueError("this optimizer was built without a `parameters` list")
        return self._parameter_list

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient, in place."""
        params = [p for p in self._params if p.requires_grad and p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_arrays(grads)
        hypers = self._hypers()
        for p, g in zip(params, grads):
            state = self._accumulators.get(id(p))
            if state is None:
                state = self._init_state(p)
            lr = torch.full((), self.get_lr(), dtype=torch.float32, device=p.device)
            out = type(self)._update(p, g, lr, *state, **hypers)
            p.copy_(out[0])
            self._accumulators[id(p)] = tuple(out[1:])

    def clear_grad(self, set_to_zero=True):
        for p in self._params:
            p.grad = None


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = epsilon

    def _hypers(self):
        h = super()._hypers()
        h.update(b1=self._beta1, b2=self._beta2, eps=self._epsilon)
        return h

    def _init_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p),
                torch.zeros((), dtype=torch.float32, device=p.device))

    @staticmethod
    def _update(p, g, lr, m, v, t, *, b1=0.9, b2=0.999, eps=1e-8, l2=0.0):
        g = g.to(p.dtype)
        if l2:
            g = g + l2 * p
        t_new = t + 1
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / (1 - b1 ** t_new).to(p.dtype)
        vhat = v_new / (1 - b2 ** t_new).to(p.dtype)
        p_new = p - lr.to(p.dtype) * mhat / (torch.sqrt(vhat) + eps)
        return p_new, m_new, v_new, t_new


class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError("AdamW lr_ratio / apply_decay_param_fun are not "
                                      "ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, None,
                         grad_clip, lazy_mode, multi_precision, name)
        self._wd = weight_decay if isinstance(weight_decay, float) else 0.01

    def _hypers(self):
        h = super()._hypers()
        h.update(wd=self._wd)
        h["l2"] = 0.0
        return h

    @staticmethod
    def _update(p, g, lr, m, v, t, *, b1=0.9, b2=0.999, eps=1e-8, wd=0.01, l2=0.0):
        g = g.to(p.dtype)
        t_new = t + 1
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / (1 - b1 ** t_new).to(p.dtype)
        vhat = v_new / (1 - b2 ** t_new).to(p.dtype)
        lr = lr.to(p.dtype)
        p_new = p - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p)
        return p_new, m_new, v_new, t_new
