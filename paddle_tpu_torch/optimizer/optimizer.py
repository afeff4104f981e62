"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py: the
``Optimizer`` base :27-250 and the eleven optimizers :252-618).

Each optimizer is the reference's functional core, a per-parameter
``_update(p, g, lr, *state, **hypers) -> (new_p, *new_state)`` written on
torch tensors in the reference's own order of operations (``t`` is a
float32 scalar state), plus the Paddle-style mutable shell (``step()``,
``minimize()``, ``clear_grad()``, ``state_dict()``). ``torch.optim`` is not
used: its updates order the operations differently and would not hold
parity. The training step (distributed/spmd.py) calls the same
``_update``.

``learning_rate`` is a float or an ``lr.LRScheduler``; ``weight_decay`` a
float (L2), a ``regularizer.L2Decay`` or an ``L1Decay``. The
per-parameter knobs are attributes set on the torch Parameter:
``regularizer`` (an L1Decay/L2Decay that overrides the optimizer's),
``optimize_attr = {"learning_rate": ratio}``, ``need_clip = False``, and
``param_name``, the reference's ``Parameter.name`` (torch keeps ``name``
for named tensors): what ``apply_decay_param_fun`` and ``state_dict``
see, ``param_{i}`` in a state dict where it is unset.

As in the reference, the per-parameter knobs act only in the eager
``step()``: the training step reads ``_hypers()`` once, for no parameter
(AdamW's ``apply_decay_param_fun``, a parameter's ``regularizer``,
Lamb's exclusion and ``optimize_attr`` do not reach it). L1 decay is
applied centrally as ``g + coeff * sign(p)`` before ``_update``, under the
key ``l1_reg`` (Ftrl's own ``l1`` is a hyper of its update). AdamW's
``lr_ratio``, which the reference accepts and never reads, raises here.
"""
import torch

from . import lr as lr_mod


def _coeff(reg, default):
    return getattr(reg, "_coeff", getattr(reg, "coeff", default))


def _is_l1(reg):
    return type(reg).__name__.startswith("L1")


def local_sum_sq(*tensors):
    """The sum of squares of each tensor (``_update_one``'s ``sum_sq`` for
    a whole parameter)."""
    return [torch.sum(torch.square(t)) for t in tensors]


class Optimizer:
    _hyper_defaults = {}

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        self._parameter_list = list(parameters) if parameters is not None else None
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._name = name
        self._coupled_l1 = 0.0
        if weight_decay is None:
            self._coupled_wd = 0.0
        elif isinstance(weight_decay, (int, float)) and not isinstance(weight_decay, bool):
            self._coupled_wd = float(weight_decay)
        elif _is_l1(weight_decay):
            # L1Decay: grad += coeff * sign(param), not L2's coeff * param
            self._coupled_wd = 0.0
            self._coupled_l1 = _coeff(weight_decay, 0.0)
        else:  # L2Decay
            self._coupled_wd = _coeff(weight_decay, 0.0)
        self._accumulators = {}
        self._step_count = 0

    # ------------------------------------------------------------ lr
    def get_lr(self):
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    @property
    def _lr_scheduler(self):
        return self._learning_rate if isinstance(self._learning_rate,
                                                 lr_mod.LRScheduler) else None

    # ------------------------------------------------------------ functional core
    def _init_state(self, p):
        """The tuple of state tensors for one parameter."""
        return ()

    @staticmethod
    def _update(p, g, lr, *state, **hypers):
        raise NotImplementedError

    def _hypers(self, param=None):
        h = dict(self._hyper_defaults)
        h["l2"] = self._coupled_wd
        if self._coupled_l1:
            h["l1_reg"] = self._coupled_l1
        reg = getattr(param, "regularizer", None) if param is not None else None
        if reg is not None:
            coeff = _coeff(reg, h["l2"])
            if _is_l1(reg):
                # a parameter's L1 overrides the optimizer's decay for it
                h["l1_reg"], h["l2"] = coeff, 0.0
            else:
                h["l2"] = coeff
                h.pop("l1_reg", None)
        return h

    @classmethod
    def _update_one(cls, p, g, lr, state, hypers, l1, sum_sq=None):
        """One parameter's update as every path applies it (the eager
        step, ``apply_gradients_arrays``, ``build_train_step``): the L1
        term ``g + l1 * sign(p)`` (reference spmd.py:239, :337-338), then
        ``_update``. Returns (new parameter, new state tuple).

        ``sum_sq(*tensors)`` -> one 0-d sum of squares per tensor: how an
        update that reads a norm of the whole parameter (Lamb's and LARS'
        trust ratio; ``_elementwise`` false) sums the squares of ``p`` and
        of its update when ``p`` is a block of it (a ZeRO, mp, ep or pp
        block: the blocks' sums added over their ranks). None: ``p`` is
        the whole parameter."""
        if l1:
            g = g + l1 * torch.sign(p)
        if sum_sq is not None and not cls._elementwise(hypers):
            out = cls._update(p, g, lr, *state, sum_sq=sum_sq, **hypers)
        else:
            out = cls._update(p, g, lr, *state, **hypers)
        return out[0], tuple(out[1:])

    @classmethod
    def _elementwise(cls, hypers):
        """Whether ``_update`` acts on each element alone, so that the
        update of a block of a parameter is that block of the update;
        false where it takes a norm over the whole parameter (it then
        takes ``sum_sq``, see ``_update_one``)."""
        return True

    @staticmethod
    def _take_l1(hypers):
        """Pop the L1 coefficient (key ``l1_reg``, not ``l1``: Ftrl's own
        ``l1`` must reach its update) out of a hypers dict."""
        return hypers.pop("l1_reg", 0.0)

    # ------------------------------------------------------------ eager step
    @property
    def _params(self):
        if self._parameter_list is None:
            raise ValueError("this optimizer was built without a `parameters` list")
        return self._parameter_list

    def _apply(self, params, grads, lr, ratios=True, views=None, sum_sq=None):
        """One ``_update`` per parameter, in place: the parameter's own
        hypers, its L1 term and (``ratios``, the eager step's) its
        ``optimize_attr`` learning-rate ratio. ``views[i]``: the part of
        ``params[i]`` to update (a ZeRO rank's block, which ``grads[i]``
        and the parameter's accumulators then hold), else all of it;
        ``sum_sq[i]``: that block's ``sum_sq`` (``_update_one``)."""
        for i, (p, g) in enumerate(zip(params, grads)):
            target = p if views is None else views[i]
            ratio = (getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
                     if ratios else 1.0)
            state = self._accumulators.get(id(p))
            if state is None:
                state = self._init_state(target)
            hypers = self._hypers(p)
            l1 = self._take_l1(hypers)
            lr_t = torch.full((), lr, dtype=torch.float32, device=p.device) * ratio
            new_p, self._accumulators[id(p)] = self._update_one(
                target, g, lr_t, state, hypers, l1, None if sum_sq is None else sum_sq[i])
            target.copy_(new_p)

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient, in place."""
        self._step_count += 1
        params = [p for p in self._params if p.requires_grad and p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_arrays(grads)
        self._apply(params, grads, self.get_lr())

    def clear_grad(self, set_to_zero=True):
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        """Eager: ``loss.backward()`` then ``step()``. Under static mode it
        attaches ``(self, loss)`` to the recording program, whose
        ``Executor.run`` is then one training step (static/program.py)."""
        from ..jit import in_dynamic_mode

        if not in_dynamic_mode():
            from ..static import program as prog_mod

            prog = prog_mod.recording_program() or prog_mod.default_main_program()
            prog.train_attach = (self, loss)
            return [], []
        loss.backward()
        self.step()
        return [], []

    def backward(self, loss, **kw):
        loss.backward()

    @torch.no_grad()
    def apply_gradients(self, params_grads):
        """Update from (param, grad) pairs: the clip's pair form, then one
        ``_update`` per parameter with a gradient."""
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        pairs = [(p, g) for p, g in params_grads if g is not None]
        self._apply([p for p, _ in pairs], [g for _, g in pairs], self.get_lr(),
                    ratios=False)

    # ------------------------------------------------------------ pure API
    def init_state_arrays(self, params):
        """params: dict name -> tensor. Returns the optimizer state dict."""
        return {name: self._init_state(t) for name, t in params.items()}

    @torch.no_grad()
    def apply_gradients_arrays(self, params, grads, state, lr=None):
        """(new params, new state) over dicts, as the training step updates:
        the clip, then the L1 term and ``_update`` with the optimizer's
        hypers for no parameter."""
        if lr is None:
            lr = self.get_lr()
        if self._grad_clip is not None:
            names = list(grads)
            grads = dict(zip(names, self._grad_clip.clip_arrays([grads[n] for n in names])))
        hypers = self._hypers()
        l1 = self._take_l1(hypers)
        new_params, new_state = {}, {}
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                new_params[name], new_state[name] = p, state[name]
                continue
            lr_t = torch.full((), float(lr), dtype=torch.float32, device=p.device)
            new_params[name], new_state[name] = self._update_one(
                p, g.to(p.dtype), lr_t, state[name], hypers, l1)
        return new_params, new_state

    # ------------------------------------------------------------ state dict
    def _names(self):
        return [getattr(p, "param_name", None) or f"param_{i}"
                for i, p in enumerate(self._params)]

    def state_dict(self):
        d = {"step_count": self._step_count, "accumulators": {}}
        name_of = {id(p): n for p, n in zip(self._params, self._names())}
        for pid, state in self._accumulators.items():
            if pid in name_of:
                d["accumulators"][name_of[pid]] = [t.detach().clone() for t in state]
        if self._lr_scheduler is not None:
            d["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return d

    def set_state_dict(self, state_dict):
        self._step_count = state_dict.get("step_count", 0)
        by_name = dict(zip(self._names(), self._params))
        acc = state_dict.get("accumulators", {})

        def load(p, arrs):
            self._accumulators[id(p)] = tuple(
                torch.as_tensor(a).to(p.device).clone() for a in arrs)

        if acc and not any(n in by_name for n in acc) and len(acc) == len(self._params):
            # saved under other names: the reference maps them by position
            for arrs, p in zip(acc.values(), self._params):
                load(p, arrs)
        else:
            for name, arrs in acc.items():
                if name in by_name:
                    load(by_name[name], arrs)
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])

    load_dict = set_state_dict


class SGD(Optimizer):
    @staticmethod
    def _update(p, g, lr, *, l2=0.0):
        if l2:
            g = g + l2 * p
        return (p - lr.to(p.dtype) * g.to(p.dtype),)


class Momentum(Optimizer):
    """Momentum, Nesterov's with ``use_nesterov``, and LARS (the
    layer-wise trust ratio) with ``use_lars``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None,
                 use_lars=False, lars_coeff=0.001, lars_weight_decay=0.0005):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._use_lars = use_lars
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _hypers(self, param=None):
        h = super()._hypers(param)
        h.update(mu=self._momentum, nesterov=self._use_nesterov,
                 lars=self._use_lars, lars_coeff=self._lars_coeff,
                 lars_wd=self._lars_weight_decay)
        return h

    def _init_state(self, p):
        return (torch.zeros_like(p),)

    @classmethod
    def _elementwise(cls, hypers):
        return not hypers.get("lars")

    @staticmethod
    def _update(p, g, lr, velocity, *, mu=0.9, nesterov=False, l2=0.0, lars=False,
                lars_coeff=0.001, lars_wd=0.0005, sum_sq=None):
        g = g.to(p.dtype)
        lr = lr.to(p.dtype)
        if lars:
            # the lr-scaled step enters the velocity, so past momentum
            # keeps the trust ratio it was accumulated with
            p_sq, g_sq = (sum_sq or local_sum_sq)(p, g)
            p_norm = torch.sqrt(p_sq)
            g_norm = torch.sqrt(g_sq)
            local_lr = torch.where(
                (p_norm > 0) & (g_norm > 0),
                lr * lars_coeff * p_norm / (g_norm + lars_wd * p_norm + 1e-12),
                lr)
            v_new = mu * velocity + local_lr * (g + lars_wd * p)
            return p - v_new, v_new
        if l2:
            g = g + l2 * p
        v_new = mu * velocity + g
        if nesterov:
            p_new = p - lr * (g + mu * v_new)
        else:
            p_new = p - lr * v_new
        return p_new, v_new


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = epsilon

    def _hypers(self, param=None):
        h = super()._hypers(param)
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
    """Adam with decoupled weight decay. ``apply_decay_param_fun(name)``
    false exempts a parameter, in the eager step only (module docstring);
    ``weight_decay`` is a number."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "AdamW lr_ratio: the reference accepts it and never applies it")
        if isinstance(weight_decay, bool) or not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "AdamW takes a number as weight_decay (the reference reads anything "
                f"else as 0.01), got {type(weight_decay).__name__}")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, None,
                         grad_clip, lazy_mode, multi_precision, name)
        self._wd = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _hypers(self, param=None):
        h = super()._hypers(param)
        wd = self._wd
        if (param is not None and self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(getattr(param, "param_name", None))):
            wd = 0.0
        h.update(wd=wd)
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _hypers(self, param=None):
        h = super()._hypers(param)
        h.update(b1=self._beta1, b2=self._beta2, eps=self._epsilon)
        return h

    def _init_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p),
                torch.zeros((), dtype=torch.float32, device=p.device))

    @staticmethod
    def _update(p, g, lr, m, u, t, *, b1=0.9, b2=0.999, eps=1e-8, l2=0.0):
        g = g.to(p.dtype)
        if l2:
            g = g + l2 * p
        t_new = t + 1
        m_new = b1 * m + (1 - b1) * g
        u_new = torch.maximum(b2 * u, torch.abs(g))
        p_new = p - (lr.to(p.dtype) / (1 - b1 ** t_new).to(p.dtype)) * m_new / (u_new + eps)
        return p_new, m_new, u_new, t_new


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _hypers(self, param=None):
        h = super()._hypers(param)
        h.update(eps=self._epsilon)
        return h

    def _init_state(self, p):
        return (torch.full_like(p, self._init_value),)

    @staticmethod
    def _update(p, g, lr, acc, *, eps=1e-6, l2=0.0):
        g = g.to(p.dtype)
        if l2:
            g = g + l2 * p
        acc_new = acc + torch.square(g)
        p_new = p - lr.to(p.dtype) * g / (torch.sqrt(acc_new) + eps)
        return p_new, acc_new


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon, self._rho = epsilon, rho

    def _hypers(self, param=None):
        h = super()._hypers(param)
        h.update(eps=self._epsilon, rho=self._rho)
        return h

    def _init_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))

    @staticmethod
    def _update(p, g, lr, avg_sq_grad, avg_sq_update, *, eps=1e-6, rho=0.95, l2=0.0):
        g = g.to(p.dtype)
        if l2:
            g = g + l2 * p
        avg_sq_grad_new = rho * avg_sq_grad + (1 - rho) * torch.square(g)
        update = g * torch.sqrt(avg_sq_update + eps) / torch.sqrt(avg_sq_grad_new + eps)
        avg_sq_update_new = rho * avg_sq_update + (1 - rho) * torch.square(update)
        return p - lr.to(p.dtype) * update, avg_sq_grad_new, avg_sq_update_new


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _hypers(self, param=None):
        h = super()._hypers(param)
        h.update(rho=self._rho, eps=self._epsilon, mu=self._momentum,
                 centered=self._centered)
        return h

    def _init_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p), torch.zeros_like(p))

    @staticmethod
    def _update(p, g, lr, mean_sq, mean_g, mom, *, rho=0.95, eps=1e-6, mu=0.0,
                centered=False, l2=0.0):
        g = g.to(p.dtype)
        if l2:
            g = g + l2 * p
        mean_sq_new = rho * mean_sq + (1 - rho) * torch.square(g)
        if centered:
            mean_g_new = rho * mean_g + (1 - rho) * g
            denom = torch.sqrt(mean_sq_new - torch.square(mean_g_new) + eps)
        else:
            mean_g_new = mean_g
            denom = torch.sqrt(mean_sq_new + eps)
        mom_new = mu * mom + lr.to(p.dtype) * g / denom
        return p - mom_new, mean_sq_new, mean_g_new, mom_new


class Lamb(Optimizer):
    """``exclude_from_weight_decay_fn(param)`` true exempts a parameter,
    in the eager step only (module docstring)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _hypers(self, param=None):
        h = super()._hypers(param)
        wd = self._lamb_wd
        if param is not None and self._exclude_fn is not None and self._exclude_fn(param):
            wd = 0.0
        h.update(b1=self._beta1, b2=self._beta2, eps=self._epsilon, wd=wd)
        h["l2"] = 0.0
        return h

    @classmethod
    def _elementwise(cls, hypers):
        return False  # the trust ratio's norms

    def _init_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p),
                torch.zeros((), dtype=torch.float32, device=p.device))

    @staticmethod
    def _update(p, g, lr, m, v, t, *, b1=0.9, b2=0.999, eps=1e-6, wd=0.01, l2=0.0,
                sum_sq=None):
        g = g.to(p.dtype)
        t_new = t + 1
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / (1 - b1 ** t_new).to(p.dtype)
        vhat = v_new / (1 - b2 ** t_new).to(p.dtype)
        r = mhat / (torch.sqrt(vhat) + eps) + wd * p
        p_sq, r_sq = (sum_sq or local_sum_sq)(p, r)
        p_norm = torch.sqrt(p_sq)
        r_norm = torch.sqrt(r_sq)
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
        return p - lr.to(p.dtype) * trust * r, m_new, v_new, t_new


class Lars(Momentum):
    """Momentum with the layer-adaptive trust ratio always on; it decays
    through ``lars_weight_decay`` (inside the trust ratio) and refuses a
    separate ``weight_decay``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 lars_coeff=0.001, lars_weight_decay=0.0005, weight_decay=None,
                 grad_clip=None, name=None, **kwargs):
        if weight_decay is not None:
            raise ValueError(
                "Lars regularizes via lars_weight_decay (it enters the trust "
                "ratio); a separate weight_decay would be silently ignored")
        super().__init__(learning_rate, momentum, parameters=parameters,
                         grad_clip=grad_clip, name=name, use_lars=True,
                         lars_coeff=lars_coeff, lars_weight_decay=lars_weight_decay,
                         **kwargs)


LarsMomentum = Lars


class Ftrl(Optimizer):
    """FTRL-proximal; states: the squared and the linear accumulators. Its
    ``l1``/``l2`` are its own, apart from ``weight_decay``."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._l1 = l1
        self._ftrl_l2 = l2
        self._lr_power = lr_power

    def _hypers(self, param=None):
        h = super()._hypers(param)
        h.update(l1=self._l1, ftrl_l2=self._ftrl_l2, lr_power=self._lr_power)
        return h

    def _init_state(self, p):
        return (torch.full_like(p, 1e-10), torch.zeros_like(p))

    @staticmethod
    def _update(p, g, lr, sq_accum, lin_accum, *, l1=0.0, ftrl_l2=0.0,
                lr_power=-0.5, l2=0.0):
        g = g.to(p.dtype)
        if l2:
            g = g + l2 * p
        lr = lr.to(p.dtype)
        new_sq = sq_accum + torch.square(g)
        # sigma = (new_sq^{-lr_power} - sq^{-lr_power}) / lr
        sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq_accum, -lr_power)) / lr
        new_lin = lin_accum + g - sigma * p
        x = l1 * torch.sign(new_lin) - new_lin
        y = torch.pow(new_sq, -lr_power) / lr + 2.0 * ftrl_l2
        p_new = torch.where(torch.abs(new_lin) > l1, x / y, torch.zeros_like(p))
        return p_new, new_sq, new_lin


class DecayedAdagrad(Optimizer):
    """Adagrad over an exponentially decayed squared-gradient accumulator."""

    def __init__(self, learning_rate=0.001, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._decay = decay
        self._epsilon = epsilon

    def _hypers(self, param=None):
        h = super()._hypers(param)
        h.update(decay=self._decay, eps=self._epsilon)
        return h

    def _init_state(self, p):
        return (torch.zeros_like(p),)

    @staticmethod
    def _update(p, g, lr, acc, *, decay=0.95, eps=1e-6, l2=0.0):
        g = g.to(p.dtype)
        if l2:
            g = g + l2 * p
        acc_new = decay * acc + (1 - decay) * torch.square(g)
        p_new = p - lr.to(p.dtype) * g / (torch.sqrt(acc_new) + eps)
        return p_new, acc_new
