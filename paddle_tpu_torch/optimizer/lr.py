"""Learning-rate schedulers (counterpart of paddle_tpu/optimizer/lr.py:1-301,
the reference's thirteen schedulers).

A scheduler is host-side state: a float per step, as in the reference.
The optimizer reads ``scheduler()`` as its rate; the training step
(distributed/spmd.py) receives that rate as a float32 scalar tensor, so a
new rate never changes what the step computes on the card besides that
one number. The constructor calls ``step()`` once (``last_epoch`` -1 ->
0). ``state_dict`` keeps every plain attribute; ``LambdaDecay`` leaves
its function out.
"""
import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list, tuple, dict))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    """base_lr * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5), the
    schedule of "Attention Is All You Need" §5.3 (step 0 counts as 1)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * (self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / float(self.decay_steps)) if step > 0 else 1
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, self.decay_steps)
        return (self.base_lr - self.end_lr) * (
            (1 - float(step) / float(decay_steps)) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    """A linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate``: a float, or a scheduler stepped to
    ``last_epoch - warmup_steps``."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1,
                 verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = learning_rate if not self.lr_sched else self.lr_sched.base_lr
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / max(
                self.warmup_steps, 1) + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched()
        return self.base_lr


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        d = super().state_dict()
        d.pop("lr_lambda", None)
        return d


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        cur = self.base_lr
        for e in range(1, self.last_epoch + 1):
            cur *= self.lr_lambda(e)
        return cur


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class ReduceOnPlateau(LRScheduler):
    """Multiplies the rate by ``factor`` once ``patience`` steps in a row
    have not improved the metric given to ``step(metrics)`` (a float or a
    one-element tensor, read on the host); ``step()`` without a metric does
    nothing. Its constructor takes no ``last_epoch`` and calls no step."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        current = float(metrics.item()) if hasattr(metrics, "item") else float(metrics)
        self.last_epoch += 1
        if self.best is None:
            self.best = current
            return
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
                if self.verbose:
                    print(f"ReduceOnPlateau: lr -> {new_lr}")
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def _is_better(self, a, best):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1 + self.threshold)
        return a > best + self.threshold


class OneCycleLR(LRScheduler):
    """Cosine up from max / divide_factor to the max over ``phase_pct`` of
    ``total_steps``, then cosine down to ``end_learning_rate``. The
    reference accepts ``anneal_strategy`` and ``three_phase`` and never
    reads them (its schedule is always these two cosine phases); here any
    other value than the default raises."""

    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        if anneal_strategy != "cos" or three_phase:
            raise NotImplementedError("OneCycleLR: the reference runs two cosine phases "
                                      "whatever anneal_strategy and three_phase say")
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        up = int(self.phase_pct * self.total_steps)
        if step <= up:
            pct = step / max(up, 1)
            return self.initial_lr + (self.max_lr - self.initial_lr) * (
                1 - math.cos(math.pi * pct)) / 2
        pct = (step - up) / max(self.total_steps - up, 1)
        return self.end_lr + (self.max_lr - self.end_lr) * (
            1 + math.cos(math.pi * min(pct, 1.0))) / 2


class CyclicLR(LRScheduler):
    """Triangular cycles between ``base_learning_rate`` and
    ``max_learning_rate``; ``triangular2`` halves the amplitude each cycle,
    ``exp_range`` scales it by exp_gamma^step. The reference accepts
    ``scale_fn`` and ``scale_mode`` and never reads them; here a
    ``scale_fn`` or another ``scale_mode`` raises."""

    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1, verbose=False):
        if scale_fn is not None or scale_mode != "cycle":
            raise NotImplementedError("CyclicLR: the reference never applies scale_fn "
                                      "or scale_mode")
        self.max_lr = max_learning_rate
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        if x <= self.step_size_up:
            pct = x / self.step_size_up
        else:
            pct = 1 - (x - self.step_size_up) / self.step_size_down
        amp = (self.max_lr - self.base_lr) * pct
        if self.mode == "triangular2":
            amp /= (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp *= (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp
