"""Dynamic loss scaling (counterpart of paddle_tpu/amp/grad_scaler.py:
``AmpScaler`` and ``GradScaler``).

float16 keeps 10 mantissa bits but overflows past 65504 and flushes below
6e-8, so an fp16 backward of an unscaled loss loses its small gradients.
The scaler multiplies the loss by ``scale`` before ``backward()``, divides
every gradient by it again (``unscale_``: ``g * (1 / scale)`` in the
gradient's dtype, as the reference), and skips the optimizer's step when
any gradient came back non-finite. ``update()`` is the reference's state
machine: after ``decr_every_n_nan_or_inf`` bad steps the scale is
multiplied by ``decr_ratio`` (never below 1.0); after
``incr_every_n_steps`` good steps in a row by ``incr_ratio``.

The gradients are the parameters' ``.grad``. Where the reference reads
one flag back from the device for every parameter, ``unscale_`` gathers
the non-finite flags on the device and reads them back once a step; the
scale, the counters and the gradients' bits are the reference's.

``attach_bad_step_monitor(monitor)`` feeds every step's skip (True) or
update (False) into a ``resilience.BadStepMonitor``: the scaler keeps
re-scaling, and a run of consecutive skips reaches the monitor's
rollback threshold.
"""
import numpy as np
import torch


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=1000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._bad_step_monitor = None

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale in place and record whether
        any is non-finite (one read from the device)."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._params:
            if p.grad is None:
                continue
            p.grad.mul_(inv)
            flags.append(torch.isfinite(p.grad).all())
        self._found_inf = bool(flags) and not bool(torch.stack(
            [f.to(flags[0].device) for f in flags]).all())

    minimize_unscale = unscale_

    def attach_bad_step_monitor(self, monitor):
        """Feed this scaler's skips into ``monitor`` (a
        ``resilience.BadStepMonitor``); returns the monitor."""
        self._bad_step_monitor = monitor
        return monitor

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            if self._bad_step_monitor is not None:
                self._bad_step_monitor.record(False)
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        if self._bad_step_monitor is not None:
            self._bad_step_monitor.record(self._found_inf)
        self.update()

    def minimize(self, optimizer, loss, **kwargs):
        loss.backward()
        self.step(optimizer)
        return [], []

    def update(self):
        if not (self._enable and self._use_dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def get_loss_scaling(self):
        """The scale as a float32 Tensor of one element on the current place."""
        from ..core.tensor import to_tensor

        return to_tensor(np.asarray([self._scale], np.float32))

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d["scale"]
        self._good_steps = d["good_steps"]
        self._bad_steps = d["bad_steps"]


class GradScaler(AmpScaler):
    pass
