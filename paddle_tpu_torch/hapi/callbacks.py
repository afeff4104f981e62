"""Callbacks of the high-level API (counterpart of paddle_tpu/hapi/callbacks.py):
``Callback``, ``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping``,
``LRScheduler``, ``VisualDL`` (scalars as JSON lines, one file per mode),
``ReduceLROnPlateau``, ``CallbackList`` and ``config_callbacks``."""
import time


def _auto_mode(monitor):
    """'auto' monitor-mode heuristic (reference: callbacks.py EarlyStopping
    /ReduceLROnPlateau): accuracy-like metrics maximize, losses minimize."""
    return "max" if any(s in monitor.lower()
                        for s in ("acc", "auc", "f1", "precision",
                                  "recall")) else "min"


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                     for k, v in (logs or {}).items()]
            print(f"Epoch {self.epoch} step {step} - " + ", ".join(items))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self.t0
            items = [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                     for k, v in (logs or {}).items()]
            print(f"Epoch {epoch} done in {dt:.1f}s - " + ", ".join(items))


class ModelCheckpoint(Callback):
    """Epoch checkpoints (atomic — framework.save stages + renames).

    save_best_only=True keeps one "best" checkpoint judged by `monitor`
    (an epoch-end log key, e.g. "loss" or "val_acc"; mode "auto"
    resolves min/max like EarlyStopping) — long runs keep the best eval
    snapshot instead of only the last epoch."""

    def __init__(self, save_freq=1, save_dir=None, save_best_only=False,
                 monitor="loss", mode="auto", verbose=0):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.save_best_only = save_best_only
        self.monitor = monitor
        self.verbose = verbose
        self.mode = _auto_mode(monitor) if mode == "auto" else (
            "max" if mode == "max" else "min")
        self.best = None
        self.best_epoch = None

    def _is_better(self, value):
        if self.best is None:
            return True
        return value > self.best if self.mode == "max" else value < self.best

    def on_epoch_end(self, epoch, logs=None):
        if not self.save_dir:
            return
        if self.save_best_only:
            value = (logs or {}).get(self.monitor)
            if value is None or not self._is_better(float(value)):
                return
            self.best = float(value)
            self.best_epoch = epoch
            self.model.save(f"{self.save_dir}/best")
            from ..resilience.checkpoint import atomic_write_json

            atomic_write_json(f"{self.save_dir}/best.json",
                              {"epoch": epoch, "monitor": self.monitor,
                               "value": self.best, "mode": self.mode})
            if self.verbose:
                print(f"Epoch {epoch}: {self.monitor} improved to "
                      f"{self.best:.6f}, saving best model")
        elif (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.mode = _auto_mode(monitor) if mode == "auto" else (
            "max" if mode == "max" else "min")

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        better = (self.best is None or
                  (self.mode == "min" and value < self.best - self.min_delta) or
                  (self.mode == "max" and value > self.best + self.min_delta))
        if better:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return opt._lr_scheduler if opt is not None else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class VisualDL(Callback):
    """Scalar logger. Paddle's writes VisualDL event files; as in the
    reference, the scalars are appended as JSON lines under ``log_dir``,
    one file per mode (``train.jsonl``, ``eval.jsonl``, ``epoch.jsonl``)."""

    def __init__(self, log_dir):
        super().__init__()
        import os

        self.log_dir = log_dir
        self._step = {}
        self._files = {}
        os.makedirs(log_dir, exist_ok=True)

    def _write(self, mode, payload):
        import json
        import os

        f = self._files.get(mode)
        if f is None:
            f = self._files[mode] = open(
                os.path.join(self.log_dir, f"{mode}.jsonl"), "a")
        f.write(json.dumps(payload) + "\n")
        f.flush()

    def on_end(self, mode, logs=None):
        for f in self._files.values():
            f.close()
        self._files.clear()

    def _log(self, mode, step, logs):
        import numbers

        # Real (not complex — float() would raise) covers python ints/
        # floats AND numpy scalar metrics like np.float32
        scalars = {k: float(v) for k, v in (logs or {}).items()
                   if isinstance(v, numbers.Real) and k != "step"}
        if scalars:
            self._write(mode, {**scalars, "step": step})

    def on_train_batch_end(self, step, logs=None):
        self._step["train"] = self._step.get("train", -1) + 1
        self._log("train", self._step["train"], logs)

    def on_eval_batch_end(self, step, logs=None):
        self._step["eval"] = self._step.get("eval", -1) + 1
        self._log("eval", self._step["eval"], logs)

    def on_epoch_end(self, epoch, logs=None):
        self._log("epoch", epoch, logs)


class ReduceLROnPlateau(Callback):
    """Scale the LR down when the monitored metric plateaus (reference:
    hapi/callbacks.py:953)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        if factor >= 1.0:
            raise ValueError("factor must be < 1.0")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.mode = _auto_mode(monitor) if mode == "auto" else (
            "max" if mode == "max" else "min")
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        better = (self.best is None or
                  (self.mode == "min" and
                   value < self.best - self.min_delta) or
                  (self.mode == "max" and
                   value > self.best + self.min_delta))
        if better:
            self.best = value
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    old = float(opt.get_lr())
                    new = max(old * self.factor, self.min_lr)
                    if old - new > 1e-12:
                        opt.set_lr(new)
                        if self.verbose:
                            print(f"Epoch {epoch}: ReduceLROnPlateau "
                                  f"reducing learning rate to {new}.")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __iter__(self):
        return iter(self.callbacks)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_begin", step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_end", step, logs)


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    cbk_list = CallbackList(cbks)
    for c in cbks:
        c.set_model(model)
        c.set_params({"batch_size": batch_size, "epochs": epochs, "steps": steps,
                      "verbose": verbose, "metrics": metrics or []})
    return cbk_list
