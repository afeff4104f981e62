"""Model, the Keras-like training facade (counterpart of
paddle_tpu/hapi/model.py; Paddle's hapi/model.py Model, its
DynamicGraphAdapter): ``prepare``, ``train_batch`` / ``eval_batch`` /
``predict_batch``, ``fit`` (``save_dir`` snapshots each epoch, a SIGTERM
stops it at the batch boundary with a resume marker, ``resume=True``
restarts from the last completed epoch), ``evaluate``, ``predict``,
``save``, ``load`` and ``summary``. The step is the eager one (dygraph):
the network's forward on Tensors, ``loss.backward()``,
``optimizer.step()``.

Inputs and labels become Tensors on the current place (the card unless
``set_device`` said otherwise); a DataLoader's batches already are.
Knobs the reference accepts and never reads raise at a value other than
their default: ``prepare(amp_configs)``, ``fit(accumulate_grad_batches)``,
``load(skip_mismatch)`` and the ``callbacks`` of ``evaluate`` and
``predict``.
"""
import os

import numpy as np
import torch

from ..core import place as place_mod
from ..core.dispatch import no_grad
from ..core.errors import reject_unread
from ..core.tensor import to_tensor, wrap
from ..io import DataLoader
from . import callbacks as callbacks_mod


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs if inputs is None or isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        reject_unread("Model.prepare", amp_configs=(amp_configs, None))
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        return self

    # ------------------------------------------------------------ one batch
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is None or isinstance(labels, (list, tuple)) \
            else [labels]
        outputs = self.network(*[_to_tensor(i) for i in inputs])
        losses = self._compute_loss(outputs, labels)
        losses.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        return ([float(losses.numpy())], metrics) if metrics else [float(losses.numpy())]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is None or isinstance(labels, (list, tuple)) \
            else [labels]
        with no_grad():
            outputs = self.network(*[_to_tensor(i) for i in inputs])
            losses = self._compute_loss(outputs, labels)
        metrics = self._update_metrics(outputs, labels)
        return ([float(losses.numpy())], metrics) if metrics else [float(losses.numpy())]

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        with no_grad():
            outputs = self.network(*[_to_tensor(i) for i in inputs])
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        return [o.numpy() for o in outs]

    def _compute_loss(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        lbls = [_to_tensor(l) for l in (labels or [])]
        if self._loss is None:
            return outs[0]
        return self._loss(*outs, *lbls)

    def _update_metrics(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        lbls = [_to_tensor(l) for l in (labels or [])]
        res = []
        for m in self._metrics:
            computed = m.compute(*outs, *lbls)
            if not isinstance(computed, (list, tuple)):
                computed = [computed]
            r = m.update(*computed)
            res.append(r)
        return res

    # ------------------------------------------------------------ loops
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, resume=False):
        """Train. With ``save_dir`` the loop is preemption-safe: each
        epoch end atomically writes a ``resume`` snapshot +
        ``fit_state.json``, SIGTERM/SIGINT (resilience.preemption) stops
        at the next batch boundary leaving a resumable marker, and
        ``resume=True`` restarts from the last completed epoch —
        interrupted epochs replay from their boundary snapshot, so a
        resumed run matches an uninterrupted one wherever the per-epoch
        data order is deterministic."""
        from ..resilience import chaos, preemption
        from ..resilience.checkpoint import atomic_write_json

        reject_unread("Model.fit", accumulate_grad_batches=(accumulate_grad_batches, 1))
        train_loader = _as_loader(train_data, batch_size, shuffle, drop_last,
                                  num_workers)
        eval_loader = _as_loader(eval_data, batch_size, False, False, num_workers) \
            if eval_data is not None else None
        cbks = callbacks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=_safe_len(train_loader),
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose, metrics=self._metrics_names())
        self.stop_training = False  # a prior preempted/early-stopped fit
        # must not make this one a no-op
        start_epoch = 0
        handler = None
        uninstall_after = False
        if save_dir:
            if resume:
                start_epoch = self._load_fit_state(save_dir)
                preemption.clear_resume_marker(save_dir)
            # SIGTERM only — the cluster's preemption signal; SIGINT
            # keeps raising KeyboardInterrupt for interactive users
            import signal as signal_mod

            handler = preemption.get_preemption_handler()
            uninstall_after = not handler._installed
            handler.install(signals=(signal_mod.SIGTERM,))
            if resume:
                # this fit IS the post-preemption restart; a still-set
                # flag would re-preempt it on the first batch
                handler.clear()
        cbks.on_begin("train")
        preempted_run = False
        try:
            for epoch in range(start_epoch, epochs):
                if self.stop_training:
                    break
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                preempted = False
                for step, batch in enumerate(train_loader):
                    if num_iters is not None and step >= num_iters:
                        break
                    chaos.hit("train.step")
                    cbks.on_batch_begin("train", step, logs)
                    ins, lbls = _split_batch(batch)
                    result = self.train_batch(ins, lbls)
                    logs = self._make_logs(result, step)
                    cbks.on_batch_end("train", step, logs)
                    if handler is not None and handler.requested:
                        # exit at the batch boundary: the last epoch-end
                        # snapshot is the resume point (replaying the
                        # interrupted epoch keeps resume bit-identical
                        # to an uninterrupted run)
                        preempted = True
                        break
                if preempted:
                    preemption.write_resume_marker(save_dir, step=epoch)
                    self.stop_training = True
                    preempted_run = True
                    # the request is now fully handled (marker on disk);
                    # leaving the flag set would instantly "re-preempt"
                    # any later fit in a script that goes on
                    handler.clear()
                    break
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self._run_eval(eval_loader)
                    logs.update({f"val_{k}": v
                                 for k, v in eval_logs.items()})
                cbks.on_epoch_end(epoch, logs)
                if save_dir:
                    # epoch snapshot, THEN fit_state referencing it:
                    # fit_state (written last, atomically) can only ever
                    # name a complete params+opt pair, so a crash
                    # between any of these writes resumes from the
                    # previous consistent snapshot instead of mixing
                    # epoch-N weights with a next_epoch=N replay. When
                    # the numbered save already ran this epoch, reuse it
                    # rather than writing the same state twice.
                    if (epoch + 1) % save_freq == 0:
                        snap = str(epoch)
                        self.save(f"{save_dir}/{snap}")
                    else:
                        snap = f"resume-{epoch}"
                        self.save(f"{save_dir}/{snap}")
                    atomic_write_json(f"{save_dir}/fit_state.json",
                                      {"next_epoch": epoch + 1,
                                       "snapshot": snap})
                    self._gc_resume_snapshots(save_dir, keep=snap)
                if handler is not None and handler.requested:
                    # signal landed during eval/epoch-end/saves: the
                    # epoch snapshot above is the resume point — honor
                    # the request here instead of silently finishing
                    preemption.write_resume_marker(save_dir, step=epoch)
                    self.stop_training = True
                    preempted_run = True
                    handler.clear()
                    break
        finally:
            if handler is not None and uninstall_after:
                # restore default signal disposition: a SIGTERM after
                # fit returns must terminate the process, not set a
                # dead flag — and a flag fit never consumed must not
                # leak into a later fit as a bogus instant preemption
                handler.clear()
                handler.uninstall()
        cbks.on_end("train")
        if save_dir and not preempted_run:
            self.save(f"{save_dir}/final")

    def _load_fit_state(self, save_dir):
        """-> epoch to resume from; loads the snapshot fit_state.json
        names (fit_state is written last, so the pair it references is
        always complete)."""
        import json

        try:
            with open(f"{save_dir}/fit_state.json") as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return 0
        next_epoch = int(state.get("next_epoch", 0))
        snap = state.get("snapshot", "resume")
        if next_epoch > 0 and os.path.exists(f"{save_dir}/{snap}.pdparams"):
            self.load(f"{save_dir}/{snap}")
        return next_epoch

    @staticmethod
    def _gc_resume_snapshots(save_dir, keep):
        for fn in os.listdir(save_dir):
            stem = fn.rsplit(".", 1)[0]
            if stem.startswith("resume") and stem != keep:
                try:
                    os.remove(os.path.join(save_dir, fn))
                except OSError:
                    pass

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        reject_unread("Model.evaluate", callbacks=(callbacks, None))
        loader = _as_loader(eval_data, batch_size, False, False, num_workers)
        logs = self._run_eval(loader, num_iters)
        return logs

    def _run_eval(self, loader, num_iters=None):
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            ins, lbls = _split_batch(batch)
            result = self.eval_batch(ins, lbls)
            loss = result[0] if isinstance(result, tuple) else result
            losses.append(loss[0])
        logs = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            logs.update(dict(zip(names, vals)))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        reject_unread("Model.predict", callbacks=(callbacks, None))
        loader = _as_loader(test_data, batch_size, False, False, num_workers)
        outputs = []
        for batch in loader:
            if self._inputs is not None and isinstance(batch, (list, tuple)):
                # Model(inputs=...) spec decides the input arity (paddle way)
                ins = list(batch[:len(self._inputs)])
            else:
                # no inputs spec: fit-style datasets yield (inputs..., label)
                # — drop the trailing element like fit/evaluate do. For
                # unlabeled multi-input data pass Model(inputs=[...]) so the
                # spec decides arity instead of this heuristic.
                ins, _ = _split_batch(batch, has_labels=True)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs]) for i in range(n_out)]
        return outputs

    def _make_logs(self, result, step):
        logs = {}
        if isinstance(result, tuple):
            losses, metrics = result
        else:
            losses, metrics = result, []
        logs["loss"] = losses[0]
        for m, r in zip(self._metrics, metrics):
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = r if isinstance(r, (list, tuple)) else [r]
            logs.update(dict(zip(names, vals)))
        logs["step"] = step
        return logs

    def _metrics_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    # ------------------------------------------------------------ io
    def save(self, path, training=True):
        from .. import framework

        framework.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            framework.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from .. import framework

        reject_unread("Model.load", skip_mismatch=(skip_mismatch, False))
        state = framework.load(path + ".pdparams")
        self.network.set_state_dict(state)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(framework.load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary

        return summary(self.network, input_size, dtypes=dtype)


def _to_tensor(x):
    """``x`` as a Tensor on the current place (a tensor already there is
    taken as it is)."""
    if isinstance(x, torch.Tensor) and x.device == place_mod.current_device():
        return wrap(x)
    return to_tensor(x)


def _split_batch(batch, has_labels=True):
    if isinstance(batch, (list, tuple)):
        if has_labels and len(batch) >= 2:
            return list(batch[:-1]), [batch[-1]]
        return list(batch), None
    return [batch], None


def _as_loader(data, batch_size, shuffle, drop_last, num_workers):
    if data is None or isinstance(data, DataLoader):
        return data
    return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                      drop_last=drop_last, num_workers=num_workers)


def _safe_len(loader):
    try:
        return len(loader)
    except TypeError:
        return None
