"""Auto-checkpoint (counterpart of paddle_tpu/incubate/checkpoint.py):
epoch-granular snapshots of a training run for resume after a stop.

``for epoch in auto_checkpoint.train_epoch_range(N, save_dir=...,
model=..., optimizer=...)`` yields the epochs not finished yet and, after
each, saves the model's and the optimizer's state dicts (``ckpt.pdparams``,
``ckpt.pdopt``, through the port's atomic ``framework.save``) and
``meta.json`` (``{"next_epoch": e + 1, "ts": ...}``), the previous good
meta kept as ``meta.json.bak``. A new range reads meta.json, falls back to
the backup where it is unreadable, and starts afresh where neither is.
SIGTERM during an epoch is honoured at its end: the epoch's snapshot is
saved, a resume marker written, and ``PreemptedExit`` (exit status 143)
raised. The layout is the reference's, so either package resumes the
other's run. ``save_dir`` defaults to ``paddle_tpu_torch_autockpt/<name>``
under the temporary directory; the port reads no environment.
"""
import json
import os
import signal
import tempfile
import time
import warnings

from ..resilience import chaos, preemption
from ..resilience.checkpoint import atomic_write_bytes, atomic_write_json


def _load_meta(meta_path):
    """meta.json as a dict, else meta.json.bak's; None where neither is
    usable (a fresh start)."""
    for path in (meta_path, meta_path + ".bak"):
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            continue
        except (OSError, json.JSONDecodeError, ValueError) as e:
            warnings.warn(f"auto_checkpoint: {path} unreadable ({e}); falling back to the "
                          "last good snapshot")
    return None


class TrainEpochRange:
    """The epochs from the last finished one recorded in ``save_dir`` up
    to ``max_epoch_num``, with a snapshot after each (module docstring)."""

    def __init__(self, max_epoch_num, name="default", save_dir=None, checkpoint_inter=None,
                 model=None, optimizer=None):
        self.max_epoch_num = max_epoch_num
        self.name = name
        self.save_dir = save_dir or os.path.join(tempfile.gettempdir(),
                                                 "paddle_tpu_torch_autockpt", name)
        self._model = model
        self._optimizer = optimizer
        self._meta_path = os.path.join(self.save_dir, "meta.json")
        self._start = 0
        meta = _load_meta(self._meta_path)
        if meta is not None:
            self._start = int(meta.get("next_epoch", 0))
            ckpt = os.path.join(self.save_dir, "ckpt")
            if self._model is not None and os.path.exists(ckpt + ".pdparams"):
                from .. import framework

                self._model.set_state_dict(framework.load(ckpt + ".pdparams"))
                if self._optimizer is not None and os.path.exists(ckpt + ".pdopt"):
                    self._optimizer.set_state_dict(framework.load(ckpt + ".pdopt"))
        # a marker left by the stopped run means this range is its resume:
        # consume it, so that a clean finish leaves none
        if preemption.read_resume_marker(self.save_dir) is not None:
            preemption.clear_resume_marker(self.save_dir)

    def __iter__(self):
        # SIGTERM only (a scheduler's stop); SIGINT stays a KeyboardInterrupt
        handler = preemption.get_preemption_handler()
        uninstall_after = not handler._installed
        handler.install(signals=(signal.SIGTERM,))
        try:
            for epoch in range(self._start, self.max_epoch_num):
                chaos.hit("train.epoch")
                yield epoch
                self._save(epoch)
                if handler.requested:
                    preemption.write_resume_marker(self.save_dir, step=epoch + 1,
                                                   extra={"name": self.name})
                    handler.clear()  # handled: a caller that catches the exit must not loop
                    raise preemption.PreemptedExit(step=epoch + 1)
        finally:
            if uninstall_after:
                handler.uninstall()

    def _save(self, epoch):
        os.makedirs(self.save_dir, exist_ok=True)
        chaos.hit("autockpt.save")
        ckpt = os.path.join(self.save_dir, "ckpt")
        if self._model is not None:
            from .. import framework

            framework.save(self._model.state_dict(), ckpt + ".pdparams")
            if self._optimizer is not None:
                framework.save(self._optimizer.state_dict(), ckpt + ".pdopt")
        # keep the previous good meta as .bak before the new one is
        # published: both writes are atomic, so every crash point leaves a
        # readable meta
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path, "rb") as f:
                    old = f.read()
                json.loads(old)
                atomic_write_bytes(self._meta_path + ".bak", old)
            except (OSError, json.JSONDecodeError, ValueError):
                pass
        atomic_write_json(self._meta_path, {"next_epoch": epoch + 1, "ts": time.time()})


class auto_checkpoint:
    train_epoch_range = TrainEpochRange
