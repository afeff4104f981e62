"""Predictor — the AnalysisPredictor analog (counterpart of
paddle_tpu/inference/predictor.py; reference: paddle/fluid/inference/api/
analysis_predictor.cc: Init -> load program -> Run / ZeroCopyRun:860;
handle API paddle_api.h ZeroCopyTensor).

"Load program" is ``jit.load`` of a ``paddle.jit.save`` program
(torch.export) onto the predictor's device; "ZeroCopyRun": inputs are on
the device from ``copy_from_cpu`` to ``run``, outputs stay there until
``copy_to_cpu``. ``run`` goes through the loaded layer, which runs the
program in slabs of one row count (jit/save_load.py), or through the
dynamic-batching engine attached to it, whose batches run the same slabs:
a request's rows come back with their direct call's bits either way.
"""
import threading
import warnings

import numpy as np
import torch

from .config import Config

# Engine attach/detach is rare (once per process, not per request) but
# clones are explicitly multithreaded: one process-wide lock keeps two
# threads from each building + warming an engine and leaking the loser.
_ENGINE_ATTACH_LOCK = threading.Lock()


class Tensor:
    """Input/output handle (reference: ZeroCopyTensor, paddle_api.h)."""

    def __init__(self, name, role, predictor):
        self._name = name
        self._role = role  # "input" | "output"
        self._pred = predictor
        self._shape = None

    def name(self):
        return self._name

    def reshape(self, shape):
        self._shape = tuple(int(s) for s in shape)

    def copy_from_cpu(self, arr):
        if self._role != "input":
            raise RuntimeError(f"{self._name} is an output handle")
        arr = np.asarray(arr)
        if self._shape is not None:
            arr = arr.reshape(self._shape)
        if self._pred.batching_engine() is not None:
            # the engine pads and concatenates requests on the host and
            # uploads the coalesced batch itself
            self._pred._inputs[self._name] = arr
            return
        # device upload happens here, once — run() consumes the resident copy
        self._pred._inputs[self._name] = torch.from_numpy(
            np.ascontiguousarray(arr)).to(self._pred._device)

    def share_external_data(self, arr):
        """Adopt a tensor (or numpy array) without a copy where it already
        lies on the device."""
        if self._role != "input":
            raise RuntimeError(f"{self._name} is an output handle")
        self._pred._inputs[self._name] = (
            arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr)))

    def copy_to_cpu(self):
        if self._role != "output":
            raise RuntimeError(f"{self._name} is an input handle")
        out = self._pred._outputs.get(self._name)
        if out is None:
            raise RuntimeError("run() has not produced outputs yet")
        return _host(out)

    def shape(self):
        src = (self._pred._inputs if self._role == "input"
               else self._pred._outputs)
        a = src.get(self._name)
        if a is not None:
            return list(a.shape)
        return list(self._shape) if self._shape else []

    def type(self):
        src = (self._pred._inputs if self._role == "input"
               else self._pred._outputs)
        a = src.get(self._name)
        if a is None:
            return "unknown"
        return str(a.dtype).replace("torch.", "")


class Predictor:
    """reference: AnalysisPredictor. Load once, run many; clone() shares the
    loaded module + weights and gets its own input/output slots (the
    reference's thread-sharing pattern, analysis_predictor.cc Clone)."""

    def __init__(self, config, _shared=None):
        self._config = config
        if _shared is not None:
            (self._layer, self._in_names, self._out_names, self._device) = _shared
        else:
            from ..jit import load as jit_load

            prefix = config.model_prefix()
            self._device = self._pick_device()
            # weights and program go to the chosen device once; run() then
            # never moves the parameter set (ZeroCopyRun property)
            self._layer = jit_load(prefix, device=self._device,
                                   slab_rows=config.slab_rows())
            self._in_names = [f"x{i}"
                              for i in range(len(self._layer._input_specs))]
            self._out_names = None  # discovered at first run
        self._inputs = {}
        self._outputs = {}

    # ----------------------------------------------------------- internals
    def _pick_device(self):
        """The card the config names, or the CPU where it asked for it
        (``disable_gpu``); without a card that raises."""
        if not self._config.use_gpu():
            return torch.device("cpu")
        from ..core.place import resolve_device

        return resolve_device(f"gpu:{self._config.gpu_device_id()}")

    # Precision is a save-time property: a serialized program has fixed
    # input dtypes; bf16/int8 serving comes from jit.save(quant=...). The
    # Config knob is kept as a record.

    # ----------------------------------------------------------- handle API
    def get_input_names(self):
        return list(self._in_names)

    def get_output_names(self):
        if self._out_names is None:
            return []
        return list(self._out_names)

    def get_input_handle(self, name):
        if name not in self._in_names:
            raise KeyError(f"unknown input {name!r}; inputs: {self._in_names}")
        return Tensor(name, "input", self)

    def get_input_tensor(self, name):  # 1.x spelling
        return self.get_input_handle(name)

    def get_output_handle(self, name):
        if self._out_names is not None and name not in self._out_names:
            raise KeyError(
                f"unknown output {name!r}; outputs: {self._out_names}")
        return Tensor(name, "output", self)

    def get_output_tensor(self, name):
        return self.get_output_handle(name)

    # ----------------------------------------------------------- batching
    def enable_dynamic_batching(self, engine=None, max_batch_size=None,
                                max_wait_ms=None, max_queue=None,
                                warmup=True, warmup_buckets=None):
        """Route this predictor's run() through a shared dynamic-batching
        engine (inference/batching.py). The engine lives on the loaded
        layer, which clone() shares — so every clone coalesces into ONE
        scheduler instead of racing separate dispatches. Knob defaults
        come from the Config (enable_dynamic_batching /
        enable_tensorrt_engine(max_batch_size=...)). Returns the engine.
        """
        from .batching import BatchingEngine

        prev = prev_owned = None
        with _ENGINE_ATTACH_LOCK:
            if engine is not None:
                # caller-owned engine (possibly shared with a server):
                # attach only — disable_dynamic_batching will detach
                # without closing it. An engine WE built earlier must be
                # closed now or its scheduler thread + compiled programs
                # leak with no handle left to close them.
                prev = getattr(self._layer, "_batch_engine", None)
                prev_owned = getattr(self._layer, "_batch_engine_owned",
                                     False)
                self._layer._batch_engine = engine
                self._layer._batch_engine_owned = False
        if engine is not None:
            if prev is not None and prev is not engine and prev_owned:
                prev.close()
            return engine
        with _ENGINE_ATTACH_LOCK:
            engine = getattr(self._layer, "_batch_engine", None)
            if engine is not None:
                if any(k is not None for k in (max_batch_size, max_wait_ms,
                                               max_queue)):
                    warnings.warn(
                        "enable_dynamic_batching: an engine is already "
                        "attached to this (shared) layer; the knobs passed "
                        "here are ignored. Call disable_dynamic_batching() "
                        "first to rebuild with new settings.",
                        RuntimeWarning, stacklevel=2)
                return engine
            db = self._config.dynamic_batching_config()
            kw = dict(
                # Config.max_batch_size() already encodes the
                # dynamic_batching > tensorrt > 1 precedence
                max_batch_size=(max_batch_size
                                or max(self._config.max_batch_size(), 1)),
                max_wait_ms=(max_wait_ms if max_wait_ms is not None
                             else db.get("max_wait_ms", 2.0)),
                max_queue=(max_queue if max_queue is not None
                           else db.get("max_queue", 256)),
            )
            # robustness knobs recorded on the Config (breaker /
            # watchdog); absent keys take the engine's defaults
            for k in ("breaker_threshold", "breaker_cooldown",
                      "watchdog_interval", "wedge_timeout"):
                if k in db:
                    kw[k] = db[k]
            engine = BatchingEngine.for_layer(self._layer, **kw)
            if warmup:
                # a clone racing this attach must block until ONE fully
                # warmed engine is published, not build (and compile) a
                # second engine for the same layer
                engine.warmup(warmup_buckets)
            self._layer._batch_engine = engine
            self._layer._batch_engine_owned = True
            return engine

    def disable_dynamic_batching(self):
        """Detach the shared engine; run() goes back to direct dispatch
        for this predictor AND its clones. Engines this predictor built
        are closed; a caller-provided engine is only detached (other
        consumers, e.g. a PredictorServer, may still be using it)."""
        with _ENGINE_ATTACH_LOCK:
            engine = getattr(self._layer, "_batch_engine", None)
            if engine is None:
                return
            owned = getattr(self._layer, "_batch_engine_owned", True)
            self._layer._batch_engine = None
            self._layer._batch_engine_owned = False
        if owned:
            engine.close()

    def batching_engine(self):
        return getattr(self._layer, "_batch_engine", None)

    # ----------------------------------------------------------- run
    def run(self, inputs=None):
        """ZeroCopyRun analog. With `inputs` (list of numpy arrays) behaves
        like the reference's Run(feed) convenience; otherwise consumes
        handles set via copy_from_cpu. With dynamic batching enabled the
        rows go through the shared engine (padded shape-bucket batches,
        outputs sliced back; bitwise the direct path's for a request of
        >= 2 rows and a solo 1-row one, see inference/batching.py)."""
        engine = getattr(self._layer, "_batch_engine", None)
        if inputs is not None:
            if len(inputs) != len(self._in_names):
                raise ValueError(
                    f"run() got {len(inputs)} inputs, model has "
                    f"{len(self._in_names)}: {self._in_names}")
            if engine is not None:
                arrays = engine.infer([np.asarray(a) for a in inputs])
                # keep the handle API coherent with the non-engine
                # path: inputs stay readable/re-runnable afterwards
                for name, arr in zip(self._in_names, inputs):
                    self._inputs[name] = np.asarray(arr)
                if self._out_names is None:
                    self._out_names = [f"out{i}"
                                       for i in range(len(arrays))]
                self._outputs = dict(zip(self._out_names, arrays))
                return arrays
            for name, arr in zip(self._in_names, inputs):
                self.get_input_handle(name).copy_from_cpu(arr)
        missing = [n for n in self._in_names if n not in self._inputs]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        args = [self._inputs[n] for n in self._in_names]
        if engine is not None:
            # host arrays stay as they are (copy_from_cpu keeps them on
            # the host while an engine is attached)
            arrays = engine.infer([_host(a) for a in args])
        else:
            # a host array can be left behind by copy_from_cpu if the
            # engine was detached since; put it on our device now
            args = [a.to(self._device) if isinstance(a, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(a)).to(self._device)
                    for a in args]
            arrays = list(self._layer.run_slabs(args))
        if self._out_names is None:
            self._out_names = [f"out{i}" for i in range(len(arrays))]
        self._outputs = dict(zip(self._out_names, arrays))
        if inputs is not None:
            return [_host(a) for a in arrays]
        return True

    def clone(self):
        shared = (self._layer, self._in_names, self._out_names, self._device)
        return Predictor(self._config, _shared=shared)

    def clear_intermediate_tensor(self):
        self._outputs = {}

    def try_shrink_memory(self):
        self._inputs = {}
        self._outputs = {}


def _host(a):
    """A tensor or array as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def create_predictor(config):
    """reference: CreatePaddlePredictor / paddle_infer::CreatePredictor."""
    if not isinstance(config, Config):
        raise TypeError("create_predictor expects an inference.Config")
    return Predictor(config)
