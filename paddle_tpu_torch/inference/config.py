"""Inference Config (counterpart of paddle_tpu/inference/config.py;
reference: paddle/fluid/inference/api/paddle_analysis_config.h
AnalysisConfig: model paths, device selection, optimization switches).

The knobs the reference records and never reads stay records here
(the IR passes, memory optim, TensorRT/Lite/MKLDNN, precision). The ones
read: the model path, the device (``enable_use_gpu`` picks the card and
``disable_gpu`` the CPU; the card is the default, as the accelerator is
the reference's), the dynamic-batching knobs and ``max_batch_size``. The
port adds ``set_slab_rows``: the row count the loaded program runs at
(jit/save_load.py).
"""
import enum
import os


class PrecisionType(enum.Enum):
    Float32 = 0
    Int8 = 1
    Half = 2
    Bfloat16 = 3


class PlaceType(enum.Enum):
    kUNK = -1
    kCPU = 0
    kGPU = 1
    kXPU = 2
    kNPU = 3
    kTPU = 4


class Config:
    """reference: AnalysisConfig (paddle_analysis_config.h)."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        # paddle.jit.save writes <prefix>.pdmodel/.pdiparams; Config accepts
        # either a directory containing one model or the explicit pair.
        self._model_dir = None
        self._prog_file = None
        self._params_file = None
        if model_dir is not None and prog_file is None:
            if os.path.isdir(model_dir):
                self._model_dir = model_dir
            else:
                # treat as prefix (the 2.x convention)
                self._prog_file = model_dir + ".pdmodel"
                self._params_file = model_dir + ".pdiparams"
        if prog_file is not None:
            self._prog_file = prog_file
            self._params_file = params_file or os.path.splitext(prog_file)[0] + ".pdiparams"
        self._device = "gpu"
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._memory_optim = True
        self._ir_optim = True
        self._cpu_math_threads = 1
        self._enable_profile = False
        self._exec_stream = None
        self._extra = {}

    # ----------------------------------------------------------- model path
    def set_model(self, prog_or_dir, params_file=None):
        if params_file is None and os.path.isdir(prog_or_dir):
            self._model_dir = prog_or_dir
        else:
            self._prog_file = prog_or_dir
            self._params_file = params_file

    def set_prog_file(self, path):
        self._prog_file = path

    def set_params_file(self, path):
        self._params_file = path

    def model_dir(self):
        return self._model_dir

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def model_prefix(self):
        """Resolve the jit.save prefix this config points at."""
        if self._prog_file:
            base = self._prog_file
            if base.endswith(".pdmodel"):
                base = base[: -len(".pdmodel")]
            return base
        if self._model_dir:
            for fn in sorted(os.listdir(self._model_dir)):
                if fn.endswith(".pdmodel"):
                    return os.path.join(self._model_dir, fn[: -len(".pdmodel")])
            raise FileNotFoundError(f"no .pdmodel under {self._model_dir}")
        raise ValueError("Config has no model path; call set_model()")

    # ----------------------------------------------------------- devices
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = "gpu"
        self._device_id = device_id

    def enable_tpu(self, device_id=0):
        # the reference's accelerator request: the card here
        self._device = "gpu"
        self._device_id = device_id

    def enable_xpu(self, l3_workspace_size=0xFFFFFF):
        self._device = "gpu"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device == "gpu"

    def gpu_device_id(self):
        return self._device_id

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = int(n)

    def cpu_math_library_num_threads(self):
        return self._cpu_math_threads

    # ----------------------------------------------------------- optimization
    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self, flag=True):
        self._memory_optim = bool(flag)

    def memory_optim_enabled(self):
        return self._memory_optim

    def switch_use_feed_fetch_ops(self, flag=False):
        self._extra["use_feed_fetch_ops"] = bool(flag)

    def switch_specify_input_names(self, flag=True):
        self._extra["specify_input_names"] = bool(flag)

    # TensorRT/Lite/MKLDNN: recorded; max_batch_size caps the
    # dynamic-batching engine (Predictor.enable_dynamic_batching)
    # (reference: enable_tensorrt_engine, EnableLiteEngine, EnableMKLDNN in
    # paddle_analysis_config.h).
    def enable_tensorrt_engine(self, workspace_size=1 << 30, max_batch_size=1,
                               min_subgraph_size=3,
                               precision_mode=PrecisionType.Float32,
                               use_static=False, use_calib_mode=False):
        self._precision = precision_mode
        self._extra["tensorrt"] = dict(workspace_size=workspace_size,
                                       max_batch_size=max_batch_size)

    def tensorrt_engine_enabled(self):
        return "tensorrt" in self._extra

    # ------------------------------------------------------ dynamic batching
    def enable_dynamic_batching(self, max_batch_size=32, max_wait_ms=2.0,
                                max_queue=256, breaker_threshold=None,
                                breaker_cooldown=None,
                                watchdog_interval=None,
                                wedge_timeout=None,
                                cold_compile_timeout=None):
        """Record dynamic-batching engine knobs; Predictor reads them in
        enable_dynamic_batching(). max_batch_size here wins over the
        enable_tensorrt_engine one when both are set. The robustness
        knobs (breaker_threshold/breaker_cooldown, watchdog_interval/
        wedge_timeout) default to the engine's defaults when None;
        ``cold_compile_timeout`` is recorded (the port compiles nothing
        cold)."""
        cfg = dict(max_batch_size=int(max_batch_size),
                   max_wait_ms=float(max_wait_ms), max_queue=int(max_queue))
        if breaker_threshold is not None:
            cfg["breaker_threshold"] = int(breaker_threshold)
        if breaker_cooldown is not None:
            cfg["breaker_cooldown"] = float(breaker_cooldown)
        if watchdog_interval is not None:
            cfg["watchdog_interval"] = float(watchdog_interval)
        if wedge_timeout is not None:
            cfg["wedge_timeout"] = float(wedge_timeout)
        if cold_compile_timeout is not None:
            cfg["cold_compile_timeout"] = float(cold_compile_timeout)
        self._extra["dynamic_batching"] = cfg

    def dynamic_batching_enabled(self):
        return "dynamic_batching" in self._extra

    def dynamic_batching_config(self):
        return dict(self._extra.get("dynamic_batching") or {})

    def max_batch_size(self):
        """The serving engine's batch cap: the explicit dynamic-batching
        knob, else the enable_tensorrt_engine(max_batch_size=...) value,
        else 1."""
        db = self._extra.get("dynamic_batching")
        if db:
            return int(db["max_batch_size"])
        trt = self._extra.get("tensorrt")
        if trt:
            return int(trt["max_batch_size"])
        return 1

    def enable_lite_engine(self, precision_mode=PrecisionType.Float32,
                           zero_copy=False, passes_filter=(), ops_filter=()):
        self._precision = precision_mode
        self._extra["lite"] = True

    def lite_engine_enabled(self):
        return bool(self._extra.get("lite"))

    def enable_mkldnn(self):
        self._extra["mkldnn"] = True

    def mkldnn_enabled(self):
        return bool(self._extra.get("mkldnn"))

    def set_precision(self, precision):
        self._precision = precision

    def precision(self):
        return self._precision

    def set_slab_rows(self, rows):
        """The row count the loaded program runs at (every call padded to
        it): the port's remedy for cuBLAS picking its GEMM per M, so a row
        has its direct call's bits in any batch (jit/save_load.py)."""
        self._extra["slab_rows"] = int(rows)

    def slab_rows(self):
        return self._extra.get("slab_rows")

    # ----------------------------------------------------------- misc
    def enable_profile(self):
        self._enable_profile = True

    def is_valid(self):
        try:
            self.model_prefix()
            return True
        except (ValueError, FileNotFoundError):
            return False

    def summary(self):
        """reference: AnalysisConfig::Summary()."""
        rows = [
            ("model_prefix", self.model_prefix() if self.is_valid() else "<unset>"),
            ("device", f"{self._device}:{self._device_id}"),
            ("precision", self._precision.name),
            ("ir_optim", self._ir_optim),
            ("memory_optim", self._memory_optim),
        ]
        width = max(len(k) for k, _ in rows)
        return "\n".join(f"{k.ljust(width)}  {v}" for k, v in rows)
