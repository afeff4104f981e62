"""Runtime flags (counterpart of paddle_tpu/core/flags.py): the registry,
``set_flags`` and ``get_flags``, with the reference's names and defaults.

The port reads no environment, so ``FLAGS_*`` variables are not read. A
flag either acts as in the reference or refuses any value but its
default:

- ``check_nan_inf``: every ``paddle.*`` op scans its floating outputs and
  raises PreconditionNotMetError on a NaN or Inf;
- ``default_dtype``: the floating dtype of creation ops and ``to_tensor``;
- ``seed``: the last ``paddle.seed``, as in the reference (setting the flag
  reseeds nothing there either);
- ``benchmark``: every ``paddle.*`` op synchronizes the card after it runs;
- every other flag names a knob of the JAX package (its per-op jit, the
  Pallas routing, the XLA softmax dtype, XLA's allocator) that the port
  does not have: setting it to another value than its default raises
  UnimplementedError.
"""
import threading

from . import errors

_LOCK = threading.Lock()

# name -> (default, parser, help, acts)
_REGISTRY = {}
_VALUES = {}


def _parse_bool(v):
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes", "on")
    return bool(v)


def define_flag(name, default, parser=None, help="", acts=True):
    with _LOCK:
        if name in _REGISTRY:
            return
        if parser is None:
            if isinstance(default, bool):
                parser = _parse_bool
            elif isinstance(default, int):
                parser = int
            elif isinstance(default, float):
                parser = float
            else:
                parser = str
        _REGISTRY[name] = (default, parser, help, acts)
        _VALUES[name] = default


def _key(name):
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise KeyError(f"flag {name!r} is not registered")
    return key


def set_flags(flags):
    """paddle.set_flags — dict of name -> value."""
    parsed = {}
    for name, value in flags.items():
        key = _key(name)
        default, parser, _, acts = _REGISTRY[key]
        v = parser(value)
        if not acts and v != default:
            raise errors.UnimplementedError(
                f"flag {name!r}: the port has no such knob (it keeps the reference's "
                f"default {default!r}); setting it to {value!r} would be ignored")
        parsed[key] = v
    _VALUES.update(parsed)


def flag_value(name):
    """Fast single-flag read for the op funnel."""
    return _VALUES[name]


def get_flags(flags):
    """paddle.get_flags — name or list of names -> dict."""
    if isinstance(flags, str):
        flags = [flags]
    return {name: _VALUES[_key(name)] for name in flags}


define_flag("check_nan_inf", False, help="scan every paddle.* op's floating outputs for NaN/Inf")
define_flag("default_dtype", "float32", help="default floating dtype for creation ops")
define_flag("eager_jit_ops", True, acts=False,
            help="the reference's per-op jax.jit cache; torch runs eagerly")
define_flag("benchmark", False, help="synchronize the card after each paddle.* op")
define_flag("cudnn_deterministic", False, acts=False, help="a compat no-op in the reference")
define_flag("use_pallas_kernels", True, acts=False,
            help="the reference's Pallas routing; the port's flash kernels always run")
define_flag("pallas_attention_min_seq", 1024, acts=False,
            help="the reference's XLA-vs-Pallas attention threshold")
define_flag("sdpa_softmax_fp32", True, acts=False,
            help="the reference's XLA attention path's softmax dtype")
define_flag("allocator_strategy", "auto_growth", acts=False, help="XLA's allocator")
define_flag("fraction_of_gpu_memory_to_use", 0.92, acts=False, help="XLA's allocator")
define_flag("seed", 0, help="the last paddle.seed")
