"""paddle.jit (counterpart of paddle_tpu/jit; reference: python/paddle/
fluid/dygraph/jit.py:161 declarative, dygraph_to_static/
program_translator.py:233 StaticFunction, :689 ProgramCache).

``to_static`` captures the function (after dy2static's rewrite of its
``if``/``while`` statements) with ``torch.export`` into one program per
input key, the layer's weights as its inputs, and runs that program with
the live weights, so ``loss.backward()`` flows through it
(static_function.py). ``save``/``load`` write and read the deployment
format (save_load.py): a ``torch.export`` program, the reference's npz of
weights and its JSON sidecar. The kernels are ``torch.library`` custom
ops, so a captured or loaded program launches them.
"""
from .static_function import (  # noqa: F401
    to_static, declarative, StaticFunction, not_to_static, ignore_module,
    enable_to_static,
)
from .translator import ProgramTranslator, TracedLayer  # noqa: F401
from .save_load import save, load, TranslatedLayer  # noqa: F401

_STATIC_MODE = False


def enable_static():
    global _STATIC_MODE
    _STATIC_MODE = True


def disable_static():
    global _STATIC_MODE
    _STATIC_MODE = False


def in_dynamic_mode():
    return not _STATIC_MODE


def set_code_level(level=100):
    pass


def set_verbosity(level=0):
    pass
