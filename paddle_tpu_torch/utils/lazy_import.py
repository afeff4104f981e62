"""try_import (counterpart of paddle_tpu/utils/lazy_import.py; reference:
python/paddle/utils/lazy_import.py)."""
import importlib


def try_import(module_name, err_msg=None):
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(err_msg or f"module {module_name} not found; it is "
                          "not available in this environment")
