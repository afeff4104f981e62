"""Tensor print options (counterpart of paddle_tpu/tensor/to_string.py):
Tensor reprs format through numpy, so the options are numpy's."""
import numpy as np

__all__ = ["set_printoptions"]

_PRECISION = 8  # paddle's documented default


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    global _PRECISION
    kw = {}
    if precision is not None:
        _PRECISION = int(precision)
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    if sci_mode is not None:
        if sci_mode:
            prec = _PRECISION

            def _sci(x):
                return np.format_float_scientific(x, precision=prec)

            kw["formatter"] = {"float_kind": _sci}
            kw["suppress"] = False
        else:
            kw["formatter"] = None
            kw["suppress"] = True
    np.set_printoptions(**kw)
