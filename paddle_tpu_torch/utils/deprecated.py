"""paddle.utils.deprecated (counterpart of paddle_tpu/utils/deprecated.py;
reference: python/paddle/utils/deprecated.py) — decorator stamping a
deprecation notice into the docstring and warning once per call site."""
import functools
import warnings

__all__ = ["deprecated"]


def deprecated(update_to="", since="", reason=""):
    def decorator(func):
        note = (f"Warning: API \"{func.__module__}.{func.__name__}\" is "
                f"deprecated"
                + (f" since {since}" if since else "")
                + (f", and will be removed in future versions. Please use "
                   f"\"{update_to}\" instead" if update_to else "")
                + (f". Reason: {reason}" if reason else "."))
        func.__doc__ = f"{note}\n\n{func.__doc__ or ''}"

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(note, DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)

        return wrapper

    return decorator
