"""paddle.utils.unique_name (counterpart of paddle_tpu/utils/unique_name.py;
reference: fluid/unique_name.py) — process-
wide unique name generation with guard/switch scoping."""
import contextlib
import itertools
import threading

__all__ = ["generate", "guard", "switch"]


class _Generator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = {}
        self.lock = threading.Lock()

    def unique(self, key):
        with self.lock:
            counter = self.ids.setdefault(key, itertools.count(0))
            return f"{self.prefix}{key}_{next(counter)}"


_generator = _Generator()


def generate(key):
    return _generator.unique(key)


def switch(new_generator=None):
    global _generator
    old = _generator
    if isinstance(new_generator, str):
        # reference API: guard("prefix/") prefixes generated names
        new_generator = _Generator(new_generator)
    _generator = new_generator or _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        global _generator
        _generator = old
