"""Fault injection for the port's serving paths (counterpart of
paddle_tpu/resilience): :mod:`chaos`."""
from . import chaos  # noqa: F401
