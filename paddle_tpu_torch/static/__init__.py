"""paddle.static (counterpart of paddle_tpu/static): ``InputSpec`` only.
The Program/Executor facade, ``static.nn`` and static ``minimize`` are a
later slice (ROADMAP Queue 1)."""
from .input_spec import InputSpec  # noqa: F401

__all__ = ["InputSpec"]
