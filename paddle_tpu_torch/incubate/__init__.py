"""paddle.incubate (counterpart of paddle_tpu/incubate): the wrapper
optimizers (``incubate.optimizer``: LookAhead, ModelAverage) and
``auto_checkpoint`` (epoch-granular resume). The reference's
``incubate.autograd`` and its fleet, MoE, embedding and recommendation
pieces are not ported yet (ROADMAP Queue 1)."""
from . import optimizer  # noqa: F401
from .checkpoint import auto_checkpoint  # noqa: F401
