"""paddle.incubate (counterpart of paddle_tpu/incubate): the wrapper
optimizers (``incubate.optimizer``: LookAhead, ModelAverage),
``auto_checkpoint`` (epoch-granular resume) and ``autograd`` (vjp, jvp,
jacobian, hessian) and ``moe`` (``MoELayer``, import it as
``paddle_tpu_torch.incubate.moe``). The reference's fleet, embedding and
recommendation pieces are not ported yet (ROADMAP Queue 1)."""
from . import autograd  # noqa: F401
from . import optimizer  # noqa: F401
from .checkpoint import auto_checkpoint  # noqa: F401
