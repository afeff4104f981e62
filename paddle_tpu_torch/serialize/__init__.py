"""paddle.serialize (counterpart of paddle_tpu/serialize): ``export``, the
one program wire format (``torch.export`` programs). The artifact store
(``artifact_store.py``) is a later slice (ROADMAP Queue 1)."""
from . import export  # noqa: F401
from .export import deserialize_exported, model_fingerprint, serialize_exported  # noqa: F401

__all__ = ["export", "serialize_exported", "deserialize_exported", "model_fingerprint"]
