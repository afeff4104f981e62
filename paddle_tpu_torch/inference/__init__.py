"""paddle.inference — the deployment API (counterpart of
paddle_tpu/inference; reference: paddle/fluid/inference/api/
analysis_predictor.cc AnalysisPredictor, paddle_api.h,
paddle_inference_api.h Config/Predictor/Tensor).

Models are ``paddle.jit.save`` programs (``torch.export``); the predictor
loads one onto its device and runs it with inputs and outputs on the
device (ZeroCopyRun). ``serve_model`` serves one over the wire protocol
of ``wire_spec`` (server.py), with dynamic batching, hot reload (cmd 4)
and drain (cmd 8). The fleet tier (``Fleet``, ``FleetRouter``,
``ReplicaRegistry``, ``Autoscaler``; fleet.py, router.py, registry.py)
puts replicas behind one router; sharded serving is a later slice
(ROADMAP Queue 1).
"""
from .config import Config, PlaceType, PrecisionType
from .predictor import Predictor, Tensor as PredictorTensor, create_predictor
from .predictor import Tensor  # noqa: F401 (reference exports it plainly)


class DataType:
    """reference: paddle_infer.DataType enum."""

    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4


__all__ = [
    "Config", "DataType", "Predictor", "PredictorTensor", "Tensor", "create_predictor",
    "PrecisionType", "PlaceType", "serve_model",
    # the fleet tier (lazy: importing the package starts no thread)
    "Fleet", "FleetRouter", "ReplicaRegistry", "TenantPolicy", "Autoscaler",
    "subprocess_spawner", "tenant_id",
    "DecodeEngine", "DecodeModel", "DecodeRequest",
]

_HOMES = {"DecodeEngine": "decode", "DecodeModel": "decode", "DecodeRequest": "decode",
          "serve_model": "server", "Fleet": "fleet", "Autoscaler": "fleet",
          "subprocess_spawner": "fleet", "ReplicaHandle": "fleet", "FleetRouter": "router",
          "TenantPolicy": "router", "FairGate": "router", "tenant_id": "router",
          "ReplicaRegistry": "registry"}


def __getattr__(name):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{home}", __name__), name)
