"""paddle.onnx (counterpart of paddle_tpu/onnx; reference:
python/paddle/onnx/export.py). The reference delegates to paddle2onnx;
here the layer is captured with ``torch.export`` and its ATen graph
lowered to ONNX (export.py), serialized by a hand-written protobuf writer
(wire.py; no onnx package is needed). runner.py is a numpy evaluator of
the exported files.
"""
from .export import UnsupportedOp, export, export_bytes  # noqa: F401
from .runner import load, run  # noqa: F401

__all__ = ["export", "export_bytes", "load", "run", "UnsupportedOp"]
