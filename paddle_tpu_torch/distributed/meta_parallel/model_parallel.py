"""ModelParallel wrapper (counterpart of
paddle_tpu/distributed/meta_parallel/model_parallel.py; reference:
fleet/meta_parallel/model_parallel.py:21). The tensor-parallel layers run
their own collectives inside a training step over an mp mesh, so the
wrapper only runs the model; its parameters are built alike on every rank
(the same seed), as the reference's global-view model guarantees."""
from ...nn.layer import Layer


class ModelParallel(Layer):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)
