"""Hybrid-parallel building blocks (counterpart of
paddle_tpu/distributed/meta_parallel/; reference: python/paddle/
distributed/fleet/meta_parallel/)."""
from .mp_layers import (  # noqa: F401
    VocabParallelEmbedding, ColumnParallelLinear, RowParallelLinear,
    get_rng_state_tracker, RNGStatesTracker, model_parallel_random_seed,
)
from .pp_layers import PipelineLayer, LayerDesc, SharedLayerDesc, SegmentLayers  # noqa: F401
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .model_parallel import ModelParallel  # noqa: F401
