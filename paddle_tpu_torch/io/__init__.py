"""paddle.io (counterpart of paddle_tpu/io): datasets, samplers and the
DataLoader, whose batches reach the current place through pinned memory
and an asynchronous copy in the parent."""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset, Subset,
    TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler, SequenceSampler,
    WeightedRandomSampler,
)
from .dataloader import DataLoader, default_collate_fn, get_worker_info  # noqa: F401
