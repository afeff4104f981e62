"""Samplers (counterpart of paddle_tpu/io/sampler.py): the index orders
come from numpy's global generator (``RandomState(epoch)`` for
``DistributedBatchSampler``), bitwise the reference's for the same seed."""
import numpy as np

from ..core.errors import reject_unread


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        reject_unread("RandomSampler", generator=(generator, None))
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batch sampler: rank ``rank`` of ``num_replicas`` takes
    every ``num_replicas``-th index of the (padded, per-epoch shuffled)
    order. ``num_replicas``/``rank`` not given are the job's world size and
    this process's rank (``distributed.get_world_size``/``get_rank``; 1 and
    0 outside a job), as in the reference."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import get_rank, get_world_size

            num_replicas = num_replicas if num_replicas is not None else get_world_size()
            rank = rank if rank is not None else get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
