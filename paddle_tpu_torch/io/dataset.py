"""Datasets (counterpart of paddle_tpu/io/dataset.py): map-style
``Dataset``, ``IterableDataset``, ``TensorDataset``, ``ComposeDataset``,
``ChainDataset``, ``ConcatDataset``, ``Subset`` and ``random_split``, whose
permutation is numpy's global one, as in the reference."""
import bisect

from ..core.errors import reject_unread


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    import numpy as np

    reject_unread("random_split", generator=(generator, None))
    total = sum(lengths)
    assert total == len(dataset)
    perm = np.random.permutation(total)
    out = []
    offset = 0
    for ln in lengths:
        out.append(Subset(dataset, perm[offset:offset + ln].tolist()))
        offset += ln
    return out
