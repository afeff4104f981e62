"""paddle_tpu_torch.io (Dataset, samplers, DataLoader) on the CPU: the
reference's tests/test_io_e2e.py TestDataLoader and TestPrefetchFactor
cases, ported; the batches of both packages' loaders bitwise equal for the
same numpy seed, with 0 and 2 workers and a random transform run in the
workers; the samplers' orders (``DistributedBatchSampler`` with explicit
replicas too) bitwise the reference's; a worker's error reaching the
caller; the knobs the reference never reads refused."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.io import (BatchSampler, DataLoader, Dataset, DistributedBatchSampler,
                                 IterableDataset, TensorDataset)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _np(v):
    v = getattr(v, "_value", v)
    return np.array(v.detach() if isinstance(v, torch.Tensor) else v)


class _SquaresDataset(Dataset):
    def __init__(self, n=64):
        self.n = n

    def __getitem__(self, i):
        return np.float32(i), np.float32(i * i)

    def __len__(self):
        return self.n


class TestDataLoader:
    def test_basic_batching(self):
        batches = list(DataLoader(_SquaresDataset(10), batch_size=4))
        assert len(batches) == 3
        x, y = batches[0]
        assert x.shape == [4] and isinstance(x, tp.Tensor)
        np.testing.assert_allclose(y.numpy(), [0, 1, 4, 9])

    def test_drop_last_and_shuffle(self):
        batches = list(DataLoader(_SquaresDataset(10), batch_size=4, drop_last=True,
                                  shuffle=True))
        assert len(batches) == 2
        seen = np.concatenate([b[0].numpy() for b in batches])
        assert len(set(seen.tolist())) == 8

    def test_multiprocess_workers(self):
        batches = list(DataLoader(_SquaresDataset(32), batch_size=4, num_workers=2))
        assert len(batches) == 8
        allx = np.sort(np.concatenate([b[0].numpy() for b in batches]))
        np.testing.assert_allclose(allx, np.arange(32))

    def test_iterable_dataset(self):
        class Gen(IterableDataset):
            def __iter__(self):
                for i in range(10):
                    yield np.float32(i)

        batches = list(DataLoader(Gen(), batch_size=3))
        assert len(batches) == 4
        np.testing.assert_allclose(batches[0].numpy(), [0, 1, 2])

    def test_tensor_dataset_and_samplers(self):
        xs = tp.to_tensor(np.arange(12, dtype=np.float32).reshape(6, 2))
        ys = tp.to_tensor(np.arange(6, dtype=np.int64))
        ds = TensorDataset([xs, ys])
        assert len(ds) == 6
        assert len(BatchSampler(ds, batch_size=2)) == 3
        dbs = DistributedBatchSampler(ds, batch_size=1, num_replicas=2, rank=0)
        assert [i for batch in dbs for i in batch] == [0, 2, 4]
        x, y = next(iter(DataLoader(ds, batch_size=4)))
        assert x.shape == [4, 2] and y.dtype == torch.int32

    def test_dict_collate(self):
        class DictDs(Dataset):
            def __getitem__(self, i):
                return {"a": np.float32(i), "b": np.ones(2, np.float32)}

            def __len__(self):
                return 4

        batch = next(iter(DataLoader(DictDs(), batch_size=4)))
        assert batch["a"].shape == [4]
        assert batch["b"].shape == [4, 2]


class _CountingDataset(Dataset):
    def __init__(self, n=64):
        self.n = n
        self.fetched = 0

    def __getitem__(self, i):
        self.fetched += 1
        return np.full((4,), i, np.float32)

    def __len__(self):
        return self.n


class TestPrefetchFactor:
    @pytest.mark.parametrize("factor", [1, 3])
    def test_lookahead_bounded(self, factor):
        ds = _CountingDataset(32)
        it = iter(DataLoader(ds, batch_size=1, shuffle=False, prefetch_factor=factor))
        consumed = 0
        for _ in range(5):
            next(it)
            consumed += 1
            time.sleep(0.05)
            assert ds.fetched <= consumed + factor
        rest = list(it)
        assert consumed + len(rest) == 32

    def test_prefetch_disabled_is_lazy(self):
        ds = _CountingDataset(8)
        it = iter(DataLoader(ds, batch_size=1, shuffle=False, use_buffer_reader=False))
        next(it)
        assert ds.fetched == 1

    def test_multiprocess_inflight_dispatch_uses_factor(self):
        batches = list(DataLoader(_CountingDataset(12), batch_size=2, shuffle=False,
                                  num_workers=2, prefetch_factor=3))
        assert len(batches) == 6
        assert sorted(float(b.numpy()[0, 0]) for b in batches) == [0.0, 2.0, 4.0, 6.0, 8.0,
                                                                     10.0]


# ------------------------------------------------ parity with the reference
def _flipping(pkg):
    """A dataset of seeded images whose __getitem__ runs ``pkg``'s random
    transforms (in the workers, when there are any)."""
    T = pkg.vision.transforms
    images = np.random.RandomState(9).randint(0, 256, (40, 8, 8, 3)).astype(np.uint8)

    class Flipping(pkg.io.Dataset):
        transform = T.Compose([T.RandomHorizontalFlip(), T.RandomCrop(6),
                               T.Normalize(mean=[10.0, 20.0, 30.0], std=[2.0, 3.0, 4.0])])

        def __getitem__(self, i):
            return self.transform(images[i]), np.int64(i)

        def __len__(self):
            return len(images)

    return Flipping()


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_bitwise_the_reference(workers):
    got = {}
    for name, pkg in (("ref", jp), ("port", tp)):
        np.random.seed(11)
        got[name] = [[_np(t) for t in b] for b in pkg.io.DataLoader(
            _flipping(pkg), batch_size=6, shuffle=True, drop_last=False, num_workers=workers)]
    assert len(got["port"]) == len(got["ref"]) == 7
    for (px, py), (rx, ry) in zip(got["port"], got["ref"]):
        assert px.dtype == rx.dtype == np.float32 and np.array_equal(px, rx)
        assert np.array_equal(py, ry)


@pytest.mark.parametrize("replicas,shuffle,drop_last", [(2, False, False), (3, True, False),
                                                        (4, True, True)])
def test_distributed_batch_sampler_matches_the_reference(replicas, shuffle, drop_last):
    ds = _SquaresDataset(23)
    for rank in range(replicas):
        jb = jp.io.DistributedBatchSampler(ds, 3, num_replicas=replicas, rank=rank,
                                           shuffle=shuffle, drop_last=drop_last)
        tb = DistributedBatchSampler(ds, 3, num_replicas=replicas, rank=rank, shuffle=shuffle,
                                     drop_last=drop_last)
        for epoch in (0, 5):
            jb.set_epoch(epoch)
            tb.set_epoch(epoch)
            assert list(tb) == list(jb) and len(tb) == len(jb)
    default = DistributedBatchSampler(ds, 5)
    assert default.nranks == 1 and default.local_rank == 0 and len(list(default)) == 5


def test_samplers_and_split_match_the_reference():
    ds = _SquaresDataset(17)
    cases = [
        lambda io: list(io.RandomSampler(ds)),
        lambda io: list(io.RandomSampler(ds, replacement=True, num_samples=9)),
        lambda io: list(io.WeightedRandomSampler(np.arange(1, 18), 11)),
        lambda io: list(io.BatchSampler(ds, shuffle=True, batch_size=4, drop_last=True)),
        lambda io: [s.indices for s in io.random_split(ds, [10, 7])],
    ]
    for case in cases:
        np.random.seed(4)
        want = case(jp.io)
        np.random.seed(4)
        assert case(tp.io) == want
    compose = tp.io.ComposeDataset([ds, ds])
    assert compose[3] == (3.0, 9.0, 3.0, 9.0) and len(compose) == 17
    chain = tp.io.ChainDataset([[1, 2], [3]])
    assert [v for v in chain] == [1, 2, 3]


class _Failing(Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 is bad")
        return np.float32(i)

    def __len__(self):
        return 16


@pytest.mark.parametrize("workers", [0, 2])
def test_a_worker_error_reaches_the_caller(workers):
    with pytest.raises(ValueError, match="sample 5 is bad"):
        list(DataLoader(_Failing(), batch_size=4, num_workers=workers))


class _Dying(Dataset):
    def __getitem__(self, i):
        import os

        if i == 3:
            os._exit(7)
        return np.float32(i)

    def __len__(self):
        return 8


def test_a_dead_worker_raises():
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(DataLoader(_Dying(), batch_size=2, num_workers=2))


def test_worker_info_and_host_tensors_in_workers():
    class Info(Dataset):
        def __getitem__(self, i):
            info = tp.io.get_worker_info()
            return np.int64(info.id), tp.vision.transforms.ToTensor()(np.zeros((2, 2, 3),
                                                                              np.uint8))

        def __len__(self):
            return 8

    assert tp.io.get_worker_info() is None
    ids = [b[0].numpy().tolist() for b in DataLoader(Info(), batch_size=2, num_workers=2)]
    assert ids == [[0, 0], [1, 1], [0, 0], [1, 1]]


def test_unread_knobs_raise():
    for kw in (dict(timeout=5), dict(worker_init_fn=print), dict(persistent_workers=True),
               dict(places=tp.CPUPlace()), dict(return_list=False),
               dict(use_shared_memory=False), dict(feed_list=["x"])):
        with pytest.raises(NotImplementedError):
            DataLoader(_SquaresDataset(4), **kw)
    with pytest.raises(NotImplementedError):
        tp.io.RandomSampler(_SquaresDataset(4), generator=1)


def test_from_generator_feeds():
    def reader():
        for i in range(5):
            yield np.full(2, i, np.float32), np.int64(i)

    for pkg in (jp, tp):
        loader = pkg.io.DataLoader.from_generator(return_list=True)
        loader.set_sample_generator(reader, batch_size=2)
        batches = list(loader)
        assert len(batches) == 2 and batches[1][1].tolist() == [2, 3]


class _Large(Dataset):
    """Samples of 300 KB (float32), so a batch of 4 crosses in shared memory;
    and a bfloat16 tensor beside each."""

    def __getitem__(self, i):
        x = np.random.RandomState(i).rand(75000).astype(np.float32)
        return x, torch.full((2,), float(i), dtype=torch.bfloat16)

    def __len__(self):
        return 12


def _segments():
    import os

    mine = f"paddle_tpu_torch_{os.getpid()}_"
    return [n for n in os.listdir("/dev/shm") if n.startswith(mine)]


def test_large_batches_cross_in_shared_memory_and_leave_no_segment():
    want = list(DataLoader(_Large(), batch_size=4))
    got = list(DataLoader(_Large(), batch_size=4, num_workers=2))
    for (gx, gb), (wx, wb) in zip(got, want):
        assert gx.numpy().nbytes >= 1 << 20 and np.array_equal(gx.numpy(), wx.numpy())
        assert gb.dtype == torch.bfloat16 and torch.equal(gb, wb)
    assert _segments() == []
    it = iter(DataLoader(_Large(), batch_size=4, num_workers=2, prefetch_factor=2))
    next(it)
    time.sleep(0.5)  # the workers fill the others
    it.close()
    assert _segments() == []
