"""DataLoader (counterpart of paddle_tpu/io/dataloader.py).

Three sources of host batches, as in the reference: the single-process
path, forked workers (``num_workers > 0``; each worker seeds numpy's global
generator with ``np.random.randint(0, 2**31)`` drawn in the parent plus its
id, takes the batches ``i % num_workers == id`` and puts collated batches
on one ``mp.Queue``; the parent reorders them), and an ``IterableDataset``
read in the parent. A worker's arrays of 1 MiB or more cross in POSIX
shared memory (``/dev/shm``) rather than through the queue's pipe: the
parent copies each out once, into pinned memory for the card, and unlinks
it (segments of batches never read are unlinked when the iterator
closes). The index order, the workers'
seeds and so every random transform are the reference's for the same
numpy seed.

Nothing a worker runs touches CUDA (a CUDA context cannot be made again in
a forked child): samples and collated batches stay on the host (the port's
``ToTensor`` gives a host tensor). Batches move to the current place in the
parent only, when the iterator was made on it (the card unless
``set_device`` said otherwise; without a card it raises), with the
reference's dtype policy (int64 -> int32, float64 -> the default float).
With ``use_buffer_reader`` (the default) a background thread keeps at most
``prefetch_factor`` batches ahead of the consumer and, on the card, copies
each batch from pinned host memory on a side stream (``non_blocking``);
the consumer's stream waits on the copy's event, so the copy overlaps the
step. Without it the copy runs in the consumer's thread on its stream.

A worker's exception reaches the caller (the original when it pickles,
else a RuntimeError with its traceback), and so does a worker that dies.
The workers stop when the iterator is exhausted, closed or dropped, and
when the parent dies.

Knobs the reference accepts and never reads raise at a value other than
their default: ``feed_list``, ``places``, ``return_list=False``,
``use_shared_memory=False``, ``timeout``, ``worker_init_fn`` and
``persistent_workers``.
"""
import itertools
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import signal
import threading
import time
import traceback
from multiprocessing import resource_tracker, shared_memory

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.errors import reject_unread
from ..core.tensor import wrap
from ..resilience.retry import call_with_retry
from .dataset import IterableDataset
from .sampler import BatchSampler

_POLL_S = 1.0  # how often a parent waiting on a batch checks its workers


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = None


def get_worker_info():
    """In a worker: its ``WorkerInfo`` (id, num_workers, dataset, seed);
    None in the parent."""
    return _worker_info


def default_collate_fn(batch):
    """Stack a list of samples into batch arrays (the reference's
    default_collate_fn); tensors stack on the host."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return wrap(torch.stack([torch.Tensor.detach(s) for s in batch]))
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items)) for items in zip(*batch))
    return np.asarray(batch)


def _canonical(t):
    if t.dtype == torch.float64:
        return t.to(dtype_mod.convert_dtype(dtype_mod.get_default_dtype()))
    return t.to(dtype_mod.canonicalize_dtype(t.dtype))


_SHM_MIN = 1 << 20  # arrays of at least this many bytes cross in shared memory


_ITERS = itertools.count()  # numbers this process's worker iterators


def _shm_prefix(parent, iterator):
    """The names of one worker iterator's batch segments
    (``/dev/shm/<prefix>...``)."""
    return f"paddle_tpu_torch_{parent}_{iterator}_"


class _Shipped:
    """An array or torch tensor of a worker's batch, crossing the queue. One
    of 1 MiB or more goes through a POSIX shared-memory segment the worker
    fills, named for the parent, which copies it out once (into pinned
    memory for the card) and unlinks it; a smaller one as its pickled
    bytes. A torch tensor travels as its array (a bfloat16 one as its
    16-bit words): torch's own reduction would share its storage through
    file descriptors that the worker must outlive."""

    def __init__(self, obj, name):
        self.bf16 = isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16
        if isinstance(obj, torch.Tensor):
            t = torch.Tensor.detach(obj).cpu()
            obj = torch.Tensor.numpy(t.view(torch.int16) if self.bf16 else t)
        self.shape, self.dtype = obj.shape, obj.dtype
        self.name = self.array = None
        if obj.nbytes < _SHM_MIN:
            self.array = np.ascontiguousarray(obj)
            return
        shm = shared_memory.SharedMemory(name=name, create=True, size=obj.nbytes)
        # the parent unlinks it: this process's resource tracker must not
        resource_tracker.unregister(shm._name, "shared_memory")
        view = np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)
        view[...] = obj
        del view
        shm.close()
        self.name = name

    def tensor(self, pin):
        """The host torch tensor (pinned when ``pin``); a segment is copied
        out and unlinked."""
        if self.name is None:
            t = torch.from_numpy(self.array)
        else:
            shm = shared_memory.SharedMemory(name=self.name)
            try:
                src = torch.from_numpy(np.ndarray(self.shape, self.dtype, buffer=shm.buf))
                t = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
                t.copy_(src)
                del src
            finally:
                shm.close()
                shm.unlink()
        return t.view(torch.bfloat16) if self.bf16 else t


def _unlink(name):
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    shm.close()
    shm.unlink()


def _packed(obj, name):
    """A collated batch with its arrays and torch tensors as ``_Shipped``s
    (segments named ``name`` + a running number)."""
    count = itertools.count()

    def pack(o):
        if isinstance(o, (np.ndarray, torch.Tensor)):
            return _Shipped(o, f"{name}_{next(count)}")
        if isinstance(o, dict):
            return {k: pack(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(pack(v) for v in o)
        return o

    return pack(obj)


def _to_place(obj, device):
    """A host batch's arrays and tensors as Tensors on ``device`` (on the
    card: pinned, then copied ``non_blocking`` on the current stream)."""
    if isinstance(obj, _Shipped):
        obj = obj.tensor(pin=device.type == "cuda")
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        t = torch.from_numpy(obj) if isinstance(obj, np.ndarray) else torch.Tensor.detach(obj)
        t = _canonical(t)
        if device.type == "cuda":
            t = (t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True)
        return wrap(t)
    if isinstance(obj, dict):
        return {k: _to_place(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_place(v, device) for v in obj)
    return obj


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _portable(e):
    """``e`` if it survives pickling, else a RuntimeError with its
    traceback (an unpicklable exception would vanish in the queue)."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:  # noqa: BLE001 - any pickling failure
        return RuntimeError("DataLoader worker raised " + "".join(
            traceback.format_exception(type(e), e, e.__traceback__)))


def _worker_loop(dataset, index_queue, out_queue, collate_fn, worker_id, num_workers,
                 seed, parent, prefix):
    global _worker_info
    # the parent's signal handlers (a preemption handler's flag) must not
    # keep a worker alive when it is told to stop
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    _worker_info = WorkerInfo(worker_id, num_workers, dataset, seed)
    np.random.seed(seed)
    try:
        while True:
            try:
                cmd = index_queue.get(timeout=_POLL_S)
            except queue_mod.Empty:
                if os.getppid() != parent:  # the parent died: nobody will read
                    break
                continue
            if cmd is None:
                break
            batch_idx, indices = cmd
            try:
                # transient I/O of a remote-filesystem dataset gets backoff
                # and retry instead of failing the batch
                samples = [call_with_retry(dataset.__getitem__, i, retry_on=(OSError,),
                                           base_delay=0.05) for i in indices]
                out_queue.put((batch_idx, _packed(collate_fn(samples), f"{prefix}{batch_idx}")))
            except Exception as e:  # noqa: BLE001 - handed to the parent
                out_queue.put((batch_idx, _portable(e)))
    except KeyboardInterrupt:
        pass


class _MultiprocessIter:
    def __init__(self, loader):
        self.loader = loader
        self.ctx = mp.get_context("fork")
        self.out_queue = self.ctx.Queue()
        self.workers = []
        self.index_queues = []
        self.batches = iter(loader.batch_sampler)
        self.send_idx = 0
        self.rcvd_idx = 0
        self.reorder = {}
        self.done_sending = False
        self.recv_s = 0.0  # the parent's seconds receiving (reading, unpickling)
        self.prefix = _shm_prefix(os.getpid(), next(_ITERS))
        seed = np.random.randint(0, 2 ** 31)
        for wid in range(loader.num_workers):
            iq = self.ctx.Queue()
            w = self.ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, iq, self.out_queue, loader.collate_fn, wid,
                      loader.num_workers, seed + wid, os.getpid(), self.prefix),
                daemon=True)
            w.start()
            self.workers.append(w)
            self.index_queues.append(iq)
        # in flight: at most prefetch_factor batches per worker; each batch
        # received sends one more
        for _ in range(loader.num_workers * loader.prefetch_factor):
            self._send_next()

    def _send_next(self):
        if self.done_sending:
            return
        try:
            indices = next(self.batches)
        except StopIteration:
            self.done_sending = True
            return
        wid = self.send_idx % len(self.workers)
        self.index_queues[wid].put((self.send_idx, indices))
        self.send_idx += 1

    def _get(self):
        """The next (index, data) from the workers; raises if one died."""
        while True:
            try:
                return self.out_queue.get(timeout=_POLL_S)
            except queue_mod.Empty:
                dead = [(i, w.exitcode) for i, w in enumerate(self.workers)
                        if w.exitcode is not None]
                if dead:
                    self.close()
                    raise RuntimeError(f"DataLoader worker(s) exited unexpectedly "
                                       f"(worker id, exit code): {dead}")

    def __next__(self):
        if self.rcvd_idx >= self.send_idx and self.done_sending:
            self.close()
            raise StopIteration
        t = time.perf_counter()
        while self.rcvd_idx not in self.reorder:
            idx, data = self._get()
            self.reorder[idx] = data
        self.recv_s += time.perf_counter() - t
        data = self.reorder.pop(self.rcvd_idx)
        self.rcvd_idx += 1
        self._send_next()
        if isinstance(data, Exception):
            self.close()
            raise data
        return data

    def close(self):
        workers, self.workers = self.workers, []
        for iq in self.index_queues:
            try:
                iq.put(None)
            except Exception:  # noqa: BLE001 - a closed queue
                pass
        deadline = time.monotonic() + 2.0
        for w in workers:
            w.join(timeout=max(0.0, deadline - time.monotonic()))
        for w in workers:
            if w.is_alive():
                w.terminate()
                w.join(timeout=1.0)
        self.reorder = {}
        for q in (*self.index_queues, self.out_queue):
            q.close()
            q.cancel_join_thread()
        self.index_queues = []
        # the segments of batches never read: received, in the queue, or
        # being filled by a worker that was stopped (a queue may hold a
        # message a stopped worker never finished, so it is not read)
        for name in (os.listdir("/dev/shm") if os.path.isdir("/dev/shm") else ()):
            if name.startswith(self.prefix):
                _unlink(name)

    def __del__(self):
        if self.workers:
            self.close()


class _SingleProcessIter:
    def __init__(self, loader):
        self.loader = loader
        self.batches = iter(loader.batch_sampler)

    def __next__(self):
        indices = next(self.batches)
        # the workers' retry of transient I/O
        samples = [call_with_retry(self.loader.dataset.__getitem__, i, retry_on=(OSError,),
                                   base_delay=0.05) for i in indices]
        return self.loader.collate_fn(samples)


class _IterableDatasetIter:
    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader.dataset)

    def __next__(self):
        samples = list(itertools.islice(self.it, self.loader.batch_size))
        if not samples:
            raise StopIteration
        if self.loader.drop_last and len(samples) < self.loader.batch_size:
            raise StopIteration
        return self.loader.collate_fn(samples)


class _PrefetchIter:
    """Bounded lookahead on a background thread (the reference's
    buffered_reader analog). ``depth`` is a hard cap: a slot is taken
    before the next batch is made and freed when the consumer takes one.
    On the card the thread copies each batch on its own stream and hands
    over the copy's event with it."""

    def __init__(self, inner, depth, device):
        self.inner = inner
        self.device = device
        self._slots = threading.Semaphore(max(1, int(depth)))
        self._closed = False
        self.place_s = 0.0  # the thread's seconds placing batches (pinning, copy calls)
        self.q = queue_mod.Queue()
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _fill(self):
        try:
            while True:
                self._slots.acquire()
                if self._closed:
                    return
                host = next(self.inner)
                t = time.perf_counter()
                if self._stream is None:
                    batch = _to_place(host, self.device)
                    self.place_s += time.perf_counter() - t
                    self.q.put(("data", (batch, None)))
                    continue
                with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                    batch = _to_place(host, self.device)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self.place_s += time.perf_counter() - t
                self.q.put(("data", (batch, event)))
        except StopIteration:
            self.q.put(("stop", None))
        except Exception as e:  # noqa: BLE001 - handed to the consumer
            self.q.put(("error", e))

    def __next__(self):
        kind, payload = self.q.get()
        self._slots.release()
        if kind == "stop":
            raise StopIteration
        if kind == "error":
            self.close()
            raise payload
        batch, event = payload
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _tensors(batch):
                t.record_stream(stream)
        return batch

    def close(self):
        self._closed = True
        self._slots.release()
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


class _Direct:
    """No buffer reader: each batch is made and placed when asked for."""

    def __init__(self, inner, device):
        self.inner = inner
        self.device = device

    def __next__(self):
        return _to_place(next(self.inner), self.device)

    def close(self):
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


class _LoaderIter:
    def __init__(self, it):
        self._it = it

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self):
        self._it.close()

    def timings(self):
        """Host seconds so far: receiving the workers' batches
        (``recv_s``) and placing batches on the device (``place_s``)."""
        inner = getattr(self._it, "inner", None)
        return dict(recv_s=getattr(inner, "recv_s", 0.0),
                    place_s=getattr(self._it, "place_s", 0.0))

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - a queue torn down at interpreter exit
            pass


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 prefetch_factor=2, persistent_workers=False):
        reject_unread("DataLoader", feed_list=(feed_list, None), places=(places, None),
                      return_list=(return_list, True),
                      use_shared_memory=(use_shared_memory, True), timeout=(timeout, 0),
                      worker_init_fn=(worker_init_fn, None),
                      persistent_workers=(persistent_workers, False))
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_buffer_reader = use_buffer_reader
        self.batch_size = batch_size
        self.drop_last = drop_last
        # caps both the buffered reader's lookahead and, with workers, the
        # batches in flight per worker
        self.prefetch_factor = max(1, int(prefetch_factor))
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle, batch_size=batch_size,
                                              drop_last=drop_last)

    def __iter__(self):
        device = place_mod.current_device()  # raises without a card unless the CPU was asked
        if self._iterable:
            inner = _IterableDatasetIter(self)
        elif self.num_workers > 0:
            inner = _MultiprocessIter(self)
        else:
            inner = _SingleProcessIter(self)
        if self.use_buffer_reader:
            return _LoaderIter(_PrefetchIter(inner, self.prefetch_factor, device))
        return _LoaderIter(_Direct(inner, device))

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    @staticmethod
    def from_generator(feed_list=None, capacity=64, use_double_buffer=True, iterable=True,
                       return_list=False, use_multiprocess=False, drop_last=True):
        """The legacy static-graph loader (the reference's GeneratorLoader):
        ``set_sample_generator`` / ``set_sample_list_generator`` /
        ``set_batch_generator`` give it a source; iterating yields feed
        dicts of numpy arrays keyed by the ``feed_list`` names (plain lists
        with ``return_list=True``). ``capacity`` and ``use_double_buffer``
        are accepted, as in the reference."""
        return _GeneratorLoader(feed_list, return_list, drop_last)


class _GeneratorLoader:
    """The reference's GeneratorLoader (from_generator)."""

    def __init__(self, feed_list, return_list, drop_last):
        self.feed_list = list(feed_list or [])
        self.return_list = return_list
        self.drop_last = drop_last
        self._batch_gen = None

    def set_sample_generator(self, reader, batch_size, drop_last=True, places=None):
        drop = True if drop_last is None else drop_last

        def batches():
            buf = []
            for sample in reader():
                buf.append(sample if isinstance(sample, (list, tuple)) else [sample])
                if len(buf) == batch_size:
                    yield [np.stack([row[i] for row in buf]) for i in range(len(buf[0]))]
                    buf = []
            if buf and not drop:
                yield [np.stack([row[i] for row in buf]) for i in range(len(buf[0]))]

        self._batch_gen = batches
        return self

    def set_sample_list_generator(self, reader, places=None):
        def batches():
            for sample_list in reader():
                yield [np.stack([row[i] for row in sample_list])
                       for i in range(len(sample_list[0]))]

        self._batch_gen = batches
        return self

    def set_batch_generator(self, reader, places=None):
        self._batch_gen = reader
        return self

    def __call__(self):
        return iter(self)

    def __iter__(self):
        if self._batch_gen is None:
            raise RuntimeError("from_generator loader has no data source: call "
                               "set_sample_generator / set_sample_list_generator / "
                               "set_batch_generator first")
        for batch in self._batch_gen():
            arrays = [np.asarray(a) for a in batch]
            if self.return_list:
                yield arrays
            else:
                names = [getattr(v, "name", f"feed_{i}") for i, v in enumerate(self.feed_list)]
                if len(names) != len(arrays):
                    raise ValueError(f"from_generator batch has {len(arrays)} arrays but "
                                     f"feed_list names {len(names)}: pass a matching "
                                     "feed_list, or return_list=True")
                yield dict(zip(names, arrays))
