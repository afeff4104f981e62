"""Captured CUDA graphs: the port's counterpart of a compiled XLA program.

The JAX package never runs a decode step op by op: ``llama_generate``
runs its loop inside one ``jax.jit`` and the decode engine compiles one
program per (phase, rows, seq) key. Here a function over tensors of fixed
shapes and addresses is captured once into a ``torch.cuda.CUDAGraph`` and
replayed: one host call launches every kernel of the step.

``Graph`` warms the function up on a side stream first (that run is real
work: the kernels' libraries are built and loaded, and K1 opts into its
shared memory, all host calls that a capture must not see), then captures
it. A capture that fails raises; nothing falls back to the eager run.

The kernels' launch counters (``ops/flash_attention.py``) are Python
integers, which a replay never reaches: each ``Graph`` takes back the
counts its capture's Python made (nothing ran), and credits them again at
every replay, so a count stays the number of kernels that ran.
"""
import time

import torch

from ..ops import flash_attention

_COUNTERS = ("launches", "dq_launches", "dkv_launches")


def _counts():
    return tuple(getattr(flash_attention, name) for name in _COUNTERS)


def _credit(counts):
    for name, n in zip(_COUNTERS, counts):
        setattr(flash_attention, name, getattr(flash_attention, name) + n)


class Graph:
    """``fn`` (no arguments; it reads and writes only tensors that outlive
    it, and builds no tensor from host data) run once on a side stream of
    ``device``, then captured. ``replay()`` reruns the captured kernels and
    returns what the captured call returned, in the same tensors every
    time. ``pool``: a ``torch.cuda.graph_pool_handle()`` to share with
    other graphs that never replay concurrently, or None for a pool of its
    own. ``launches``: the (K1, K2, K3) launches one replay makes;
    ``capture_ms``: host time of the capture and its instantiation."""

    def __init__(self, fn, device, pool=None):
        self.device = device
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = _counts()
            t0 = time.perf_counter()
            try:
                # thread_local: other threads (a server's handlers) may
                # touch the card while this one captures
                with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                    self.outputs = fn()
            finally:
                made = tuple(a - b for a, b in zip(_counts(), before))
                _credit(tuple(-n for n in made))
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.launches = made
        self.replays = 0

    def pool(self):
        return self.graph.pool()

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()
        self.replays += 1
        _credit(self.launches)
        return self.outputs


def pool_bytes(pool):
    """Bytes the caching allocator holds for the graph memory pool ``pool``
    (a ``graph_pool_handle()`` or ``Graph.pool()``): the sizes of its
    segments."""
    key = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == key)
