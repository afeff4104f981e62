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

The kernels' launch counters (``ops/flash_attention.py``,
``ops/quant_matmul.py``) are Python integers and dicts, which a replay never
reaches: each ``Graph`` takes back the counts its capture's Python made
(nothing ran), and credits them again at every replay, so a count stays
the number of kernels that ran.
"""
import time

import torch

from ..ops import flash_attention, quant_matmul

# (module, counter): K1, K2, K3, wq_matmul
_COUNTERS = ((flash_attention, "launches"), (flash_attention, "dq_launches"),
             (flash_attention, "dkv_launches"), (quant_matmul, "launches"))
# K1-K3's launches by form, and by form and mask
_FORMS = ("form_launches", "mask_launches")


def _counts():
    return (tuple(getattr(mod, name) for mod, name in _COUNTERS),
            tuple(dict(getattr(flash_attention, name)) for name in _FORMS))


def _credit(counts, sign=1):
    totals, forms = counts
    for (mod, name), n in zip(_COUNTERS, totals):
        setattr(mod, name, getattr(mod, name) + sign * n)
    for name, made in zip(_FORMS, forms):
        held = getattr(flash_attention, name)
        for key, n in made.items():
            held[key] = held.get(key, 0) + sign * n


class Graph:
    """``fn`` (no arguments; it reads and writes only tensors that outlive
    it, and builds no tensor from host data) run once on a side stream of
    ``device``, then captured. ``replay()`` reruns the captured kernels and
    returns what the captured call returned, in the same tensors every
    time. ``pool``: a ``torch.cuda.graph_pool_handle()`` to share with
    other graphs that never replay concurrently, or None for a pool of its
    own. ``launches``: the (K1, K2, K3, wq_matmul) launches one replay makes;
    ``form_launches``: K1-K3's of them by form, and by form and mask
    (``flash_attention.form_launches``, ``mask_launches``);
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
                (totals, forms), (totals0, forms0) = _counts(), before
                made = (tuple(a - b for a, b in zip(totals, totals0)),
                        tuple({k: n - f0.get(k, 0) for k, n in f.items() if n != f0.get(k, 0)}
                              for f, f0 in zip(forms, forms0)))
                _credit(made, sign=-1)
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.launches, self.form_launches = made
        self.replays = 0

    def pool(self):
        return self.graph.pool()

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()
        self.replays += 1
        _credit((self.launches, self.form_launches))
        return self.outputs


def pool_bytes(pool):
    """Bytes the caching allocator holds for the graph memory pool ``pool``
    (a ``graph_pool_handle()`` or ``Graph.pool()``): the sizes of its
    segments."""
    key = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == key)
