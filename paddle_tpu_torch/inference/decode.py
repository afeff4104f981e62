"""Continuous-batching autoregressive decode engine (counterpart of
paddle_tpu/inference/decode.py).

A request is a *sequence* that yields one token per model step until eos,
its token cap or the engine's length cap. One scheduler thread re-forms
the running batch every iteration, so sequences join the moment a slot
frees and leave the moment they finish::

    requests --> bounded queue --> scheduler iteration
                  (shed, purge)      |
                                     v
      each joiner: prefix lookup -> cached pages -> staging rows 0..k-1
                   FILL [1, C] per chunk from k -> staging rows k..P-1
                   staging rows 0..P-1 -> its slot; chain pages -> cache
      each resume: snapshot rows -> a free slot, at its exact position
                                     |
      every slot:  STEP [max_slots] -> one token per running sequence
               or, with an opted row: DRAFT_STEP [max_slots] until caught
                   up, then VERIFY [max_slots, k] -> 1..k tokens per row
                                     |       (kv snapshots at a cadence)
      retire on eos / max_new_tokens / max_seq_len / deadline / cancel

**KV on the device, a step row is a slot.** The reference keeps paged KV
in host numpy and gathers the active slots into a fresh ``[rows, seq_b,
...]`` batch every step. Here each ``kv_spec`` entry is one pool on the
engine's device, zero-filled, holding every slot's rows at once
(:class:`_KVSlots`; entries of one shape and dtype are views of one
stacked tensor, so a copy of a slot's rows is one copy a group, not one
an entry). Each step runs **all** ``max_slots`` rows (free slots are
padding rows: token 0, position 0), and row ``i`` writes its new KV at
``(i, positions[i])`` and attends over slot ``i`` in place. Nothing is
gathered or copied per step, and the step has one shape for the
engine's life.

**Bitwise contracts** (the reference's, decode.py:40-52, and its
prefix cache's): a sequence decoded inside a continuous batch emits
exactly the tokens it emits decoded alone in an engine of the same
configuration, under greedy decoding, across joins and leaves; a prompt
whose prefix is cached emits exactly its cold tokens; and a sequence
resumed from a kv snapshot emits exactly the unbroken stream's suffix.
What keeps them here is one rule: the M of every product a sequence
passes through is a constant of the engine or of the sequence's own
position, never of its neighbours or of the cache. A step always runs
``max_slots`` rows. A prompt's KV rows are made by the **chunked fill**:
chunk ``c`` of ``C`` tokens (``C`` = the page = ``min_seq_bucket``) runs
one program, key ``("fill", 1, c*C + C)``, at M = C, writing rows
``[c*C, c*C + C)`` of a static staging buffer and attending causally
over its first ``c*C + C`` rows. A cold prompt runs chunks 0, 1, ...
until row P-1 is covered; a hit at k cached tokens copies the k rows of
its pages into staging and runs the same chunks from k/C on. Every row
has one provenance on both paths, so hit = cold holds by construction
(cuBLAS picks its kernels per M on the card, so a prompt run at another
M, or a row fed through the step, would differ). Pages are published
from staging, never from a slot. The model's attention over a slot
reads only that slot's rows below its length (K1's per-row ``k_len``).
The first token comes from step-shaped maths: the last prompt token is
fed at position P-1 as the joiner's row of the next regular step (the
*finishing step*; it rewrites row P-1 in the slot only). The fill is
the engine's only prompt path: a prompt has no other program, so every
engine, cached or not, fills alike.

**Model contract** (:class:`DecodeModel`), torch functions on the
engine's device::

    fill_fn(params, tokens[1, C] int64, start, *staging, *feat) -> None
        the chunk of tokens at positions start..start+C-1 (``start`` a
        Python int fixed per program): writes their kv rows into every
        staging buffer ([1, ...] with max_prompt_len rows) at
        [start, start+C) IN PLACE, attending causally over rows
        0..start+C-1 of staging.
    step_fn(params, tokens[rows] int64, positions[rows] int32, *pools, *feat)
        -> logits[rows, vocab]
        rows == max_slots and row i is slot i. The step writes row i's
        new kv into every pool at (i, positions[i]) IN PLACE, then
        attends over keys 0..positions[i] of slot i.

A kv_spec entry is ``(trailing_shape, dtype)`` as in the reference; its
pool is ``[max_slots, *trailing]`` with the sequence axis of
``max_seq_len`` rows inserted at ``DecodeModel.kv_seq_axis`` (1 by
default, the reference's ``[rows, seq, *trailing]``; a Llama pool is
``[slots, kv_heads, seq, head_dim]``, axis 2). Padding rows must give
finite outputs; rows past a sequence's length hold stale values the
model must never read.

**Programs as CUDA graphs** (the reference's ``_Programs``, one AOT
program per ``(phase, rows, seq)`` key): ``("step", max_slots,
max_seq_len)`` for the engine's life, and ``("fill", 1, start + C)`` per
chunk start, each the model's function over static buffers that live as
long as the engine. On a card each is warmed up on a side stream and captured once
into a CUDA graph (core/cuda_graph.py), all in one memory pool; a call
is then a copy of its inputs into the buffers and one replay. ``warmup``
captures them all; otherwise each is captured at its first use. A CPU
engine, or a CUDA one built with ``cuda_graph=False``, runs the same
functions eagerly over the same buffers. A capture or replay that fails
raises and fails its requests retryable; nothing runs eagerly in its
place.

**KV reuse and resume.** The prefix cache (inference/prefix_cache.py,
on by default) keeps chain-hashed prefixes
as refcounted pages of ``C`` rows in a device page store
(:class:`_PageStore`, the counterpart of ``_KVSlots``' page methods). A
slot never holds a page by reference: an install copies pages into
staging, so no slot write can reach a cached page and the reference's
copy-on-write barrier has no counterpart. ``submit(snapshot_every=N)``
emits a kv-snapshot block (``wire_spec.encode_kv_snapshot``, the
reference's bytes) every N generated tokens and, at N = 1, at the first
token even if the sequence retires there (the prefill handoff). Under
the exec lock the scheduler only queues a device copy of the slot's
first ``pos`` rows, behind the step that wrote them, in the reference's
``[pos, *trailing]`` layout, bf16 widened to f32 (exact; the wire has no
bf16). The consumer's thread brings it to the host on a stream of its
own and builds the block when it first asks
(``DecodeRequest.take_snapshot``), so a snapshot never stalls the other
slots' steps. ``resume`` checks a block against this replica's
identity (``check_snapshot``: a skew raises :class:`SnapshotRefused`,
wire status 2) and joins the sequence at its exact position with its
last token as the next step's row.

**Speculative decoding** (the reference's, decode.py :128-138).
``DecodeModel.draft`` is a cheaper model over the same vocab and
features (its kv_spec and depth are free); with ``spec_k`` = k >= 2 a
request that opts in (``speculative=True``, wire 0x5C bit 61) takes
bursts. The draft has its own pools (draft row i belongs to slot i, so
it needs no allocator), its own staging and its own programs:
``("draft_fill", 1, start + C)``, its chunked fill of a sequence's
prompt rows 0..P-2 at its first burst, and ``("draft_step", max_slots,
max_seq_len)``. A burst holds the exec lock from the draft's first
program to the verify's last copy: draft steps catch every opted row up
to ``pos + k - 2`` (the draft's own finishing step re-feeds the last
prompt token at P-1, as the target's does, so a draft with the target's
functions computes exactly the target's rows), their argmaxes from
``pos`` on being the proposals; then ONE ``("verify", max_slots,
max_seq_len)`` program runs k unrolled ``step_fn`` calls over the
target's pools, call i feeding column i of ``tokens [max_slots, k]`` at
``positions [max_slots, k]`` and writing in place as the step does. Every
call has the step's M, so call i is bitwise a plain step. An opted row
feeds ``[last_token, d_1..d_{k-1}]`` at ``pos..pos+k-1``; every other
running row repeats ``(last_token, pos)`` in all k columns (the rewrite
is idempotent) and takes column 0's token, so one replay covers every
slot; free slots are padding. The accept loop emits an opted row's
tokens up to and including the first that differs from its proposal:
exactly plain greedy's. Rollback is by pointer: rejected entries sit
past ``pos`` in the target's pool and past ``draft_pos`` in the draft's,
and each row writes its position before it attends, so they are
overwritten before they can be read. In a draft step a row that is not
catching up repeats its last draft feed ``(token, draft_pos - 1)``, so
it keeps its draft rows; a row without draft state feeds token 0 at
position 0. A draft or verify that its breaker refuses, or that raises,
makes the iteration a plain step: draft trouble costs speed, never a
request.

**Robustness kept**: the bounded queue (:class:`EngineOverloaded`),
per-token deadlines (the wire budget bounds the time to the first token
and every gap after it; a blown budget fails retryable and frees the slot
at once), cancellation between iterations, a failed fill, restore or
step failing its requests retryable with their slots freed, and a
circuit breaker per program key (``batching._Breaker``: open after
``breaker_threshold`` consecutive failures, one probe after
``breaker_cooldown`` s): a quarantined fill or step sheds its requests
with :class:`BucketQuarantined` (retryable, wire status 2), a
quarantined draft or verify falls back to the plain step. There is no
device fallback: a CUDA engine whose kernel fails to build or launch
fails the requests in flight, and never drops to the CPU or a plain
version.

**Watchdog and restarts** (the reference's, decode.py :2867-2940). The
scheduler bumps a heartbeat every iteration; a watchdog thread (every
``watchdog_interval`` s; 0 turns it off, and a scheduler that dies then
restarts itself) restarts a scheduler that died, or wedged (its heartbeat
and the oldest waiting or running request both older than
``wedge_timeout``). A restart bumps the scheduler generation, fails the
sequences in flight (running, joining, resuming) with
:class:`SchedulerRestarted` (retryable) and frees their slots, and starts
a replacement thread (on the engine's card) that serves the queue with
the programs already built: nothing is captured again. Slots never hold
pages by reference (an install copies them), so the sweep frees slots
only and the prefix cache keeps its pages. A superseded thread ends at
its next device call: every program call checks the generation under
the exec lock before it touches a graph's buffers, a pool row or the
staging, and unwinds (:class:`_Superseded`) instead; every state change
after a call checks it under the engine lock and is dropped. A program
that fails stays its breaker's business (a CUDA error is not a scheduler
death). The chaos sites (resilience/chaos.py) are
``serving.decode.admit`` (submit), ``.resume``, ``.loop`` (each
iteration with work), ``.prefill`` (before each fill chunk), ``.step``
(before a step), ``.snapshot`` (before a snapshot's copy; a failed
snapshot costs the snapshot, never the stream) and ``.compile`` (before
a program's capture); ``.prefill`` and ``.step`` are hit outside the
exec lock, so a wedge there blocks no replacement.

**Telemetry**: the reference's instruments (``_init_metrics``: the
``paddle_decode_*``, ``paddle_prefix_*`` and ``paddle_spec_*`` families,
their labels and buckets, const label ``engine=<name>``), exposed by a
collector in ``obs.metrics.REGISTRY`` until ``close``. Their ``phase``
label values are the port's program phases (``fill``, ``step``,
``verify``, ``draft_fill``, ``draft_step``); a build (a capture on a card)
is an ``inline`` compile. ``paddle_decode_step_seconds`` times each
program's run on a card by CUDA events (the device's work; the CPU's
host clock), and ``stats()``'s ``step_ms_median`` the host's whole
call. TTFT and inter-token gaps are
stamped at emit. A traced request
(``trace_id``, wire 0x1D) gets one ``serving.decode.token`` span per
token and a ``serving.decode.request`` span under its id.

**Quantized serving** (the reference's, decode.py :1061-1095):
``DecodeEngine(quant="w8" | "bf16w")`` serves an f32 model through
``quantization.quantize_decode_model``; a model that
already carries a mode must match, and a draft without a mode of its own
follows the target's. The mode is the ``quant`` const label, the
``stats()["quant"]`` and the snapshot header's ``quant``; it changes the
model's fingerprint and its weights digest (taken over the reduced
params). Llama's programs run every product through the dequantizing
kernel (ops/quant_matmul.py), one M per program as before, so solo =
batch and hit = cold hold per mode.

**Phase** (the reference's, decode.py :1128-1140): ``phase`` ("prefill",
"decode" or "both", the default) is the engine's pool in a
disaggregated fleet, a placement attribute reported in ``health`` and
``stats`` for the router (inference/registry.py). It shapes ``warmup``
as the reference's shapes its ladder: a "decode" engine's prompt rungs
are the smallest only (one fill, the chunk ending at C: its sequences
arrive as snapshots that paid their fill elsewhere), and a "prefill"
engine's step rungs reach the prompt bucket (the port has one step
program, at ``max_seq_len``, which does). Every phase still serves
every request kind, so a fleet whose other pool is gone degrades to
colocated serving on it; a rung not warmed is built at its first use.
The name is the reference's twice over: the program keys' first field
(``fill``, ``step``, ``verify``, ...) and the metrics' ``phase`` label
are the programs' phases, and ``self.phase`` is the engine's pool.

**The persistent prefix tier** (``prefix_dir``, the reference's
``PADDLE_TPU_PREFIX_DIR``; inference/prefix_cache.py): a prompt that
misses the memory tier looks its chain up in the store (file IO, on the
scheduler without the exec lock); a block that passes the identity
check becomes pages, is inserted as a memory entry and is installed
into staging like a memory hit, so hit = cold holds for it too. A fill
publishes its longest boundary once: under the exec lock the staging
rows are copied on the device (bf16 widened to f32, exactly), and the
block is brought to the host, encoded and written after it.

**Meshed serving** (the reference's, decode.py :295-307): ``mesh="tp2"``
(or any serving mesh, inference/sharding.py) splits the model's weights
once, at construction, into ``ShardedWeight``s over ``mesh_devices``;
the fill and the step run every product per shard through ``wmatmul``
and read an embedding's rows from the blocks, so the programs keep their
shapes and are captured as before. The mesh is the ``mesh`` const label,
``stats()["mesh"]`` and the snapshot header's ``mesh``: a snapshot taken
under one mesh is refused by an engine on another. Each program's build
is a compile-ledger event (obs/ledger.py), ``decode/{phase}{rows}x{seq}``.

Not ported: the engines' artifact store of compiled programs (``store``
raises ``NotImplementedError``: the port's programs are CUDA graphs,
which have no serialized form across processes; ROADMAP Queue 3 (b)). The
reference's engine decodes greedily, as this one does. The port reads no
environment: ``quant`` defaults to f32 (the reference's
``PADDLE_TPU_SERVING_QUANT`` is not read), ``phase`` to "both" (its
``PADDLE_TPU_DECODE_PHASE``), ``prefix_dir`` to none (its
``PADDLE_TPU_PREFIX_DIR``), and ``spec_k``, ``breaker_threshold``,
``breaker_cooldown``, ``watchdog_interval`` and ``wedge_timeout`` default
to 0 (off), 3, 5.0 s, 0.5 s and 30.0 s, the reference's environment
defaults.
"""
import collections
import concurrent.futures
import functools
import hashlib
import json
import threading
import time
import traceback
import weakref

import numpy as np
import torch

from ..core.cuda_graph import Graph, pool_bytes
from ..core.place import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from ..obs.ledger import LEDGER
from ..ops import flash_attention
from ..resilience import chaos
from . import sharding, wire_spec
from .batching import (BucketQuarantined, DeadlineExceeded, EngineClosed, EngineOverloaded,
                       RetryableError, SchedulerRestarted, _Breaker)
from .prefix_cache import PrefixCache, feature_seed, prefix_hashes

# prompt / token dtypes of the wire spec (codes 1 and 2): streamed chunks
# echo the prompt's dtype
_TOKEN_DTYPES = (np.dtype(np.int32), np.dtype(np.int64))

_RETIRE_REASONS = ("eos", "max_tokens", "max_seq_len", "deadline", "error", "cancelled")

# options of the reference's engine that are not ported, and the values
# that ask for nothing (the reference's "off")
_UNPORTED = {"store": (None,)}
_UNPORTED_WHY = {
    "store": "the engines' artifact store keeps compiled programs, and the port's programs "
             "are CUDA graphs, which have no serialized form across processes; the store's "
             "user in the port is the persistent prefix tier (prefix_dir) (ROADMAP Queue 3 (b))",
}


class _Superseded(BaseException):
    """Raised in a scheduler thread whose generation a restart ended, at
    its next program call: it unwinds past every ``except Exception`` to
    ``_run_scheduler``, touching nothing on the way."""


class SnapshotRefused(RetryableError):
    """A kv snapshot does not match this replica's identity (fingerprint,
    weights, quant, mesh or shape contract) or cannot fit its limits. Wire
    status 2: the stream is resumable on a matching replica; refusing is
    always preferable to decoding from a foreign KV layout."""


def _indexed(device):
    """``device`` with its card's index ("cuda" -> "cuda:<current>")."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _torch_dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


def _dtype_name(dt):
    """numpy's spelling of a torch dtype ("float32", "bfloat16")."""
    return str(dt).replace("torch.", "")


def _wire_dtype(dt):
    """The numpy dtype a kv buffer of torch dtype ``dt`` travels as in a
    snapshot: f16/bf16 widened to f32 (exact; the wire has no bf16)."""
    if dt in (torch.float16, torch.bfloat16):
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dt).numpy().dtype


def _named_params(params):
    """(name, tensor) of a model's params in their order: a list or tuple
    (by index), a dict, or an object with ``named_tensors()``."""
    if isinstance(params, (list, tuple)):
        return [(str(i), p) for i, p in enumerate(params)]
    if isinstance(params, dict):
        return list(params.items())
    return list(params.named_tensors())


class DecodeModel:
    """The fill and step functions of a model, their parameters and the
    shape contract (module docstring). The reference's one-shot
    ``prefill_fn`` has no counterpart: the fixed-shape ``fill_fn`` is the
    port's prompt program.

    ``kv_spec``: ``(trailing_shape, dtype)`` per KV buffer (a torch or
    numpy dtype); ``kv_seq_axis``: where the sequence axis sits in the
    pool ``[slots, ...]``. ``feature_spec``: ``(trailing_shape, numpy
    dtype)`` per per-sequence feature array (any wire dtype). ``device``:
    where ``params`` live, the card unless the caller asks for the CPU (it
    raises without a card); the engine runs there. ``max_slots`` and
    ``max_seq_len``: the engine shape the functions were built for, if
    they fix one (an engine given none takes them). ``draft``: an
    optional companion DecodeModel for speculative decoding, over the
    same vocab and feature_spec (its kv_spec, kv_seq_axis and depth may
    differ), with its own ``fill_fn``/``step_fn`` on the same device;
    greedy output stays bitwise that of decoding without it. ``quant``:
    the serving quantization mode the params and functions were built
    under (``quantization.quantize_decode_model`` sets it; None = f32)."""

    def __init__(self, params, fill_fn, step_fn, kv_spec, vocab_size, feature_spec=(),
                 eos_token_id=None, kv_seq_axis=1, device="cuda", max_slots=None,
                 max_seq_len=None, draft=None, quant=None):
        self.params = params
        self.fill_fn = fill_fn
        self.step_fn = step_fn
        self.kv_spec = tuple((tuple(int(d) for d in tr), _torch_dtype(dt))
                             for tr, dt in kv_spec)
        self.feature_spec = tuple((tuple(int(d) for d in tr), np.dtype(dt))
                                  for tr, dt in feature_spec)
        self.vocab_size = int(vocab_size)
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)
        self.kv_seq_axis = int(kv_seq_axis)
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.draft = draft
        self.quant = quant
        self._digest = None  # (weights digest, ms), computed once
        self._digest_lock = threading.Lock()

    def weights_digest(self):
        """-> (hex digest, ms it took): the reference's recipe
        (``_Programs._weights_digest``), sha256 over every param's dtype
        string, shape string and bytes, in param order (bf16 as its raw
        2-byte words), so equal weights give the JAX engine's digest; a
        quantized model's over its reduced params in the reference's
        flat order.
        Computed once per model: a 7B model copies its 13.5 GB to the host
        for it, which is why an engine's ``warmup`` takes it. The next
        param's copy to the host runs on a thread while this one hashes
        (both release the GIL), so the digest costs about the hashing."""
        def host(p):
            # a serving mesh's ShardedWeight: the whole weight's bits
            t = (p.joined() if hasattr(p, "joined") else p).detach().contiguous()
            head = _dtype_name(t.dtype).encode(), str(tuple(t.shape)).encode()
            if t.dtype in (torch.bfloat16, torch.float16):
                t = t.view(torch.int16)
            return head, t.cpu().numpy()

        with self._digest_lock:
            if self._digest is None:
                t0 = time.perf_counter()
                h = hashlib.sha256()
                params = [p for _, p in _named_params(self.params)]
                with concurrent.futures.ThreadPoolExecutor(1) as copier:
                    nxt = copier.submit(host, params[0]) if params else None
                    for i in range(len(params)):
                        head, data = nxt.result()
                        if i + 1 < len(params):
                            nxt = copier.submit(host, params[i + 1])
                        for part in (*head, data):
                            h.update(part)
                self._digest = (h.hexdigest(), (time.perf_counter() - t0) * 1e3)
            return self._digest

    def fingerprint(self, page_len):
        """The model's program identity for snapshot headers: sha256 of a
        canonical description (the params' class and the functions'
        names, kv_spec, feature_spec, vocab, kv_seq_axis, the param names,
        shapes and dtypes, the quant mode, and the engine's chunk
        ``page_len``). The
        reference hashes its step program's exported module instead; the
        port has no such module, and two engines of one description run
        the same torch code, so this names the same thing. Weight values
        are the weights digest's business."""
        fns = [getattr(f, "__qualname__", type(f).__name__)
               for f in (self.fill_fn, self.step_fn)]
        desc = {
            "model": type(self.params).__qualname__, "functions": fns,
            "kv_spec": [[list(tr), _dtype_name(dt)] for tr, dt in self.kv_spec],
            "feature_spec": [[list(tr), str(dt)] for tr, dt in self.feature_spec],
            "vocab": self.vocab_size, "kv_seq_axis": self.kv_seq_axis,
            "params": [[n, list(p.shape), _dtype_name(p.dtype)]
                       for n, p in _named_params(self.params)],
            "page_len": int(page_len),
        }
        if self.quant is not None:
            desc["quant"] = self.quant
        return hashlib.sha256(json.dumps(desc, sort_keys=True).encode()).hexdigest()


class _KVStack:
    """One buffer per kv_spec entry, ``[batch, *trailing]`` with ``rows``
    at the sequence axis (``ax`` + 1), entries of one (trailing, dtype)
    stacked into one tensor ``[n, batch, ...]``: ``views[i]`` is entry
    i's buffer, ``groups`` the (entry indices, stacked tensor) pairs a
    copy runs over. Zero-filled once."""

    def __init__(self, kv_spec, ax, batch, rows, device):
        self.ax = ax
        self.views = [None] * len(kv_spec)
        self.groups = []
        by_spec = {}
        for i, spec in enumerate(kv_spec):
            by_spec.setdefault(spec, []).append(i)
        for (tr, dt), idx in by_spec.items():
            if not 0 <= ax <= len(tr):
                raise ValueError(f"kv_seq_axis {ax + 1} does not fit a kv buffer of "
                                 f"trailing shape {tr}")
            shape = list(tr)
            shape.insert(ax, rows)
            stacked = torch.zeros([len(idx), batch] + shape, dtype=dt, device=device)
            self.groups.append((idx, stacked))
            for j, i in enumerate(idx):
                self.views[i] = stacked[j]

    def rows(self, b, start, n):
        """Per group: rows start..start+n-1 of batch row ``b``, a view
        ``[n_entries, *trailing with n rows]``."""
        return [t[:, b].narrow(self.ax + 1, start, n) for _, t in self.groups]

    def nbytes(self):
        return sum(t.numel() * t.element_size() for _, t in self.groups)

    def snapshot(self, b, length, device, n_entries):
        """Copy rows 0..length-1 of batch row ``b``, on the device, into
        the reference's snapshot layout ``[length, *trailing]`` per
        kv_spec entry and its wire dtype (bf16 widened to f32, exactly):
        one copy kernel a group, queued on the current stream behind the
        writes before it, so the caller waits for nothing and allocates no
        host memory. -> ``arrays()``, which brings the copies to the host
        on a stream of its own (later work does not queue behind it) and
        gives one numpy array per kv_spec entry, on the thread that calls
        it."""
        outs = []
        for rows in self.rows(b, 0, length):
            rows = rows.movedim(self.ax + 1, 1)  # [n_entries, length, *trailing]
            wire = torch.float32 if rows.dtype in (torch.float16, torch.bfloat16) else rows.dtype
            out = torch.empty(rows.shape, dtype=wire, device=rows.device)
            out.copy_(rows)
            outs.append(out)
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()

        def arrays():
            hosts = outs
            if done is not None:
                side = torch.cuda.Stream(device=device)
                side.wait_event(done)
                with torch.cuda.stream(side):
                    hosts = [o.cpu() for o in outs]
            out = [None] * n_entries
            for (idx, _), host in zip(self.groups, hosts):
                rows = host.numpy()
                for j, i in enumerate(idx):
                    out[i] = rows[j]
            return out

        return arrays


class _KVSlots:
    """Per-slot KV storage on the device: one pool per kv_spec entry,
    ``[max_slots, *trailing]`` with ``max_seq_len`` rows at the sequence
    axis (a :class:`_KVStack`). A slot is a row of every pool; the step
    writes and reads the pools in place, so ``pools`` are handed to the
    model as they are. Rows past a sequence's length are never read (the
    model masks them), so a released slot is not cleared. Slot rows are
    written only under the engine's exec lock (fill copy, restore,
    step)."""

    def __init__(self, max_slots, max_seq_len, kv_spec, seq_axis, device):
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.kv_spec = kv_spec
        self.ax = int(seq_axis) - 1
        self.device = device
        self._stack = _KVStack(kv_spec, self.ax, self.max_slots, self.max_seq_len, device)
        self.pools = self._stack.views
        self._free = list(range(self.max_slots - 1, -1, -1))

    def free_count(self):
        return len(self._free)

    def nbytes(self):
        return self._stack.nbytes()

    def alloc(self):
        return self._free.pop() if self._free else None

    def release(self, slot):
        self._free.append(slot)

    def copy_from(self, slot, staging, length):
        """Rows 0..length-1 of ``staging`` (a batch-1 :class:`_KVStack`
        of the same kv_spec) into ``slot``: one copy a group."""
        for dst, src in zip(self._stack.rows(slot, 0, length), staging.rows(0, 0, length)):
            dst.copy_(src)

    def snapshot(self, slot, length):
        """Copy the slot's first ``length`` rows, on the device, into the
        reference's ``_KVSlots.snapshot`` layout (``_KVStack.snapshot``).
        The slot stays live and may be reused at once: later writes queue
        behind the copies."""
        return self._stack.snapshot(slot, length, self.device, len(self.kv_spec))

    def restore(self, slot, kv_arrays, length):
        """Install a snapshot's first ``length`` rows (host arrays
        ``[>= length, *trailing]``, one per kv_spec entry) into ``slot``:
        the reference's ``restore``, as one device copy a group."""
        for (idx, t), dst in zip(self._stack.groups, self._stack.rows(slot, 0, length)):
            host = np.stack([np.asarray(kv_arrays[i])[:length] for i in idx])
            src = torch.from_numpy(host).to(device=t.device, dtype=t.dtype)
            dst.copy_(src.movedim(1, self.ax + 1))


class _PageStore:
    """Refcounted pages of ``page_len`` rows per kv_spec entry on the
    engine's device, in the pool's layout (a Llama page is ``[kv_heads,
    page_len, head_dim]``), stacked per group like the pools:
    ``[n_entries, capacity, *page]``. The counterpart of ``_KVSlots``'
    page methods in the reference (``page_bytes``, ``_page_alloc``,
    ``_page_reclaim``, ``retain_page``, ``drop_page``, ``shared_pages``,
    ``live_pages``). Only the prefix cache holds pages (slots copy
    them), so a page is shared when two chain entries hold it. The
    capacity doubles on demand. Used under the engine's exec lock; the
    live and shared counts are plain ints, so ``stats`` reads them from
    any thread without walking the refcount map."""

    def __init__(self, kv_spec, seq_axis, page_len, device):
        self.kv_spec = kv_spec
        self.ax = int(seq_axis) - 1
        self.page_len = int(page_len)
        self.device = device
        self._store = _KVStack(kv_spec, self.ax, 0, self.page_len, device)
        self._rows = {}  # page id -> its row of the store
        self._rc = {}    # page id -> refcount
        self._spare = []  # store rows free for reuse
        self._next_pid = 0
        self._live = 0    # pages with a refcount
        self._shared = 0  # pages with a refcount above 1

    def page_bytes(self):
        """Bytes of ONE page across every kv buffer (what the prefix cache
        budgets with)."""
        return sum(self.page_len * int(np.prod(tr)) * dt.itemsize for tr, dt in self.kv_spec)

    def capacity(self):
        return self._store.groups[0][1].shape[1] if self._store.groups else 0

    def _grow(self):
        cap = self.capacity()
        new = max(8, 2 * cap)
        groups = []
        for idx, t in self._store.groups:
            bigger = torch.zeros((t.shape[0], new) + tuple(t.shape[2:]), dtype=t.dtype,
                                 device=t.device)
            bigger[:, :cap] = t
            groups.append((idx, bigger))
        self._store.groups = groups
        self._spare.extend(range(new - 1, cap - 1, -1))

    def _page_alloc(self):
        if not self._spare:
            self._grow()
        pid = self._next_pid
        self._next_pid += 1
        self._rows[pid] = self._spare.pop()
        self._rc[pid] = 1
        self._live += 1
        return pid

    def _page_reclaim(self, pid):
        self._spare.append(self._rows.pop(pid))
        del self._rc[pid]
        self._live -= 1

    def retain_page(self, pid):
        self._rc[pid] += 1
        if self._rc[pid] == 2:
            self._shared += 1

    def drop_page(self, pid):
        rc = self._rc[pid] - 1
        if rc == 1:
            self._shared -= 1
        if rc:
            self._rc[pid] = rc
        else:
            self._page_reclaim(pid)

    def shared_pages(self):
        """Pages held by more than one owner (cache entries)."""
        return self._shared

    def live_pages(self):
        return self._live

    def _index(self, pages):
        return torch.tensor([self._rows[p] for p in pages], dtype=torch.long,
                            device=self.device)

    def install(self, pages, staging):
        """Copy ``pages`` into rows 0..len(pages)*page_len-1 of
        ``staging`` (a batch-1 :class:`_KVStack`): one gather a group."""
        n, ax = len(pages), self.ax
        index = self._index(pages)
        for (_, t), dst in zip(self._store.groups, staging.rows(0, 0, n * self.page_len)):
            src = t.index_select(1, index).movedim(1, ax + 1)  # [n_g, ..., n, page, ...]
            dst.copy_(src.reshape(dst.shape))

    def publish(self, staging, first, n):
        """``n`` fresh pages (refcount 1, the caller's) holding rows
        ``[first*page_len, (first+n)*page_len)`` of ``staging``; -> ids."""
        return self._write(n, staging.rows(0, first * self.page_len, n * self.page_len))

    def pages_from_arrays(self, kv_arrays, length):
        """Fresh pages (refcount 1, the caller's) holding the first
        ``length`` rows of host arrays in the snapshot layout ``[>= length,
        *trailing]``, one per kv_spec entry, in their wire dtype (the
        persistent prefix tier's blocks); ``length`` a multiple of the
        page. -> ids."""
        srcs = []
        for idx, t in self._store.groups:
            host = np.stack([np.asarray(kv_arrays[i])[:length] for i in idx])
            src = torch.from_numpy(host).to(device=t.device, dtype=t.dtype)
            srcs.append(src.movedim(1, self.ax + 1))
        return self._write(length // self.page_len, srcs)

    def _write(self, n, srcs):
        """``n`` fresh pages holding ``srcs``, per group a tensor of
        ``n * page_len`` rows at the pool's sequence axis; -> ids."""
        pages = [self._page_alloc() for _ in range(n)]
        index = self._index(pages)
        ax, pl = self.ax, self.page_len
        for (_, t), src in zip(self._store.groups, srcs):
            shape = list(src.shape)
            shape[ax + 1:ax + 2] = [n, pl]
            t.index_copy_(1, index, src.reshape(shape).movedim(ax + 1, 1))
        return pages


class _Graphs:
    """The programs of one model (the reference's ``_Programs``), keyed
    ``(phase, rows, seq)``; a draft's phases carry the ``draft_`` prefix.
    ``inputs(key)`` gives a program's static input buffers (made once, on
    the engine's device) and ``build(key)`` its ``run()``, the model's
    function over them. A step's run returns the argmax ``int32 [rows]``
    and the verify's ``int32 [rows, spec_k]`` in a static buffer; a
    fill's writes its rows into ``staging`` and returns None. With a
    graph memory ``pool`` (the engine's, shared by all its programs, the
    draft's too: they never replay concurrently) each build is a CUDA
    graph, warmed up and captured in it (``run`` replays it); with None,
    ``run`` is the function itself."""

    def __init__(self, model, pools, device, pool, staging, page_len, spec_k=0):
        self._model = model
        self._pools = pools
        self._staging = staging
        self._page_len = page_len
        self._spec_k = spec_k
        self.device = device
        self.pool = pool
        self.capture = pool is not None
        self.pool_bytes = 0
        self.capture_ms = {}  # key -> ms
        self.graphs = []
        self._inputs = {}

    def inputs(self, key):
        """(tokens int64, positions int32 or None, [feature rows]) of
        ``key``: the step's tokens and positions ``[rows]``, the verify's
        ``[rows, spec_k]`` (column i is call i's), a fill's tokens ``[1,
        C]``."""
        bufs = self._inputs.get(key)
        if bufs is None:
            phase, rows, _ = key
            phase = phase.replace("draft_", "")
            dev = self.device
            width = {"step": (), "verify": (self._spec_k,), "fill": (self._page_len,)}[phase]
            tokens = torch.zeros((rows,) + width, dtype=torch.int64, device=dev)
            at = (None if phase == "fill"
                  else torch.zeros((rows,) + width, dtype=torch.int32, device=dev))
            feats = [torch.zeros((rows,) + tr, dtype=_torch_dtype(dt), device=dev)
                     for tr, dt in self._model.feature_spec]
            bufs = self._inputs[key] = (tokens, at, feats)
        return bufs

    def build(self, key):
        m = self._model
        tokens, at, feats = self.inputs(key)
        phase = key[0].replace("draft_", "")
        if phase == "step":
            nxt = torch.zeros(key[1], dtype=torch.int32, device=self.device)

            def fn():
                logits = m.step_fn(m.params, tokens, at, *self._pools, *feats)
                # greedy on the device (the first maximum, as np.argmax):
                # only [rows] int32 comes back
                nxt.copy_(torch.argmax(logits.float(), dim=-1))
                return nxt
        elif phase == "verify":
            nxt = torch.zeros((key[1], self._spec_k), dtype=torch.int32, device=self.device)

            def fn():
                # the reference's _verify_fn: k unrolled step_fn calls, each
                # over the kv the earlier ones wrote in place, each on
                # contiguous [rows] inputs like the step's
                for i in range(self._spec_k):
                    logits = m.step_fn(m.params, tokens[:, i].contiguous(),
                                       at[:, i].contiguous(), *self._pools, *feats)
                    nxt[:, i].copy_(torch.argmax(logits.float(), dim=-1))
                return nxt
        else:
            start = key[2] - self._page_len

            def fn():
                m.fill_fn(m.params, tokens, start, *self._staging.views, *feats)
        if not self.capture:
            return fn
        graph = Graph(fn, self.device, self.pool)
        self.graphs.append(graph)
        self.capture_ms[key] = graph.capture_ms
        self.pool_bytes = pool_bytes(self.pool)
        return graph.replay


class DecodeRequest:
    """One streaming decode request: a thread-safe token sink the engine
    pushes into and a consumer (the server handler, or a ``result``
    caller) drains.

    - ``next_tokens(timeout)`` -> ``(tokens, done)``: blocks for new
      tokens and delivers whatever arrived since the last call; once the
      terminal error is all that is left, it raises it (delivered tokens
      always come out first).
    - ``result(timeout)`` -> the whole token array (raises on error).
    - ``cancel()``: abandon; the engine frees the slot before its next
      step.
    - ``take_snapshot()`` / ``latest_snapshot()``: the newest kv-snapshot
      block of a request with a ``snapshot_every`` cadence.
    """

    __slots__ = ("prompt", "features", "max_new_tokens", "eos_token_id", "token_budget_s",
                 "trace_id", "token_dtype", "t_enqueue", "peak_batch", "snapshot_every",
                 "speculative", "_cond", "_tokens", "_taken", "_done", "_error", "_snap",
                 "_snap_fresh", "finish_reason", "cancelled")

    def __init__(self, prompt, features, max_new_tokens, eos_token_id, token_budget_s,
                 trace_id, token_dtype):
        self.prompt = prompt
        self.features = features
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.token_budget_s = token_budget_s
        self.trace_id = trace_id
        self.token_dtype = token_dtype
        self.t_enqueue = time.monotonic()
        self.peak_batch = 0  # the most running sequences of any step it was in
        self.snapshot_every = 0
        self.speculative = False
        self._cond = threading.Condition()
        self._tokens = []
        self._taken = 0
        self._done = False
        self._error = None
        self._snap = None
        self._snap_fresh = False
        self.finish_reason = None
        self.cancelled = False

    # ------------------------------------------------------- engine side
    def _push(self, token):
        with self._cond:
            if self._done:
                return
            self._tokens.append(token)
            self._cond.notify_all()

    def _finish(self, reason):
        with self._cond:
            if not self._done:
                self._done = True
                self.finish_reason = reason
                self._cond.notify_all()

    def _fail(self, error):
        with self._cond:
            if not self._done:
                self._done = True
                self._error = error
                self.finish_reason = "error"
                self._cond.notify_all()

    def _push_snapshot(self, snap):
        """Keep ``snap`` (a :class:`_Snapshot`) as the newest kv snapshot
        (only the newest is kept: a resume restarts from the latest
        position)."""
        with self._cond:
            if self._done:
                return
            self._snap = snap
            self._snap_fresh = True
            self._cond.notify_all()

    # ----------------------------------------------------- consumer side
    def cancel(self):
        """Abandon the request: tokens stop and the engine frees the slot
        at its next iteration (or drops the request from the queue)."""
        with self._cond:
            self.cancelled = True
            if not self._done:
                self._done = True
                self.finish_reason = "cancelled"
                self._cond.notify_all()

    def next_tokens(self, timeout=None):
        """-> (new tokens, done). Raises the terminal error once every
        delivered token is consumed; TimeoutError if nothing happens
        within ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._taken < len(self._tokens):
                    out = self._tokens[self._taken:]
                    self._taken = len(self._tokens)
                    return out, self._done and self._error is None
                if self._done:
                    if self._error is not None:
                        raise self._error
                    return [], True
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError("no decode progress within timeout")
                self._cond.wait(left)

    def result(self, timeout=None):
        """Block until the sequence finishes; -> 1-D token array in the
        prompt's dtype."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._done:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError("decode did not finish in time")
                self._cond.wait(left)
            if self._error is not None:
                raise self._error
            return np.asarray(self._tokens, dtype=self.token_dtype)

    def tokens_so_far(self):
        with self._cond:
            return list(self._tokens)

    def take_snapshot(self):
        """-> ``(block, n_generated)`` for the newest kv-snapshot not yet
        taken, or None (take-once: the server forwards each block once
        its tokens are on the wire, so ``n_generated`` rides along). The
        block is built here, on the caller's thread."""
        with self._cond:
            if not self._snap_fresh:
                return None
            self._snap_fresh = False
            snap = self._snap
        return snap.block(), snap.n_generated

    def latest_snapshot(self):
        """-> the newest kv-snapshot block (without taking it), or None;
        built on the caller's thread at its first request."""
        with self._cond:
            snap = self._snap
        return None if snap is None else snap.block()


class _Snapshot:
    """One kv snapshot of a running sequence: its rows copied on the
    device (``_KVSlots.snapshot``'s ``arrays`` brings them over) and the
    header's state. ``block()`` builds the wire block once, on the first
    consumer thread that asks (``build(arrays, pos, last_token,
    n_generated)``), and drops the copy; the scheduler never builds
    one."""

    __slots__ = ("_build", "_arrays", "pos", "last_token", "n_generated", "_block", "_lock")

    def __init__(self, build, arrays, pos, last_token, n_generated):
        self._build = build
        self._arrays = arrays
        self.pos = int(pos)
        self.last_token = int(last_token)
        self.n_generated = int(n_generated)
        self._block = None
        self._lock = threading.Lock()

    def block(self):
        with self._lock:
            if self._block is None:
                self._block = self._build(self._arrays, self.pos, self.last_token,
                                          self.n_generated)
                self._arrays = None
            return self._block


class _Seq:
    """One running sequence: its request, slot, and the token the next
    step feeds at ``pos`` (= the KV rows cached). A joiner starts at
    ``pos`` = P-1 with its last prompt token (the finishing step) and
    nothing generated; a resumed one at its snapshot's position, last
    token and count. ``draft_pos``: the draft's rows cached in draft row
    ``slot`` (the reference's ``draft_pos``), None until the sequence's
    first speculative burst fills them; rows below it were fed the
    sequence's real tokens. Draft row i is slot i's, so releasing the
    slot releases it: the reference's ``_release_seq`` has no draft part
    here."""

    __slots__ = ("req", "slot", "pos", "last_token", "n_generated", "t_last", "draft_pos")

    def __init__(self, req, slot, state=None, now=None):
        self.req = req
        self.slot = slot
        if state is None:
            self.pos = req.prompt.size - 1
            self.last_token = int(req.prompt[-1])
            self.n_generated = 0
            # the first token's budget runs from the enqueue
            self.t_last = req.t_enqueue
        else:
            self.pos = state["pos"]
            self.last_token = state["last_token"]
            self.n_generated = state["n_generated"]
            self.t_last = now
        self.draft_pos = None


class DecodeEngine:
    """Continuous-batching decode front end (module docstring).

    ``submit`` enqueues a sequence and returns its :class:`DecodeRequest`;
    ``generate`` is the blocking form; ``resume`` continues a snapshotted
    one. Any number of threads may submit; one scheduler thread runs the
    iteration loop on ``device`` (default "cuda", which raises without a
    card; the model's params must live there). ``cuda_graph``: on a card,
    run the programs as captured CUDA graphs (the default); False runs
    them eagerly there too, to compare. ``min_seq_bucket`` is the fill's
    chunk and the prefix cache's page ``C`` (the reference's smallest
    prompt bucket and page), and ``max_prompt_len`` must be a multiple of
    it. ``prefix``: the prefix cache, on by default; ``prefix_max_bytes``
    its page budget (256 MiB by default). ``spec_k``: the speculative
    burst width k; speculation is on (``spec_enabled``) only when the
    model has a ``draft`` and k >= 2, else quietly off.
    ``breaker_threshold``/``breaker_cooldown``: every program key's
    circuit breaker (3 consecutive failures, 5.0 s by default).
    ``watchdog_interval``/``wedge_timeout``: the scheduler's watchdog
    (0.5 s and 30.0 s by default; an interval of 0 turns it off). ``name``
    is the ``engine`` label of its metrics: engines alive together in one
    process need names of their own. ``quant``: serve an f32 model under a
    quantization mode, "w8" or "bf16w" ("f32" or None: as it is, the
    default); a model that already carries a mode must be asked for that
    mode. ``mesh``: the serving mesh (inference/sharding.py; None reads
    ``PADDLE_TPU_SERVING_MESH``, else "single"); a sharded mesh splits the
    model's weights over ``mesh_devices`` (default ``cuda:0 .. cuda:n-1``;
    ``["cpu"] * n`` or ``["cuda:0"] * n`` put every shard on one device,
    whose first must be ``device``) and the fill and step run their
    products per shard. f32 and bf16 weights only; over launcher ranks, and
    with a quant mode, it raises NotImplementedError."""

    def __init__(self, model, max_slots=None, max_seq_len=None, max_queue=64,
                 min_seq_bucket=8, max_prompt_len=None, default_max_new_tokens=64,
                 name="decode", device="cuda", cuda_graph=True, prefix=True,
                 prefix_max_bytes=None, spec_k=None, breaker_threshold=None,
                 breaker_cooldown=None, watchdog_interval=None, wedge_timeout=None,
                 quant=None, phase=None, prefix_dir=None, mesh=None, mesh_devices=None,
                 **unported):
        for key, val in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"DecodeEngine got an unexpected keyword argument {key!r}")
            if val not in _UNPORTED[key]:
                raise NotImplementedError(f"DecodeEngine({key}={val!r}): {_UNPORTED_WHY[key]}")
        self.device = _indexed(resolve_device(device))
        if _indexed(model.device) != self.device:
            raise ValueError(f"the model's params live on {model.device}, the engine runs "
                             f"on {self.device}")
        # the reference's order: take the draft before the target is
        # wrapped (a quantized model is a new DecodeModel without it); the
        # draft follows the target's mode unless it carries its own
        draft = getattr(model, "draft", None)
        model_quant = getattr(model, "quant", None)
        # the serving mesh: the reference's resolution, and its fail-fast
        # build (too few devices raise here, never mid-request)
        self._mesh = sharding.resolve(mesh)
        self.mesh_desc = self._mesh.descriptor
        placement = None
        if not self._mesh.is_single:
            placement = self._mesh.build(mesh_devices)
            if placement.ranks:
                raise NotImplementedError(
                    f"DecodeEngine(mesh={self.mesh_desc!r}) over launcher ranks: meshed decode "
                    "runs over devices in one process (mesh_devices); over ranks it is a "
                    "ROADMAP follow-up (meshed serving)")
            if (quant or model_quant or "f32") != "f32":
                raise NotImplementedError(
                    f"DecodeEngine(mesh={self.mesh_desc!r}) with quant "
                    f"{quant or model_quant!r}: quantized weights under a mesh are a ROADMAP "
                    "follow-up (meshed serving)")
            if _indexed(placement.first) != self.device:
                raise ValueError(f"the mesh's first device is {placement.first}, the engine "
                                 f"runs on {self.device}")
        if quant is not None and quant != (model_quant or "f32"):
            if model_quant is not None:
                raise ValueError(f"model is quantized as {model_quant!r} but the engine was "
                                 f"asked to serve {quant!r}")
            if quant != "f32":
                from ..quantization.serving import quantize_decode_model

                model = quantize_decode_model(model, quant)
                if draft is not None and getattr(draft, "quant", None) is None:
                    draft = quantize_decode_model(draft, quant)
                model.draft = draft
        self.quant = getattr(model, "quant", None) or "f32"
        if placement is not None:
            model = sharding.shard_decode_model(model, placement)
            if draft is not None:
                draft = sharding.shard_decode_model(draft, placement)
            model.draft = draft
        if draft is not None:
            if draft.vocab_size != model.vocab_size:
                raise ValueError(f"draft vocab {draft.vocab_size} != target vocab "
                                 f"{model.vocab_size}; speculative verify compares argmaxes "
                                 "over the SAME vocab")
            if draft.feature_spec != model.feature_spec:
                raise ValueError("draft feature_spec differs from the target's; both models "
                                 "consume the request's feature arrays")
            if _indexed(draft.device) != self.device:
                raise ValueError(f"the draft's params live on {draft.device}, the engine "
                                 f"runs on {self.device}")
        for key, val in (("max_slots", max_slots), ("max_seq_len", max_seq_len)):
            for m in (model, draft):
                built = None if m is None else getattr(m, key)
                if val is not None and built is not None and int(val) != int(built):
                    raise ValueError(f"{key}={val}, but the model was built for {built}")
        self._model = model
        self.max_slots = int(max_slots or model.max_slots or 8)
        self.max_seq_len = int(max_seq_len or model.max_seq_len or 256)
        self.max_queue = int(max_queue)
        self.min_seq_bucket = int(min_seq_bucket)
        self.max_prompt_len = int(max_prompt_len or self.max_seq_len)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.name = name
        phase = "both" if phase is None else phase
        if phase not in wire_spec.REPLICA_PHASES:
            raise ValueError(f"unknown engine phase {phase!r} (expected one of "
                             f"{wire_spec.REPLICA_PHASES})")
        self.phase = phase
        self._declared = []  # program keys warmup() built
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if self.max_prompt_len > self.max_seq_len:
            raise ValueError("max_prompt_len cannot exceed max_seq_len")
        # the chunk of the fill and the page of the prefix cache
        self.page_len = self.min_seq_bucket
        if self.max_prompt_len % self.page_len:
            raise ValueError(f"max_prompt_len={self.max_prompt_len} must be a multiple of "
                             f"the chunk min_seq_bucket={self.page_len}, so that a padded "
                             "last chunk stays inside the staging buffer")
        self._slots = _KVSlots(self.max_slots, self.max_seq_len, model.kv_spec,
                               model.kv_seq_axis, self.device)
        self._staging = _KVStack(model.kv_spec, model.kv_seq_axis - 1, 1, self.max_prompt_len,
                                 self.device)
        self._pages = _PageStore(model.kv_spec, model.kv_seq_axis, self.page_len, self.device)
        self._prefix = None
        if prefix:
            self._prefix = PrefixCache(self._pages, max_bytes=prefix_max_bytes,
                                       store_dir=prefix_dir, name=f"{name}-prefix",
                                       identity_fn=self._prefix_identity)
        cuda = self.device.type == "cuda"
        self.breaker_threshold = int(3 if breaker_threshold is None else breaker_threshold)
        self.breaker_cooldown = float(5.0 if breaker_cooldown is None else breaker_cooldown)
        self.watchdog_interval = float(0.5 if watchdog_interval is None else watchdog_interval)
        self.wedge_timeout = float(30.0 if wedge_timeout is None else wedge_timeout)
        self._breakers = {}  # program key -> _Breaker
        # speculative decoding: on only with a draft AND k >= 2 (k-1
        # proposals and the always-correct first position per verify)
        self._spec_k = int(spec_k or 0)
        if draft is None or self._spec_k < 2:
            self._spec_k = 0
        self.spec_enabled = self._spec_k >= 2
        pool = torch.cuda.graph_pool_handle() if cuda and cuda_graph else None
        self._graphs = _Graphs(model, self._slots.pools, self.device, pool, self._staging,
                               self.page_len, spec_k=self._spec_k)
        self._step_key = ("step", self.max_slots, self.max_seq_len)
        self._verify_key = ("verify", self.max_slots, self.max_seq_len)
        self._draft_step_key = ("draft_step", self.max_slots, self.max_seq_len)
        self._draft_slots = self._draft_staging = self._draft_graphs = None
        if self.spec_enabled:
            # the draft's own pools (draft row i is slot i's), staging and
            # programs, in the engine's graph pool
            self._draft_slots = _KVSlots(self.max_slots, self.max_seq_len, draft.kv_spec,
                                         draft.kv_seq_axis, self.device)
            self._draft_staging = _KVStack(draft.kv_spec, draft.kv_seq_axis - 1, 1,
                                           self.max_prompt_len, self.device)
            self._draft_graphs = _Graphs(draft, self._draft_slots.pools, self.device, pool,
                                         self._draft_staging, self.page_len)
        # host staging of the row programs' inputs (pinned on a card),
        # per key, copied into the program's buffers
        self._host_rows = {}
        self._programs = {}  # key -> run
        self._builds = collections.Counter()  # key -> builds (captures on a card)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # one model call, build or KV copy at a time; reentrant, so a call
        # builds its program at first use under the lock it already holds
        self._exec_lock = threading.RLock()
        self._fingerprint = None
        self._id_lock = threading.Lock()
        self._pending = []  # FIFO of DecodeRequest
        self._pending_resume = []  # FIFO of (req, kv arrays, state)
        self._joining = []  # (req, slot): popped, slot held, not yet prefilled
        self._resuming = []  # (req, kv arrays, state, slot): not yet restored
        self._active = []   # _Seq
        self._closed = False
        self._closed_ev = threading.Event()
        self._dead = None   # the exception that closed the engine (its card failed)
        self._counts = collections.Counter()
        self._step_ms = collections.deque(maxlen=4096)
        self._snap_copy_ms = collections.deque(maxlen=4096)  # the scheduler's share
        self._snap_encode = collections.deque(maxlen=4096)   # (ms, bytes), consumers'
        self._init_metrics()
        # a restart bumps the generation; each scheduler thread keeps its
        # own in _tls and ends once they differ
        self._sched_gen = 0
        self._tls = threading.local()
        self._heartbeat = time.monotonic()  # bumped every scheduler iteration
        self._watchdog = None  # before the scheduler starts: its crash path reads it
        self._scheduler = threading.Thread(target=self._run_scheduler, args=(0,),
                                           name=f"{name}-scheduler", daemon=True)
        self._scheduler.start()
        if self.watchdog_interval > 0:
            self._watchdog = threading.Thread(target=self._run_watchdog,
                                              name=f"{name}-watchdog", daemon=True)
            self._watchdog.start()

    # ---------------------------------------------------------- telemetry
    def _init_metrics(self):
        """The reference's instruments (decode.py :1232-1330: the same
        family names, label names, const labels and bucket bounds), exposed
        through a collector in the process registry until ``close``.
        ``stats`` reads them under the engine lock."""
        cl = {"engine": self.name}
        ident = {**cl, "quant": self.quant, "mesh": self.mesh_desc}
        M = obs_metrics
        lat = M.log_buckets(0.0001, 4.0, 10)
        self._m_requests = M.Counter("paddle_decode_requests_total",
                                     "Decode requests admitted", const_labels=cl)
        self._m_tokens = M.Counter("paddle_decode_tokens_total", "Tokens generated",
                                   const_labels=cl)
        self._m_shed = M.Counter(
            "paddle_decode_shed_total",
            "Requests shed (reason: queue_full | quarantine | no_free_slot — the last is the "
            "kv_put seed preflight)", labelnames=("reason",), const_labels=cl)
        self._m_retired = M.Counter("paddle_decode_retired_total",
                                    "Sequences retired, by reason", labelnames=("reason",),
                                    const_labels=cl)
        self._m_deadline = M.Counter(
            "paddle_decode_deadline_total",
            "Per-token deadline outcomes (stage: expired = purged before joining, zero "
            "compute; late = blew a per-token budget mid-sequence)",
            labelnames=("stage",), const_labels=cl)
        self._m_restarts = M.Counter("paddle_decode_scheduler_restarts_total",
                                     "Watchdog scheduler restarts", const_labels=cl)
        self._m_compiles = M.Counter(
            "paddle_decode_compiles_total",
            "Program materializations (source: inline = a build, on a card a CUDA graph "
            "capture; quant: the serving quantization mode; mesh: the serving mesh "
            "descriptor)", labelnames=("phase", "source"), const_labels=ident)
        self._m_steps = M.Counter("paddle_decode_steps_total",
                                  "Model program dispatches, by phase", labelnames=("phase",),
                                  const_labels=cl)
        self._m_ttft = M.Histogram("paddle_decode_ttft_seconds",
                                   "Time from enqueue to a sequence's FIRST token",
                                   const_labels=cl, buckets=lat)
        self._m_intertoken = M.Histogram("paddle_decode_intertoken_seconds",
                                         "Gap between consecutive tokens of one sequence",
                                         const_labels=cl, buckets=lat)
        self._m_step_exec = M.Histogram("paddle_decode_step_seconds",
                                        "Program execute duration, by phase",
                                        labelnames=("phase",), const_labels=cl, buckets=lat)
        self._m_occupancy = M.Histogram(
            "paddle_decode_batch_occupancy", "Active sequences / slot bucket per decode step",
            const_labels=cl, buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self._m_active = M.Gauge("paddle_decode_active_slots",
                                 "Sequences currently holding a KV slot", const_labels=cl)
        self._m_queue = M.Gauge("paddle_decode_queue_depth", "Requests waiting for a slot",
                                const_labels=cl)
        self._m_prefix_hits = M.Counter(
            "paddle_prefix_hits_total",
            "Prefix-cache hits (a joiner installed cached KV pages and skipped prefill over "
            "them)", const_labels=cl)
        self._m_prefix_misses = M.Counter(
            "paddle_prefix_misses_total",
            "Prefix-cache misses (hashed prompts with no cached boundary)", const_labels=cl)
        self._m_prefix_evictions = M.Counter(
            "paddle_prefix_evictions_total",
            "Prefix-cache entries evicted under the byte budget", const_labels=cl)
        self._m_shared_pages = M.Gauge(
            "paddle_decode_shared_pages",
            "KV pages referenced by more than one owner (slots + prefix-cache entries)",
            const_labels=cl)
        self._m_live_pages = M.Gauge("paddle_decode_live_pages",
                                     "KV pages currently allocated (target + draft pools)",
                                     const_labels=cl)
        self._m_spec_accept = M.Histogram(
            "paddle_spec_accept_ratio",
            "Accepted draft tokens / proposed (k-1) per speculative verify",
            const_labels=ident, buckets=(0.0, 0.25, 0.5, 0.75, 1.0))
        self._instruments = [
            self._m_requests, self._m_tokens, self._m_shed, self._m_retired, self._m_deadline,
            self._m_restarts, self._m_compiles, self._m_steps, self._m_ttft,
            self._m_intertoken, self._m_step_exec, self._m_occupancy, self._m_active,
            self._m_queue, self._m_prefix_hits, self._m_prefix_misses,
            self._m_prefix_evictions, self._m_shared_pages, self._m_live_pages,
            self._m_spec_accept]
        # weakly held: an engine dropped without close() is collected, and
        # its collector then unregisters itself (it returns None)
        ref = weakref.ref(self)

        def collector():
            eng = ref()
            return eng._collect_families() if eng is not None else None

        self._obs_collector = collector
        obs_metrics.REGISTRY.register_collector(collector)

    def _collect_families(self):
        with self._lock:
            self._m_queue.set(len(self._pending))
            self._m_active.set(len(self._active))
            self._m_shared_pages.set(self._pages.shared_pages())
            self._m_live_pages.set(self._pages.live_pages())
            return [m.collect() for m in self._instruments]

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens=None, features=(), token_budget_s=None,
               trace_id=None, eos_token_id=None, snapshot_every=None, speculative=False):
        """Enqueue one sequence; -> :class:`DecodeRequest`.

        ``prompt``: 1-D (or [1, P]) int32/int64 token ids in the model's
        vocabulary (the output echoes the dtype). ``features``: arrays
        matching the model's ``feature_spec``. ``token_budget_s``: the
        per-token budget (first token and every gap). ``snapshot_every``:
        emit a resumable kv-snapshot block every N generated tokens
        (``DecodeRequest.take_snapshot``; 0 or None: never).
        ``speculative``: opt in to speculative bursts (tokens bitwise
        those of plain greedy; a no-op on an engine without
        ``spec_enabled``). ``trace_id`` (default: the thread's ambient
        obs.tracing id) tags the request's spans."""
        chaos.hit("serving.decode.admit")
        prompt = np.asarray(prompt)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be a non-empty 1-D token array (got shape "
                             f"{tuple(prompt.shape)})")
        if prompt.dtype not in _TOKEN_DTYPES:
            raise ValueError(f"prompt dtype {prompt.dtype} is not a token dtype "
                             "(int32 / int64)")
        token_dtype = prompt.dtype.type
        if prompt.size > self.max_prompt_len:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds max_prompt_len="
                             f"{self.max_prompt_len}")
        if prompt.min() < 0 or prompt.max() >= self._model.vocab_size:
            # an out-of-range id would fault the embedding gather on the card
            raise ValueError(f"prompt token ids must lie in [0, {self._model.vocab_size})")
        spec = self._model.feature_spec
        features = [np.ascontiguousarray(np.asarray(f)) for f in features]
        if len(features) != len(spec):
            raise ValueError(f"model expects {len(spec)} feature array(s), got "
                             f"{len(features)}")
        for f, (tr, dt) in zip(features, spec):
            if tuple(f.shape) != tr or f.dtype != dt:
                raise ValueError(f"feature shape/dtype {f.shape}/{f.dtype} does not match "
                                 f"spec {tr}/{dt}")
        if max_new_tokens is None:
            max_new_tokens = self.default_max_new_tokens
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        eos = self._model.eos_token_id if eos_token_id is None else eos_token_id
        if trace_id is None:
            trace_id = obs_tracing.current_trace_id()
        req = DecodeRequest(np.ascontiguousarray(prompt.astype(np.int64)), features,
                            max_new_tokens, eos, token_budget_s, trace_id, token_dtype)
        req.snapshot_every = max(0, int(snapshot_every or 0))
        req.speculative = bool(speculative)
        with self._cond:
            if self._closed:
                raise EngineClosed(f"{self.name} is closed")
            if len(self._pending) >= self.max_queue:
                self._m_shed.inc(reason="queue_full")
                raise EngineOverloaded(f"{self.name} decode queue full ({len(self._pending)} "
                                       f"waiting, cap {self.max_queue}); request shed")
            self._pending.append(req)
            self._m_requests.inc()
            self._cond.notify_all()
        return req

    def generate(self, prompt, timeout=None, **kw):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, **kw).result(timeout)

    def cancel(self, req):
        """Abandon a request: dropped here if still queued; if running, its
        slot frees before the next step."""
        req.cancel()
        with self._cond:
            if req in self._pending:
                self._pending.remove(req)
            self._pending_resume[:] = [e for e in self._pending_resume if e[0] is not req]
            self._cond.notify_all()

    # --------------------------------------------------- snapshot, resume
    def _identity(self):
        """-> (fingerprint, weights digest) of this replica, computed once
        (``warmup`` takes them, so no stream pays for them)."""
        with self._id_lock:
            if self._fingerprint is None:
                self._fingerprint = self._model.fingerprint(self.page_len)
        return self._fingerprint, self._model.weights_digest()[0]

    def _prefix_identity(self):
        """The identity of the persistent prefix tier's keys and headers:
        the fields a snapshot's resume compares."""
        fp, wd = self._identity()
        return {"fingerprint": fp, "weights": wd, "quant": self.quant, "mesh": self.mesh_desc}

    def _build_snapshot(self, req, arrays, pos, last_token, n_generated):
        """Encode one kv-snapshot block (the reference's header and array
        order: prompt int32, the generated tail, the kv buffers, the
        features). Runs on the consumer's thread (``_Snapshot.block``),
        outside the engine's locks; its ms (the copy to the host
        included) and bytes go to ``stats()["snapshot_costs"]``."""
        t0 = time.perf_counter()
        fp, wd = self._identity()
        header = {
            "fingerprint": fp, "weights": wd, "quant": self.quant, "mesh": self.mesh_desc,
            "pos": int(pos), "last_token": int(last_token), "n_generated": int(n_generated),
            "prompt_len": int(req.prompt.size), "max_new_tokens": int(req.max_new_tokens),
            "eos_token_id": req.eos_token_id, "n_kv": len(self._model.kv_spec),
        }
        tail = np.asarray(req.tokens_so_far()[:n_generated], dtype=req.token_dtype)
        blob = wire_spec.encode_kv_snapshot(
            header, [req.prompt.astype(np.int32), tail] + arrays() + list(req.features))
        with self._lock:
            self._snap_encode.append(((time.perf_counter() - t0) * 1e3, len(blob)))
        return blob

    def _refuse(self, why):
        with self._lock:
            self._counts["resumes_refused"] += 1
        raise SnapshotRefused(f"{self.name}: snapshot refused ({why}); resume on a replica "
                              "matching the snapshot's identity")

    def check_snapshot(self, payload):
        """Parse and validate one kv-snapshot block against this replica's
        identity and limits; -> (header, arrays). ValueError for a
        malformed or inconsistent block (wire status 1),
        :class:`SnapshotRefused` for an identity or capacity skew (wire
        status 2). The kv_put preflight and ``resume`` share it."""
        header, arrays, _ = wire_spec.decode_kv_snapshot_off(payload)
        m = self._model
        pos, n_gen = int(header["pos"]), int(header["n_generated"])
        plen = int(header["prompt_len"])
        prompt, tail = arrays[0], arrays[1]
        n_kv = int(header.get("n_kv", len(m.kv_spec)))
        if n_gen < 1:
            raise ValueError("kv snapshot carries no generated tokens")
        if prompt.ndim != 1 or prompt.size != plen:
            raise ValueError(f"kv snapshot prompt shape {tuple(prompt.shape)} does not match "
                             f"its declared prompt_len {plen}")
        if tail.ndim != 1 or tail.size != n_gen:
            raise ValueError(f"kv snapshot token tail of {tail.size} does not match its "
                             f"declared n_generated {n_gen}")
        if tail.dtype not in _TOKEN_DTYPES:
            raise ValueError(f"kv snapshot token tail dtype {tail.dtype} is not a token dtype "
                             "(int32 / int64)")
        if pos != plen + n_gen - 1:
            raise ValueError(f"kv snapshot position invariant broken: pos {pos} != prompt_len "
                             f"{plen} + n_generated {n_gen} - 1")
        if int(header["last_token"]) != int(tail[-1]):
            raise ValueError("kv snapshot last_token does not match its token tail")
        fp, wd = self._identity()
        if header["fingerprint"] != fp:
            self._refuse(f"model fingerprint {header['fingerprint']!r} != {fp!r}")
        if header["weights"] != wd:
            self._refuse("weights digest mismatch: same architecture, different parameter "
                         "values; a foreign KV cache would decode garbage")
        if header["quant"] != self.quant:
            self._refuse(f"quant mode {header['quant']!r} != {self.quant!r}")
        if header["mesh"] != self.mesh_desc:
            self._refuse(f"mesh {header['mesh']!r} != {self.mesh_desc!r}")
        if n_kv != len(m.kv_spec):
            self._refuse(f"{n_kv} kv buffers != this model's {len(m.kv_spec)}")
        if len(arrays) != 2 + n_kv + len(m.feature_spec):
            self._refuse(f"{len(arrays)} arrays != prompt + tail + {n_kv} kv + "
                         f"{len(m.feature_spec)} features")
        if pos > self.max_seq_len:
            self._refuse(f"position {pos} exceeds this engine's max_seq_len "
                         f"{self.max_seq_len}")
        for a, (tr, dt) in zip(arrays[2:2 + n_kv], m.kv_spec):
            if (a.ndim != 1 + len(tr) or tuple(a.shape[1:]) != tr
                    or a.dtype != _wire_dtype(dt) or a.shape[0] < pos):
                self._refuse(f"kv buffer {tuple(a.shape)}/{a.dtype} does not match kv_spec "
                             f"{tr}/{_dtype_name(dt)} at position {pos}")
        for f, (tr, dt) in zip(arrays[2 + n_kv:], m.feature_spec):
            if tuple(f.shape) != tr or f.dtype != dt:
                self._refuse(f"feature {tuple(f.shape)}/{f.dtype} does not match "
                             f"feature_spec {tr}/{dt}")
        return header, arrays

    def seed_check(self, payload):
        """The kv_put preflight of a prefill-to-decode handoff:
        ``check_snapshot`` plus this engine's capacity to seed a fresh
        slot now (a full queue, or no free slot with sequences already
        waiting, refuses retryable); -> (header, arrays)."""
        header, arrays = self.check_snapshot(payload)
        with self._lock:
            if self._closed:
                raise EngineClosed(f"{self.name} is closed")
            waiting = len(self._pending) + len(self._pending_resume)
            if waiting >= self.max_queue:
                self._m_shed.inc(reason="queue_full")
                raise EngineOverloaded(f"{self.name} decode queue full; seed the handoff "
                                       "elsewhere")
            if self._slots.free_count() == 0 and waiting > 0:
                self._m_shed.inc(reason="no_free_slot")
                raise EngineOverloaded(f"{self.name} has no free KV slot and {waiting} "
                                       "sequences already waiting; seed the handoff elsewhere")
        return header, arrays

    def resume(self, snapshot, token_budget_s=None, trace_id=None, snapshot_every=None,
               max_new_tokens=None, speculative=False):
        """Resume a snapshotted sequence on this engine at its exact
        position; -> :class:`DecodeRequest`. Its ``next_tokens`` yields
        only the tokens after the snapshot; ``result`` the whole sequence,
        the snapshot's tail included. The sequence joins the running set
        with its last token as the next step's row, so its suffix equals
        the unbroken stream's, bitwise, on an engine of the same
        configuration. ``speculative`` as in ``submit``; the draft starts
        empty and catches up at the first burst."""
        chaos.hit("serving.decode.resume")
        header, arrays = self.check_snapshot(snapshot)
        m = self._model
        n_kv = int(header.get("n_kv", len(m.kv_spec)))
        prompt, tail = arrays[0], arrays[1]
        kv_arrays = list(arrays[2:2 + n_kv])
        feats = [np.ascontiguousarray(a) for a in arrays[2 + n_kv:]]
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else header.get("max_new_tokens") or self.default_max_new_tokens)
        eos = header.get("eos_token_id")
        pos, n_gen = int(header["pos"]), int(header["n_generated"])
        last = int(header["last_token"])
        if trace_id is None:
            trace_id = obs_tracing.current_trace_id()
        req = DecodeRequest(np.ascontiguousarray(prompt.astype(np.int64)), feats, max_new, eos,
                            token_budget_s, trace_id, tail.dtype.type)
        req.snapshot_every = max(0, int(snapshot_every or 0))
        req.speculative = bool(speculative)
        # the snapshot's tail counts as already consumed: result() sees the
        # whole sequence, the stream re-emits nothing
        req._tokens = [int(t) for t in tail]
        req._taken = n_gen
        # a snapshot taken at a stop boundary resumes to a clean finish
        if eos is not None and last == eos:
            done = "eos"
        elif n_gen >= max_new:
            done = "max_tokens"
        elif pos >= self.max_seq_len:
            done = "max_seq_len"
        else:
            done = None
        if done is not None:
            with self._lock:
                self._counts["resumes_ok"] += 1
            self._m_retired.inc(reason=done)
            req._finish(done)
            return req
        state = {"pos": pos, "last_token": last, "n_generated": n_gen}
        with self._cond:
            if self._closed:
                raise EngineClosed(f"{self.name} is closed")
            if len(self._pending) + len(self._pending_resume) >= self.max_queue:
                self._m_shed.inc(reason="queue_full")
                raise EngineOverloaded(f"{self.name} decode queue full; resume shed")
            self._pending_resume.append((req, kv_arrays, state))
            self._m_requests.inc()
            self._cond.notify_all()
        return req

    # --------------------------------------------------------- scheduler
    def _run_scheduler(self, gen):
        """One scheduler thread of generation ``gen``, on the engine's
        card. A card that cannot be selected ends the engine (a restart
        could not help). A loop that raises leaves its sequences in flight
        for the watchdog's restart (or restarts itself with no watchdog);
        a superseded thread unwinds quietly."""
        self._tls.gen = gen
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        except Exception as e:  # noqa: BLE001 - the card is gone
            traceback.print_exc()
            self._fail_all(RetryableError(f"{self.name}: the decode scheduler cannot select "
                                          f"{self.device} ({type(e).__name__}: {e}); retry "
                                          "elsewhere"), dead=e)
            return
        try:
            with torch.inference_mode():
                self._scheduler_loop()
        except _Superseded:
            with self._lock:
                self._counts["stale_unwinds"] += 1
        except Exception:  # noqa: BLE001 - the watchdog owns recovery
            traceback.print_exc()
            if self._watchdog is None:
                self._restart_scheduler(gen, "died (watchdog disabled)")

    def _scheduler_loop(self):
        while True:
            # a float store: the watchdog only compares it with a threshold
            self._heartbeat = time.monotonic()
            work = self._wait_for_work()
            if work is None:
                return
            # from here a raise kills this thread with its resumes and
            # joiners in flight: the restart fails exactly those
            chaos.hit("serving.decode.loop")
            resumes, joiners = work
            for entry in resumes:
                self._restore(*entry)
            for req, slot in joiners:
                self._prefill(req, slot)
            self._purge_blown_budgets()
            if self._active:
                self._decode_step()

    def _current_locked(self):
        """Under the engine lock: may this thread change the engine's
        state? Not after close, nor in a scheduler a restart superseded
        (any other thread, as warmup's, has no generation)."""
        return not self._closed and getattr(self._tls, "gen", self._sched_gen) == self._sched_gen

    def _check_current(self):
        """Under the exec lock, before a device write: a superseded
        scheduler unwinds here (_Superseded), before it can touch a
        graph's static buffers, a pool row or the staging that its
        replacement uses. A restart bumps the generation without the exec
        lock, so every write of a superseded thread is ordered before the
        replacement's first."""
        gen = getattr(self._tls, "gen", None)
        if gen is not None and gen != self._sched_gen:
            raise _Superseded()

    def _wait_for_work(self):
        """Park until there is work; pop this iteration's resumes (first:
        they paid their prefill elsewhere) and joiners, each with a slot
        (bounded by the free slots). None = exit (closed, or superseded)."""
        with self._cond:
            while True:
                if not self._current_locked():
                    return None
                self._purge_expired_pending_locked(time.monotonic())
                self._pending[:] = [r for r in self._pending if not r.cancelled]
                self._pending_resume[:] = [e for e in self._pending_resume
                                           if not e[0].cancelled]
                if self._active or self._pending or self._pending_resume:
                    break
                self._cond.wait()
            while self._pending_resume and self._slots.free_count():
                self._resuming.append(self._pending_resume.pop(0) + (self._slots.alloc(),))
            while self._pending and self._slots.free_count():
                self._joining.append((self._pending.pop(0), self._slots.alloc()))
            return list(self._resuming), list(self._joining)

    def _purge_expired_pending_locked(self, now):
        """A queued request (or resume) whose per-token budget elapsed
        before it could join is dropped without compute."""
        expired = [r for r in self._pending if r.token_budget_s is not None
                   and now - r.t_enqueue >= r.token_budget_s]
        expired_resume = [e for e in self._pending_resume if e[0].token_budget_s is not None
                          and now - e[0].t_enqueue >= e[0].token_budget_s]
        for r in expired:
            self._pending.remove(r)
        for e in expired_resume:
            self._pending_resume.remove(e)
        for r in expired + [e[0] for e in expired_resume]:
            self._m_deadline.inc(stage="expired")
            r._fail(DeadlineExceeded(f"{self.name}: per-token budget elapsed before the "
                                     "sequence could join; dropped without compute"))

    def _purge_blown_budgets(self):
        """Retire running sequences that were cancelled or blew their
        per-token budget, before the next step, so the slot frees now."""
        now = time.monotonic()
        purged = []
        with self._lock:
            if not self._current_locked():
                return
            keep = []
            for s in self._active:
                if s.req.cancelled:
                    purged.append((s, "cancelled", None))
                elif (s.req.token_budget_s is not None
                        and now - s.t_last > s.req.token_budget_s):
                    purged.append((s, "deadline", DeadlineExceeded(
                        f"{self.name}: per-token budget {s.req.token_budget_s}s blown after "
                        f"{s.n_generated} tokens; slot purged")))
                else:
                    keep.append(s)
                    continue
                self._slots.release(s.slot)
            self._active[:] = keep
        for s, reason, err in purged:
            self._notify_retired(s, reason, err)

    # ------------------------------------------------------- the paths
    def _graphs_of(self, key):
        """The program set of ``key``: the draft's for ``draft_*``."""
        return self._draft_graphs if key[0].startswith("draft_") else self._graphs

    def _program(self, key, trace_id=None):
        """The program of ``key``, built once (the reference's
        ``_program``): every build holds the exec lock, so warmup and the
        scheduler never build one key twice, and a capture never overlaps
        another model call. On a card a build warms the function up over
        its buffers as they are, then captures it; it is counted as an
        ``inline`` compile, and spanned under ``trace_id`` (the traced
        request that paid for it) or aggregated."""
        with self._lock:
            run = self._programs.get(key)
        if run is not None:
            return run
        with self._exec_lock:
            with self._lock:
                run = self._programs.get(key)
            if run is None:
                chaos.hit("serving.decode.compile")
                t0 = time.perf_counter()
                run = self._graphs_of(key).build(key)
                dt = time.perf_counter() - t0
                if trace_id is not None:
                    obs_tracing.record_span("serving.decode.compile", dt, trace_id=trace_id,
                                            engine=self.name, phase=key[0], rows=key[1],
                                            seq=key[2], source="inline")
                else:
                    obs_tracing.observe("serving.decode.compile", dt)
                with self._lock:
                    self._programs[key] = run
                    self._builds[key] += 1
                self._m_compiles.inc(phase=key[0], source="inline")
                LEDGER.record(f"decode/{key[0]}{key[1]}x{key[2]}", duration_s=dt,
                              kind="cuda_graph" if self._graphs_of(key).capture else "eager",
                              extra={"phase": key[0], "bucket": key[1], "seq": key[2],
                                     **self._ledger_extra()})
        return run

    def _ledger_extra(self):
        """Ledger-event mode and mesh tags, where the reference puts them:
        empty for f32 on the single mesh."""
        extra = {}
        if self.quant != "f32":
            extra["quant"] = self.quant
        if self.mesh_desc != sharding.SINGLE:
            extra["mesh"] = self.mesh_desc
        return extra

    def _call(self, key, fill, trace_id=None, site=None):
        """One call of ``key``'s program: hit the chaos ``site`` (outside
        the exec lock), then under the exec lock check this thread's
        generation, ``fill`` the program's inputs, build it at first use,
        run it and read its argmax back (-> numpy, or None for a fill).
        The outcome goes to the key's breaker, the time to
        ``paddle_decode_step_seconds``, and K1's launches in the run are
        counted for stats (a replay credits those of its capture). On a
        card the time is the device's, from CUDA events around the run (a
        fill, which reads nothing back, waits for its end event): a host
        clock, or an event before the input copies, would also count the
        host's waits for the GIL, which the device spends idle. The CPU's
        calls are synchronous, so there the host clock times them."""
        cuda = self.device.type == "cuda"
        try:
            if site is not None:
                chaos.hit(site)
            with self._exec_lock:
                self._check_current()
                before = flash_attention.launches
                t0 = time.perf_counter()
                try:
                    fill(*self._graphs_of(key).inputs(key))
                    run = self._program(key, trace_id)
                    if cuda:
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        start.record()
                    out = run()
                    if cuda:
                        end.record()
                    if out is not None:
                        out = out.cpu().numpy()
                    elif cuda:
                        end.synchronize()
                finally:
                    self._counts["k1_launches"] += flash_attention.launches - before
                host_s = time.perf_counter() - t0
                dt = start.elapsed_time(end) / 1e3 if cuda else host_s
        except Exception:
            self._record_breaker(key, ok=False)
            raise
        self._record_breaker(key, ok=True)
        phase = key[0]
        self._m_steps.inc(phase=phase)
        self._m_step_exec.observe(dt, phase=phase)
        obs_tracing.observe(f"serving.decode.{phase}", dt)
        if key == self._step_key:
            with self._lock:
                self._step_ms.append(host_s * 1e3)
        return out

    def _run_rows(self, key, tokens, positions, active, trace_id=None, site=None):
        """The row program ``key`` (a step, draft step or verify) over
        every slot, fed ``tokens``/``positions`` (numpy, the program's
        input shapes) and each running row's features at its slot (a
        padding row's are zero); -> the argmax (numpy int32). The pinned
        host staging is written inside the call, after its generation
        check: every call ends by reading its argmax back, so the copies
        out of these buffers are done (a failed call's may still be
        queued, but into the same device buffers, ahead of this call's
        copies)."""

        def fill(d_tokens, d_pos, d_feats):
            host = self._host_rows.get(key)
            if host is None:
                host = self._host_rows[key] = [
                    torch.zeros(t.shape, dtype=t.dtype,
                                pin_memory=self.device.type == "cuda")
                    for t in (d_tokens, d_pos, *d_feats)]
            h_tok, h_pos, *h_feats = host
            h_tok.numpy()[:] = tokens
            h_pos.numpy()[:] = positions
            feats = [h.numpy() for h in h_feats]
            for f in feats:
                f[:] = 0
            for s in active:
                for f, v in zip(feats, s.req.features):
                    f[s.slot] = v
            d_tokens.copy_(h_tok, non_blocking=True)
            d_pos.copy_(h_pos, non_blocking=True)
            for d, h in zip(d_feats, h_feats):
                d.copy_(h, non_blocking=True)

        return self._call(key, fill, trace_id, site)

    # ---------------------------------------------------------- breakers
    def _breaker_locked(self, key):
        br = self._breakers.get(key)
        if br is None:
            br = self._breakers[key] = _Breaker(self.breaker_threshold, self.breaker_cooldown)
        return br

    def _breaker_probe(self, key):
        """The breaker's check without shedding, for the draft and the
        verify: a quarantined program there means "fall back to the plain
        step", never "fail the requests"."""
        with self._lock:
            return self._breaker_locked(key).allow(time.monotonic())

    def _breaker_allows(self, key, n_requests):
        """The breaker's check for a fill or a step: -> None, or the
        retryable :class:`BucketQuarantined` the caller fails its
        ``n_requests`` requests with (counted as shed)."""
        with self._lock:
            br = self._breaker_locked(key)
            if br.allow(time.monotonic()):
                return None
            br.shed += n_requests
            failures = br.failures
        self._m_shed.inc(n_requests, reason="quarantine")
        return BucketQuarantined(f"{self.name} program {key} is quarantined after {failures} "
                                 f"consecutive failures; retry after cooldown "
                                 f"({self.breaker_cooldown}s)")

    def _record_breaker(self, key, ok):
        now = time.monotonic()
        with self._lock:
            if not ok:
                self._counts["program_failures"] += 1
            br = self._breakers.get(key)
            if br is not None:
                if ok:
                    br.record_success()
                else:
                    br.record_failure(now)

    def _admit(self, inflight, entry, err, state=None):
        """After a joiner's prefill or a resume's restore: take ``entry``
        off the in-flight list named ``inflight`` and join the running
        set, or fail retryable with the slot freed, in one lock
        acquisition (a close or a restart in between failed what was in
        flight and freed its slot already)."""
        req, slot = entry[0], entry[-1]
        with self._lock:
            if not self._current_locked():
                return
            getattr(self, inflight).remove(entry)
            if err is None:
                self._active.append(_Seq(req, slot, state, time.monotonic()))
                if state is not None:
                    self._counts["resumes_ok"] += 1
            else:
                self._slots.release(slot)
        if err is not None:
            self._m_retired.inc(reason="error")
            req._fail(err)

    def _retryable(self, e, what):
        return e if isinstance(e, RetryableError) else RetryableError(
            f"{self.name}: {what} failed ({type(e).__name__}: {e}); retry the request")

    def _restore(self, req, kv_arrays, state, slot):
        """Copy a resumed sequence's snapshot rows into its slot."""
        err = None
        try:
            with self._exec_lock:
                self._check_current()
                self._slots.restore(slot, kv_arrays, state["pos"])
        except Exception as e:  # noqa: BLE001 - fail this resume
            err = self._retryable(e, "resume")
        self._admit("_resuming", (req, kv_arrays, state, slot), err, state)

    def _prefill(self, req, slot):
        """One joiner's KV rows 0..P-1 into its slot by the chunked fill
        (with the prefix cache); it then joins the running set, and its
        first token comes from its row of the next step."""
        err = None
        try:
            self._fill_chunks(req, slot)
        except Exception as e:  # noqa: BLE001 - fail this joiner
            err = self._retryable(e, "prefill")
        self._admit("_joining", (req, slot), err)

    def _fill_chunks(self, req, slot):
        """The chunked fill of one joiner: hash the prompt at page
        boundaries, copy the longest cached prefix's pages into staging
        rows 0..k-1, call the fill keys from k until row P-1 is covered
        (each call takes the exec lock, with the ``serving.decode.prefill``
        site before it), copy staging rows 0..P-1 into the slot, and insert
        every chain boundary, its pages made from staging. Only the
        scheduler fills, and each step here checks the generation under
        the exec lock first, so the staging is this fill's alone."""
        P, C = req.prompt.size, self.page_len
        hashes, hit = [], None
        with self._exec_lock:
            self._check_current()
            if self._prefix is not None:
                hashes = prefix_hashes(req.prompt, C, feature_seed(req.features))
                if hashes:
                    hit = self._prefix.lookup(hashes)
                    (self._m_prefix_misses if hit is None else self._m_prefix_hits).inc()
        # the persistent tier on a memory miss: file IO without the lock
        load = (self._prefix.load_store(hashes, req.prompt)
                if hashes and hit is None else None)
        with self._exec_lock:
            self._check_current()
            if load is not None:
                hx, n_tok, kv_arrays = load
                hit = (n_tok, self._prefix.install_arrays(hx, n_tok, kv_arrays))
            k, have = hit if hit is not None else (0, [])
            if k:
                self._pages.install(have, self._staging)
        for start in range(k, P, C):
            chunk = req.prompt[start:start + C]

            def fill(tokens, _, feats, chunk=chunk):
                padded = np.zeros((1, C), np.int64)
                padded[0, :chunk.size] = chunk
                tokens.copy_(torch.from_numpy(padded))
                for buf, f in zip(feats, req.features):
                    buf.copy_(torch.from_numpy(f[None]))

            key = ("fill", 1, start + C)
            err = self._breaker_allows(key, 1)
            if err is not None:
                raise err
            self._call(key, fill, req.trace_id, site="serving.decode.prefill")
        block = None
        with self._exec_lock:
            self._check_current()
            self._slots.copy_from(slot, self._staging, P)
            if hashes:
                block = self._publish(hashes, have)
        if block is not None:
            n_tok, hx, arrays = block
            try:
                self._prefix.publish(hx, n_tok, req.prompt, arrays())
            except Exception:  # noqa: BLE001 - publishing is best-effort
                pass

    def _publish(self, hashes, have):
        """Insert every chain boundary of a filled prompt: the hit's pages
        for the rows it covered, fresh pages from staging for the rest
        (one boundary's pages are a prefix of the next's). With a
        persistent tier that lacks the longest boundary, -> ``(n_tokens,
        hash, arrays)``: its staging rows copied on the device (queued;
        ``arrays()`` brings them to the host), for ``publish`` after the
        exec lock; else None."""
        n_full = hashes[-1][0] // self.page_len
        for pid in have:  # held while the inserts may evict their entry
            self._pages.retain_page(pid)
        new = self._pages.publish(self._staging, len(have), n_full - len(have)) \
            if n_full > len(have) else []
        pages = have + new
        evicted = 0
        for n_tok, hx in hashes:
            evicted += self._prefix.insert(hx, n_tok, pages[:n_tok // self.page_len])
        for pid in pages:
            self._pages.drop_page(pid)
        if evicted:
            self._m_prefix_evictions.inc(evicted)
        n_tok, hx = hashes[-1]
        if self._prefix.needs_publish(hx):
            return n_tok, hx, self._staging.snapshot(0, n_tok, self.device, len(self._model.kv_spec))
        return None

    def _decode_step(self):
        """One iteration over the running set (the reference's
        ``_decode_step``): a speculative burst when a row opted in and
        may take one, covering every slot; else, or when the draft or the
        verify cannot run, one plain step."""
        active = list(self._active)
        group = [s for s in active if self._spec_ok(s)]
        if group and self._spec_group(active, group):
            return
        self._step_group()

    def _spec_ok(self, s):
        """May this sequence take a k-token burst now? It opted in, has
        its first token (the finishing step is a plain row, as the
        reference's prefill emits it), room for k kv entries, and at
        least 2 tokens of budget left (a 1-token tail is a plain row)."""
        return (self.spec_enabled and s.req.speculative and s.n_generated >= 1
                and s.pos + self._spec_k <= self.max_seq_len
                and s.req.max_new_tokens - s.n_generated >= 2)

    def _fail_rows(self, active, err):
        """Fail every sequence of a step that did not run, retryable, and
        free its slot."""
        with self._lock:
            if not self._current_locked():
                return  # a close or a restart failed them and freed their slots
            for s in active:
                self._slots.release(s.slot)
            drop = {id(s) for s in active}
            self._active[:] = [x for x in self._active if id(x) not in drop]
        self._m_retired.inc(len(active), reason="error")
        for s in active:
            s.req._fail(err)

    def _step_group(self):
        """One step over every slot: the running sequences' rows and
        padding rows for the free slots (the ``serving.decode.step`` site
        before it, outside the exec lock); then, under the exec lock, each
        row's token and the copies of the kv snapshots its cadence asks
        for, queued before any slot can be reused. The blocks are built by
        their consumers. A quarantined step sheds its rows."""
        active = list(self._active)
        err = self._breaker_allows(self._step_key, len(active))
        if err is not None:
            self._fail_rows(active, err)
            return
        tokens = np.zeros(self.max_slots, np.int64)
        pos = np.zeros(self.max_slots, np.int32)
        for s in active:
            tokens[s.slot] = s.last_token
            pos[s.slot] = s.pos
        trace_id = next((s.req.trace_id for s in active if s.req.trace_id is not None), None)
        try:
            nxt = self._run_rows(self._step_key, tokens, pos, active, trace_id,
                                 site="serving.decode.step")
        except Exception as e:  # noqa: BLE001 - fail the whole step batch
            self._fail_rows(active, self._retryable(e, "decode step"))
            return
        with self._exec_lock:
            now = time.monotonic()
            finished, snaps = [], []
            with self._lock:
                if not self._current_locked():
                    return
                self._counts["step_rows"] += len(active)
                self._m_occupancy.observe(len(active) / self.max_slots)
                self._apply_rows(active, {}, lambda s: (int(nxt[s.slot]),), now, finished,
                                 snaps)
            self._queue_snapshots(snaps)
        for s, reason, err in finished:
            self._notify_retired(s, reason, err)

    def _apply_rows(self, active, proposals, tokens_of, now, finished, snaps):
        """Under the engine lock: advance every running row by the tokens
        its program gave (``tokens_of(s)``: one for a plain row, a
        verify's k columns for a burst row, one with ``proposals``),
        emit them, collect the retired into ``finished`` and the
        snapshots their cadence asks for into ``snaps``, and free the
        retired rows' slots. A plain row follows the step; a burst row
        follows the reference's accept loop (decode.py :2434-2497):
        column j is emitted while the token fed at j was the real one, so
        every emitted token is plain greedy's."""
        drop = set()
        for s in active:
            s.req.peak_batch = max(s.req.peak_batch, len(active))
            every = s.req.snapshot_every
            cols = tokens_of(s)
            if id(s) not in proposals:
                reason = self._advance(s, cols[0], now, finished)
                # the cadence's snapshots, and at cadence 1 the first
                # token's even if the sequence retires there (the prefill
                # handoff)
                if (every and s.n_generated % every == 0 and reason != "deadline"
                        and (reason is None or s.n_generated == 1)):
                    snaps.append((s, s.pos, s.last_token, s.n_generated))
                if reason is not None:
                    drop.add(id(s))
                continue
            d = proposals[id(s)]
            n0, accepted, reason = s.n_generated, 0, None
            for j, u in enumerate(cols):
                if j > 0:
                    accepted += 1
                reason = self._advance(s, u, now, finished)
                if reason is not None:
                    break
                if j + 1 < len(cols) and d[j] != u:
                    self._counts["spec_rejected"] += 1
                    break  # the first rejection ends the burst
            self._counts["spec_iterations"] += 1
            self._counts["spec_accepted"] += accepted
            self._m_spec_accept.observe(accepted / (len(cols) - 1))
            if reason is not None:
                drop.add(id(s))
                continue
            # rollback by pointer: draft rows past the accepted run were
            # fed rejected tokens; the next catch-up overwrites them
            s.draft_pos = min(s.draft_pos, s.pos)
            if every and s.n_generated // every > n0 // every:
                snaps.append((s, s.pos, s.last_token, s.n_generated))
        for s in active:
            if id(s) in drop:
                self._slots.release(s.slot)
        if drop:
            self._active[:] = [x for x in self._active if id(x) not in drop]

    def _advance(self, s, tok, now, finished):
        """Under the engine lock: one token for ``s`` (its kv row at
        ``pos`` was written by the program); -> why it retires now (also
        appended to ``finished``), or None. The per-token budget is
        enforced at emit: a token that arrived late is not emitted and
        fails retryable ("deadline")."""
        s.pos += 1
        s.last_token = tok
        s.n_generated += 1
        if s.req.token_budget_s is not None and now - s.t_last > s.req.token_budget_s:
            finished.append((s, "deadline", DeadlineExceeded(
                f"{self.name}: token {s.n_generated} arrived {now - s.t_last:.3f}s after the "
                f"previous one (per-token budget {s.req.token_budget_s}s); slot purged")))
            return "deadline"
        self._emit(s, now)
        reason = self._stop_reason(s)
        if reason is not None:
            finished.append((s, reason, None))
        return reason

    def _queue_snapshots(self, snaps):
        """Under the exec lock, after the program that wrote their rows:
        queue each snapshot's device copy. A released slot's rows change
        only under the exec lock and behind the copy on the stream, so
        snapshots go out before the retirements (a finished request
        takes none, and a handoff's one-token sequence needs its
        block). A snapshot that fails costs that snapshot only: the stream
        keeps flowing without its resume point."""
        for s, p, last, n in snaps:
            t1 = time.perf_counter()
            try:
                chaos.hit("serving.decode.snapshot")
                arrays = self._slots.snapshot(s.slot, p)
            except Exception:  # noqa: BLE001 - degraded, never fatal
                traceback.print_exc()
                continue
            build = functools.partial(self._build_snapshot, s.req)
            s.req._push_snapshot(_Snapshot(build, arrays, p, last, n))
            with self._lock:
                self._counts["snapshots"] += 1
                self._snap_copy_ms.append((time.perf_counter() - t1) * 1e3)

    # ------------------------------------------------------- speculative
    def _token_at(self, s, p):
        """The sequence's real token at position ``p`` (the draft's
        catch-up feed): the prompt below its length, ``last_token`` at
        ``pos``, the emitted tokens between."""
        plen = s.req.prompt.size
        if p < plen:
            return int(s.req.prompt[p])
        if p == s.pos:
            return int(s.last_token)
        return int(s.req.tokens_so_far()[p - plen])

    def _spec_group(self, active, group):
        """One burst for the opted rows ``group`` inside one program over
        every running row of ``active`` (module docstring), all under the
        exec lock. -> False when the draft or the verify cannot run (its
        breaker refuses, or it raises; the failure goes to its key's
        breaker): nothing was emitted, the draft pointers are rolled back
        to rows fed real tokens, and the caller takes a plain step."""
        proposals = {id(s): [] for s in group}
        with self._exec_lock:
            nxt = None
            if (all(s.draft_pos is not None or self._draft_fill(s) for s in group)
                    and self._propose(active, group, proposals)):
                nxt = self._verify(active, proposals)
            if nxt is None:
                for s in group:
                    if s.draft_pos is not None:
                        s.draft_pos = min(s.draft_pos, s.pos)
                return False
            now = time.monotonic()
            finished, snaps = [], []
            with self._lock:
                if not self._current_locked():
                    return True
                self._apply_rows(active, proposals, lambda s: [int(t) for t in nxt[s.slot]],
                                 now, finished, snaps)
            self._queue_snapshots(snaps)
        for s, reason, err in finished:
            self._notify_retired(s, reason, err)
        return True

    def _propose(self, active, group, proposals):
        """Catch-up and propose: one draft step over every slot per call
        until every row of ``group`` has draft rows 0..pos+k-2, the
        argmaxes of its feeds at ``pos`` and later appended to its
        ``proposals``. -> False when a draft step cannot run."""
        K = self._spec_k

        def feed(s, p):
            # the token fed at draft position p: the real one up to pos,
            # then the draft's own proposals
            return self._token_at(s, p) if p <= s.pos else proposals[id(s)][p - s.pos - 1]

        while True:
            todo = {id(s) for s in group if s.draft_pos < s.pos + K - 1}
            if not todo:
                return True
            tokens = np.zeros(self.max_slots, np.int64)
            pos = np.zeros(self.max_slots, np.int32)
            for s in active:
                if s.draft_pos is not None:
                    # a row not catching up repeats its last feed, so its
                    # draft rows stay as they are
                    p = s.draft_pos if id(s) in todo else s.draft_pos - 1
                    tokens[s.slot], pos[s.slot] = feed(s, p), p
            if not self._breaker_probe(self._draft_step_key):
                return False
            try:
                nxt = self._run_rows(self._draft_step_key, tokens, pos, active)
            except Exception:  # noqa: BLE001 - the draft is best effort
                return False
            for s in group:
                if id(s) in todo:
                    if s.draft_pos >= s.pos:
                        proposals[id(s)].append(int(nxt[s.slot]))
                    s.draft_pos += 1

    def _verify(self, active, proposals):
        """The verify program over every slot: a burst row feeds
        ``[last_token, proposals]`` at ``pos..pos+k-1``, every other
        running row ``(last_token, pos)`` in all k columns. -> its argmax
        ``[max_slots, k]``, or None when it cannot run."""
        K = self._spec_k
        tokens = np.zeros((self.max_slots, K), np.int64)
        pos = np.zeros((self.max_slots, K), np.int32)
        for s in active:
            tokens[s.slot] = s.last_token
            pos[s.slot] = s.pos
            if id(s) in proposals:
                tokens[s.slot, 1:] = proposals[id(s)]
                pos[s.slot] += np.arange(K, dtype=np.int32)
        if not self._breaker_probe(self._verify_key):
            return None
        trace_id = next((s.req.trace_id for s in active if s.req.trace_id is not None), None)
        try:
            return self._run_rows(self._verify_key, tokens, pos, active, trace_id)
        except Exception:  # noqa: BLE001 - fall back, the requests unharmed
            return None

    def _draft_fill(self, s):
        """Under the exec lock, at a sequence's first burst: the draft's
        chunked fill of prompt rows 0..P-2 (its fill programs over the
        draft's staging), copied into draft row ``slot``; ``draft_pos`` =
        P-1, so the catch-up's first draft step re-feeds the last prompt
        token as the target's finishing step did. -> False when a fill
        cannot run."""
        P, C = s.req.prompt.size, self.page_len
        try:
            for start in range(0, P - 1, C):
                chunk = s.req.prompt[start:start + C]

                def fill(tokens, _, feats, chunk=chunk):
                    padded = np.zeros((1, C), np.int64)
                    padded[0, :chunk.size] = chunk
                    tokens.copy_(torch.from_numpy(padded))
                    for buf, f in zip(feats, s.req.features):
                        buf.copy_(torch.from_numpy(np.array(f[None])))

                key = ("draft_fill", 1, start + C)
                if not self._breaker_probe(key):
                    return False
                self._call(key, fill)
            self._draft_slots.copy_from(s.slot, self._draft_staging, P - 1)
        except Exception:  # noqa: BLE001 - the draft is best effort
            return False
        s.draft_pos = P - 1
        return True

    # ----------------------------------------------------------- helpers
    def _emit(self, s, now):
        """Deliver ``s``'s newest token, stamped at ``now`` (after it
        reached the host): the first token of a sequence feeds the TTFT
        histogram (from its enqueue), every later one the inter-token
        gap; a traced request gets its ``serving.decode.token`` span."""
        first = s.n_generated == 1
        gap = now - (s.req.t_enqueue if first else s.t_last)
        (self._m_ttft if first else self._m_intertoken).observe(gap)
        s.t_last = now
        self._m_tokens.inc()
        if s.req.trace_id is not None:
            obs_tracing.record_span("serving.decode.token", gap, trace_id=s.req.trace_id,
                                    engine=self.name, index=s.n_generated - 1, first=first)
        s.req._push(s.last_token)

    def _stop_reason(self, s):
        """Why this sequence retires now, or None."""
        if s.req.eos_token_id is not None and s.last_token == s.req.eos_token_id:
            return "eos"
        if s.n_generated >= s.req.max_new_tokens:
            return "max_tokens"
        if s.pos >= self.max_seq_len:
            return "max_seq_len"
        if s.req.cancelled:
            return "cancelled"
        return None

    def _notify_retired(self, s, reason, err=None):
        """Counters and completion for a sequence whose slot the caller
        already released. Runs outside the engine lock."""
        if reason == "deadline":
            self._m_deadline.inc(stage="late")
        self._m_retired.inc(reason=reason)
        if err is not None:
            s.req._fail(err)
        else:
            s.req._finish(reason)
            if s.req.trace_id is not None:
                obs_tracing.record_span("serving.decode.request",
                                        time.monotonic() - s.req.t_enqueue,
                                        trace_id=s.req.trace_id, engine=self.name,
                                        tokens=s.n_generated, reason=reason)

    def _take_inflight_locked(self):
        """Under the engine lock: take every joining, resuming and running
        sequence off the engine and free its slot (slots hold no page, so
        the prefix cache's refcounts are untouched); -> their requests."""
        joining, self._joining = self._joining, []
        resuming, self._resuming = self._resuming, []
        active, self._active = self._active, []
        for _, slot in joining:
            self._slots.release(slot)
        for e in resuming:
            self._slots.release(e[3])
        for s in active:
            self._slots.release(s.slot)
        return [r for r, _ in joining] + [e[0] for e in resuming] + [s.req for s in active]

    def _fail_all(self, err, dead=None):
        """Fail every queued, joining, resuming and running request with
        ``err`` and free their slots (close, or a card the scheduler cannot
        select, ``dead``, which closes the engine)."""
        with self._cond:
            if dead is not None:
                self._dead = dead
                self._closed = True
                self._closed_ev.set()
            pending, self._pending = self._pending, []
            pending += [e[0] for e in self._pending_resume]
            self._pending_resume = []
            inflight = self._take_inflight_locked()
            self._cond.notify_all()
        for r in pending + inflight:
            r._fail(err)

    # ----------------------------------------------------------- watchdog
    def _run_watchdog(self):
        """Restart a dead or wedged scheduler (the reference's
        ``_run_watchdog``): wedged is a heartbeat older than
        ``wedge_timeout`` while the oldest waiting request, or the
        stalest running sequence's last token, is older too, so a long
        legitimate step with fresh work is no wedge. It makes no device
        call."""
        while not self._closed_ev.wait(self.watchdog_interval):
            with self._lock:
                if self._closed:
                    return
                gen, th, hb = self._sched_gen, self._scheduler, self._heartbeat
                waiting = [r.t_enqueue for r in self._pending[:1]]
                waiting += [e[0].t_enqueue for e in self._pending_resume[:1]]
                waiting += [e[0].t_enqueue for e in self._joining + self._resuming]
                waiting += [s.t_last for s in self._active]
            now = time.monotonic()
            if not th.is_alive():
                self._restart_scheduler(gen, "died")
            elif (waiting and now - hb > self.wedge_timeout
                    and now - min(waiting) > self.wedge_timeout):
                self._restart_scheduler(gen, "wedged (heartbeat stale)")

    def _restart_scheduler(self, observed_gen, reason):
        """The reference's ``_restart_scheduler``: end generation
        ``observed_gen``, fail what it held in flight with
        :class:`SchedulerRestarted` and free their slots, and start a
        replacement that serves the queue (the queued requests and
        resumes stay queued)."""
        with self._cond:
            if self._closed or observed_gen != self._sched_gen:
                return  # already restarted, or closing
            self._sched_gen += 1
            gen = self._sched_gen
            stranded = self._take_inflight_locked()
            self._heartbeat = time.monotonic()
            t = threading.Thread(target=self._run_scheduler, args=(gen,),
                                 name=f"{self.name}-scheduler-g{gen}", daemon=True)
            self._scheduler = t
            # started under the lock: close() never joins an unstarted thread
            t.start()
            self._cond.notify_all()  # a superseded thread parked in wait()
        self._m_restarts.inc()
        if stranded:
            err = SchedulerRestarted(
                f"{self.name} decode scheduler {reason} and was restarted; this sequence was "
                "in flight: its tokens so far were delivered but no more will come; retry "
                "the request")
            self._m_retired.inc(len(stranded), reason="error")
            for r in stranded:
                r._fail(err)

    # -------------------------------------------------------------- lifecycle
    def warmup(self):
        """Build every program before serving (the reference's ``warmup``)
        and take the replica's identity (the weights digest, which at 7B
        copies the weights to the host) so that no stream pays for either:
        one fill program per chunk start below ``max_prompt_len``, and the
        step; with ``spec_enabled`` also the verify, the draft's step and
        its fill programs (the reference's speculative rungs). On a card
        each is warmed up and captured here. A step's, draft step's or
        verify's warm-up writes padding rows only (token 0 at position 0
        in every slot), and a fill's writes staging, so it needs an idle
        engine: no sequence running, joining or resuming. Counted nowhere
        but in the compiles. The engine's ``phase`` narrows the prompt
        rungs as the reference's narrows its ladder: a "decode" engine
        builds the first fill only (its sequences arrive as snapshots; a
        degraded fleet's prompt builds the rest at first use), a "prefill"
        or "both" engine every fill; the step, whose one program covers
        every position, is built in every phase. Returns the fills'
        ``start + C``; ``declared_buckets()`` the keys built."""
        rungs = list(range(self.page_len, self.max_prompt_len + 1, self.page_len))
        if self.phase == "decode":
            rungs = rungs[:1]
        keys = [("fill", 1, r) for r in rungs] + [self._step_key]
        if self.spec_enabled:
            # the draft's fills stay whole in every phase, as the
            # reference's draft_prefill ladder does
            keys += [("draft_fill", 1, r) for r in
                     range(self.page_len, self.max_prompt_len + 1, self.page_len)]
            keys += [self._draft_step_key, self._verify_key]
        with torch.inference_mode(), self._exec_lock:
            with self._lock:
                if self._active or self._joining or self._resuming:
                    raise RuntimeError("warmup() needs an idle engine")
            for key in keys:
                if key[0] != "fill" and key[0] != "draft_fill":
                    tokens, pos, feats = self._graphs_of(key).inputs(key)
                    for buf in (tokens, pos, *feats):
                        buf.zero_()
                self._program(key)
            self._identity()
        with self._lock:
            self._declared = sorted(set(keys))
        return rungs

    def declared_buckets(self):
        """The program keys the last ``warmup`` built (the reference's
        declared ladder)."""
        with self._lock:
            return list(self._declared)

    def stats(self):
        """Engine counters (the cmd-5 wire view's ``decode`` entry), in one
        lock acquisition. ``prefix_fill_steps``: fill replays; ``prefix``:
        the cache's counters (None when off); ``shared_pages``/
        ``live_pages``: of the page store; ``snapshots``: snapshots taken;
        ``resumes``: joins and refusals; ``snapshot_costs``: medians of
        the scheduler's ms to queue a snapshot's device copy (``copy_ms``,
        what a snapshot stalls the steps) and of a block's build on its
        consumer's thread (``encode_ms``: the copy to the host and the
        encoding) and ``bytes`` (None before the first).
        ``k1_launches``: K1 launches made inside the engine's calls;
        ``step_rows``: running rows summed over steps (mean
        occupancy = step_rows / (steps * max_slots)); ``step_ms_median``:
        of the last 4096 steps, host clock. ``programs``: the reference's
        map, ``"<phase><rows>x<seq>"`` -> builds (``compiles``: captures
        on a card; ``store_loads`` 0, no artifact store) and, for a graph,
        ``capture_ms``; ``graph_replays``: replays of every graph;
        ``graph_pool_bytes``: their shared memory pool;
        ``weights_digest_ms``: the digest's one-time cost (None until
        taken); ``compiles``: builds (captures on a card), every key's
        summed; ``scheduler_restarts``: the watchdog's restarts;
        ``stale_unwinds`` (the port's): superseded scheduler threads that
        ended at a program call. ``quarantine_shed``: requests a quarantined fill or step
        shed; a program's ``breaker``: its breaker's state (the
        reference's ``as_dict``); ``program_failures`` (the port's): every
        failure a breaker was told of, which a later success does not
        reset. ``spec``: the reference's view of
        speculative decoding; ``iterations``: bursts applied, one per
        opted row; ``accepted``: proposals accepted; ``rejected`` (the
        port's): bursts ended by a rejected proposal, so ``accepted /
        (accepted + rejected)`` is the share of the proposals checked
        that were accepted (1.0 for a draft that always proposes the
        target's token); ``verify_steps``:
        verify replays; ``draft_steps``: draft step replays;
        ``draft_prefills``: draft fill replays (a chunk each, where the
        reference counts one-shot draft prefills). ``steps`` counts the
        plain steps only. The draft's pool holds no pages (its rows come
        from its own fill), so ``live_pages``/``shared_pages`` are the
        page store's alone."""
        prefix = self._prefix.stats() if self._prefix is not None else None
        digest = self._model._digest
        graphs = [g for g in (self._graphs, self._draft_graphs) if g is not None]
        with self._lock:
            c = self._counts
            steps = {p: int(self._m_steps.value(phase=p))
                     for p in ("fill", "step", "verify", "draft_fill", "draft_step")}
            ms = sorted(self._step_ms)
            costs = {}
            cols = [("copy_ms", self._snap_copy_ms)]
            cols += zip(("encode_ms", "bytes"), zip(*self._snap_encode))
            for name, col in cols:
                if col:
                    costs[name] = sorted(col)[len(col) // 2]
            programs = {}
            for key, n in sorted(self._builds.items()):
                entry = {"compiles": n, "store_loads": 0}
                capture_ms = self._graphs_of(key).capture_ms
                if key in capture_ms:
                    entry["capture_ms"] = capture_ms[key]
                if key in self._breakers:
                    entry["breaker"] = self._breakers[key].as_dict()
                programs["%s%dx%d" % key] = entry
            return {
                "name": self.name,
                "phase": self.phase,
                "quant": self.quant,
                "mesh": self.mesh_desc,
                "device": str(self.device),
                "max_slots": self.max_slots,
                "max_seq_len": self.max_seq_len,
                "max_queue": self.max_queue,
                "active": len(self._active),
                "queue_depth": len(self._pending),
                "requests": int(self._m_requests.value()),
                "tokens": int(self._m_tokens.value()),
                "shed_count": int(self._m_shed.value(reason="queue_full")),
                "quarantine_shed": int(self._m_shed.value(reason="quarantine")),
                "program_failures": c["program_failures"],
                "deadline_expired": int(self._m_deadline.value(stage="expired")),
                "deadline_late": int(self._m_deadline.value(stage="late")),
                "scheduler_restarts": int(self._m_restarts.value()),
                "stale_unwinds": c["stale_unwinds"],
                "retired": {r: int(self._m_retired.value(reason=r)) for r in _RETIRE_REASONS},
                "prefix_fill_steps": steps["fill"],
                "steps": steps["step"],
                "step_rows": c["step_rows"],
                "step_ms_median": ms[len(ms) // 2] if ms else None,
                "k1_launches": c["k1_launches"],
                "prefix": prefix,
                "shared_pages": self._pages.shared_pages(),
                "live_pages": self._pages.live_pages(),
                "snapshots": c["snapshots"],
                "resumes": {"ok": c["resumes_ok"], "refused": c["resumes_refused"]},
                "resume_queue_depth": len(self._pending_resume),
                "snapshot_costs": costs or None,
                "weights_digest_ms": None if digest is None else digest[1],
                "kv_pool_bytes": self._slots.nbytes(),
                "staging_bytes": self._staging.nbytes(),
                "draft_kv_pool_bytes": (self._draft_slots.nbytes()
                                        if self._draft_slots is not None else 0),
                "spec": {
                    "enabled": self.spec_enabled,
                    "k": self._spec_k,
                    "iterations": c["spec_iterations"],
                    "accepted": c["spec_accepted"],
                    "rejected": c["spec_rejected"],
                    "verify_steps": steps["verify"],
                    "draft_steps": steps["draft_step"],
                    "draft_prefills": steps["draft_fill"],
                },
                "compiles": sum(self._builds.values()),
                "declared_programs": len(self._declared),
                "programs": programs,
                "cuda_graphs": self._graphs.capture,
                "graph_replays": sum(g.replays for gs in graphs for g in gs.graphs),
                "graph_pool_bytes": max(gs.pool_bytes for gs in graphs),
            }

    def health(self):
        now = time.monotonic()
        entries = self._prefix.stats()["entries"] if self._prefix is not None else 0
        with self._lock:
            alive = self._scheduler.is_alive()
            return {
                "ok": alive and not self._closed,
                "closed": self._closed,
                "phase": self.phase,
                "scheduler_alive": alive,
                "heartbeat_age_s": round(now - self._heartbeat, 3),
                "scheduler_restarts": int(self._m_restarts.value()),
                "quarantined_programs": sorted("%s%dx%d" % k for k, br in self._breakers.items()
                                               if br.state != _Breaker.CLOSED),
                "error": None if self._dead is None else repr(self._dead),
                "active": len(self._active),
                "free_slots": self._slots.free_count(),
                "queue_depth": len(self._pending),
                "declared_programs": len(self._declared),
                "mesh": self.mesh_desc,
                "prefix_entries": entries,
                "spec_enabled": self.spec_enabled,
                "device": str(self.device),
            }

    def close(self, timeout=5.0):
        """Stop the scheduler and the watchdog. Queued and running
        requests fail with EngineClosed (retryable on the wire); new
        submissions raise it. The engine's metrics leave the registry, and
        the prefix cache drops its pages once the scheduler is done."""
        with self._cond:
            already, self._closed = self._closed, True
            self._closed_ev.set()
            sched = self._scheduler
        obs_metrics.REGISTRY.unregister_collector(self._obs_collector)
        if not already:
            self._fail_all(EngineClosed(f"{self.name} is closing; retry elsewhere"))
        if self._watchdog is not None and self._watchdog is not threading.current_thread():
            self._watchdog.join(timeout)
        if sched is not threading.current_thread():
            sched.join(timeout)
            if self._prefix is not None and not sched.is_alive():
                with self._exec_lock:
                    self._prefix.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
