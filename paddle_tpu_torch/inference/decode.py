"""Continuous-batching autoregressive decode engine (counterpart of
paddle_tpu/inference/decode.py).

A request is a *sequence* that yields one token per model step until eos,
its token cap or the engine's length cap. One scheduler thread re-forms
the running batch every iteration, so sequences join the moment a slot
frees and leave the moment they finish::

    requests --> bounded queue --> scheduler iteration
                  (shed, purge)      |
                                     v
      each joiner: PREFILL [1, seq_bucket(P)] -> its slot's KV rows 0..P-1
                                     |
      every slot:  STEP [max_slots] -> one token per running sequence
                                     |
      retire on eos / max_new_tokens / max_seq_len / deadline / cancel

**KV on the device, a step row is a slot.** The reference keeps paged KV
in host numpy and gathers the active slots into a fresh ``[rows, seq_b,
...]`` batch every step. Here each ``kv_spec`` entry is one pool on the
engine's device, zero-filled, holding every slot's rows at once
(:class:`_KVSlots`). The prefill writes a joiner's prompt rows into its
slot; each step runs **all** ``max_slots`` rows (free slots are padding
rows: token 0, position 0), and row ``i`` writes its new KV at ``(i,
positions[i])`` and attends over slot ``i`` in place. Nothing is gathered
or copied per step, and the step has one shape for the engine's life.

**Bitwise contract** (the reference's, decode.py:40-52): a sequence
decoded inside a continuous batch emits exactly the tokens it emits
decoded alone in an engine of the same configuration, under greedy
decoding, across joins and leaves. What keeps it here is one rule: the M
of every product a sequence passes through is a constant of the engine
(a step always runs ``max_slots`` rows) or a function of that sequence
alone (a prefill runs one joiner at ``[1, seq_bucket(P)]``), never of its
neighbours; and the model's attention over a slot reads only that slot's
rows below its length (K1's per-row ``k_len``), so the pool's width and
the other rows never enter it. As in the reference, every first token
comes from step-shaped maths: a cold prefill is finished by feeding the
last prompt token at position P-1 through the step, here as the joiner's
row of the next regular step (the reference runs that *finishing step*
as its own dispatch; the tokens are the same).

**Model contract** (:class:`DecodeModel`), torch functions on the
engine's device::

    prefill_fn(params, tokens[1, p] int64, lengths[1] int32, *feat)
        -> (logits[1, vocab] at the last valid position, *kv)
        one kv tensor per kv_spec entry, its batch axis 1 and its
        sequence axis p long; the engine copies rows 0..P-1 into the
        joiner's slot of the pool.
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
program per ``(phase, rows, seq)`` key): the engine has one program per
key, ``("step", max_slots, max_seq_len)`` for its life and ``("prefill",
1, seq_bucket(P))`` per prompt bucket, each the model's function over
static buffers that live as long as the engine (tokens, positions or
lengths, feature rows, and the step's argmax ``int32 [max_slots]``). On a
card each is warmed up on a side stream and captured once into a CUDA
graph (core/cuda_graph.py), all in one memory pool; a step or prefill is
then a copy of its inputs into the buffers and one replay. ``warmup``
captures them all; otherwise each is captured at its first use. A CPU
engine, or a CUDA one built with ``cuda_graph=False`` (to compare with
the graphs), runs the same functions eagerly over the same buffers. A
capture or replay that fails raises and fails its requests retryable, as
a failed step does; nothing runs the eager step in its place.

**Robustness kept**: the bounded queue (:class:`EngineOverloaded`),
per-token deadlines (the wire budget bounds the time to the first token
and every gap after it; a blown budget fails retryable and frees the slot
at once), cancellation between iterations, and a failed prefill or step
failing its requests retryable with their slots freed. There is no
fallback: a CUDA engine whose kernel fails to build or launch fails the
requests in flight, and never drops to the CPU or a plain version.

Not ported (ROADMAP Queue 1): the artifact store, breakers, the
watchdog and scheduler restarts, obs metrics, spans and chaos sites, kv
snapshots and resume (cmds 9/10, the handoff bit), the prefix cache,
speculative decoding, quantized and meshed serving, and phases (the
reference's engine decodes greedily, as this one does). Constructor
options of those raise ``NotImplementedError``; a
snapshot cadence raises ``ValueError``; the speculative opt-in is
accepted and ignored, as the reference ignores it without a draft model.
"""
import collections
import threading
import time
import traceback

import numpy as np
import torch

from ..core.cuda_graph import Graph, pool_bytes
from ..core.place import resolve_device
from ..ops import flash_attention
from .batching import (DeadlineExceeded, EngineClosed, EngineOverloaded, RetryableError,
                       bucket_rows)

# prompt / token dtypes of the wire spec (codes 1 and 2): streamed chunks
# echo the prompt's dtype
_TOKEN_DTYPES = (np.dtype(np.int32), np.dtype(np.int64))

_RETIRE_REASONS = ("eos", "max_tokens", "max_seq_len", "deadline", "error", "cancelled")

# options of the reference's engine that are not ported, and the values
# that ask for nothing (the reference's "off")
_UNPORTED = {
    "store": (None,), "quant": (None, "f32"), "mesh": (None, "single"),
    "phase": (None, "both"), "spec_k": (None, 0), "prefix": (None, False),
    "prefix_dir": (None,), "prefix_max_bytes": (None,), "breaker_threshold": (None,),
    "breaker_cooldown": (None,), "watchdog_interval": (None, 0, 0.0),
    "wedge_timeout": (None,),
}


def seq_bucket(n, min_bucket, max_len):
    """Power-of-2 sequence-length bucket: next pow2 >= n, floored at
    ``min_bucket``, clamped to ``max_len`` (the ladder's top rung)."""
    if n <= 0:
        raise ValueError(f"need length >= 1, got {n}")
    return max(min_bucket, bucket_rows(n, max_len))


def _indexed(device):
    """``device`` with its card's index ("cuda" -> "cuda:<current>")."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _torch_dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


class DecodeModel:
    """The prefill/step functions of a model, their parameters and the
    shape contract (module docstring).

    ``kv_spec``: ``(trailing_shape, dtype)`` per KV buffer (a torch or
    numpy dtype); ``kv_seq_axis``: where the sequence axis sits in the
    pool ``[slots, ...]``. ``feature_spec``: ``(trailing_shape, numpy
    dtype)`` per per-sequence feature array (any wire dtype). ``device``:
    where ``params`` live, the card unless the caller asks for the CPU
    (it raises without a card); the engine runs there. ``max_slots`` and
    ``max_seq_len``: the engine shape the functions were built for, if
    they fix one (an engine given none takes them)."""

    def __init__(self, params, prefill_fn, step_fn, kv_spec, vocab_size, feature_spec=(),
                 eos_token_id=None, kv_seq_axis=1, device="cuda", max_slots=None,
                 max_seq_len=None):
        self.params = params
        self.prefill_fn = prefill_fn
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


class _KVSlots:
    """Per-slot KV storage on the device: one pool per kv_spec entry,
    ``[max_slots, *trailing]`` with ``max_seq_len`` rows at the sequence
    axis, zero-filled once. A slot is a row of every pool; the step writes
    and reads the pools in place, so ``pools`` are handed to the model as
    they are. Rows past a sequence's length are never read (the model
    masks them), so a released slot is not cleared."""

    def __init__(self, max_slots, max_seq_len, kv_spec, seq_axis, device):
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.seq_axis = int(seq_axis)
        self.pools = []
        for tr, dt in kv_spec:
            if not 1 <= self.seq_axis <= len(tr) + 1:
                raise ValueError(f"kv_seq_axis {seq_axis} does not fit a kv buffer of "
                                 f"trailing shape {tr}")
            shape = list(tr)
            shape.insert(self.seq_axis - 1, self.max_seq_len)
            self.pools.append(torch.zeros([self.max_slots] + shape, dtype=dt,
                                          device=device))
        self._free = list(range(self.max_slots - 1, -1, -1))

    def free_count(self):
        return len(self._free)

    def nbytes(self):
        return sum(p.numel() * p.element_size() for p in self.pools)

    def alloc(self):
        return self._free.pop() if self._free else None

    def release(self, slot):
        self._free.append(slot)

    def write_prefill(self, slot, kv, length):
        """Copy rows 0..length-1 of a prefill's kv (batch row 0, one
        tensor per pool) into ``slot``."""
        ax = self.seq_axis - 1
        for pool, src in zip(self.pools, kv):
            pool[slot].narrow(ax, 0, length).copy_(src[0].narrow(ax, 0, length))


class _Graphs:
    """The engine's programs (the reference's ``_Programs``), keyed
    ``(phase, rows, seq)``: ``inputs(key)`` gives a program's static input
    buffers (made once, on the engine's device) and ``build(key)`` its
    ``run()``, the model's function over them. The step's run returns the
    argmax ``int32 [rows]`` in a static buffer; a prefill's returns its
    logits and kv. With ``capture`` each build is a CUDA graph, warmed up
    and captured in the shared pool ``pool`` (``run`` replays it);
    without, ``run`` is the function itself."""

    def __init__(self, model, pools, device, capture):
        self._model = model
        self._pools = pools
        self.device = device
        self.capture = capture
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.pool_bytes = 0
        self.capture_ms = {}  # key -> ms
        self.graphs = []
        self._inputs = {}

    def inputs(self, key):
        """(tokens int64, positions / lengths int32, [feature rows]) of
        ``key``: the step's tokens and positions ``[rows]``, a prefill's
        tokens ``[rows, seq]`` and lengths ``[rows]`` (1 until filled)."""
        bufs = self._inputs.get(key)
        if bufs is None:
            phase, rows, seq = key
            dev = self.device
            tokens = torch.zeros((rows,) if phase == "step" else (rows, seq), dtype=torch.int64,
                                 device=dev)
            at = (torch.zeros if phase == "step" else torch.ones)(rows, dtype=torch.int32,
                                                                  device=dev)
            feats = [torch.zeros((rows,) + tr, dtype=_torch_dtype(dt), device=dev)
                     for tr, dt in self._model.feature_spec]
            bufs = self._inputs[key] = (tokens, at, feats)
        return bufs

    def build(self, key):
        m = self._model
        tokens, at, feats = self.inputs(key)
        if key[0] == "step":
            nxt = torch.zeros(key[1], dtype=torch.int32, device=self.device)

            def fn():
                logits = m.step_fn(m.params, tokens, at, *self._pools, *feats)
                # greedy on the device (the first maximum, as np.argmax):
                # only [rows] int32 comes back
                nxt.copy_(torch.argmax(logits.float(), dim=-1))
                return nxt
        else:
            def fn():
                return m.prefill_fn(m.params, tokens, at, *feats)
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
    """

    __slots__ = ("prompt", "features", "max_new_tokens", "eos_token_id", "token_budget_s",
                 "trace_id", "token_dtype", "t_enqueue", "peak_batch", "_cond", "_tokens",
                 "_taken", "_done", "_error", "finish_reason", "cancelled")

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
        self._cond = threading.Condition()
        self._tokens = []
        self._taken = 0
        self._done = False
        self._error = None
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


class _Seq:
    """One running sequence: its request, slot, and the token the next
    step feeds at ``pos``. A joiner starts at ``pos`` = P-1 with its last
    prompt token (the finishing step) and nothing generated."""

    __slots__ = ("req", "slot", "pos", "last_token", "n_generated", "t_last")

    def __init__(self, req, slot):
        self.req = req
        self.slot = slot
        self.pos = req.prompt.size - 1
        self.last_token = int(req.prompt[-1])
        self.n_generated = 0
        # the first token's budget runs from the enqueue
        self.t_last = req.t_enqueue


class DecodeEngine:
    """Continuous-batching decode front end (module docstring).

    ``submit`` enqueues a sequence and returns its :class:`DecodeRequest`;
    ``generate`` is the blocking form. Any number of threads may submit;
    one scheduler thread runs the iteration loop on ``device`` (default
    "cuda", which raises without a card; the model's params must live
    there). ``cuda_graph``: on a card, run the programs as captured CUDA
    graphs (the default); False runs them eagerly there too, to compare."""

    def __init__(self, model, max_slots=None, max_seq_len=None, max_queue=64,
                 min_seq_bucket=8, max_prompt_len=None, default_max_new_tokens=64,
                 name="decode", device="cuda", cuda_graph=True, **unported):
        for key, val in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"DecodeEngine got an unexpected keyword argument {key!r}")
            if val not in _UNPORTED[key]:
                raise NotImplementedError(f"DecodeEngine({key}={val!r}): not ported yet "
                                          "(ROADMAP Queue 1)")
        self.device = _indexed(resolve_device(device))
        if _indexed(model.device) != self.device:
            raise ValueError(f"the model's params live on {model.device}, the engine runs "
                             f"on {self.device}")
        for key, val in (("max_slots", max_slots), ("max_seq_len", max_seq_len)):
            built = getattr(model, key)
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
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if self.max_prompt_len > self.max_seq_len:
            raise ValueError("max_prompt_len cannot exceed max_seq_len")
        self._slots = _KVSlots(self.max_slots, self.max_seq_len, model.kv_spec,
                               model.kv_seq_axis, self.device)
        cuda = self.device.type == "cuda"
        self._graphs = _Graphs(model, self._slots.pools, self.device, cuda and cuda_graph)
        self._step_key = ("step", self.max_slots, self.max_seq_len)
        # host staging of the step's inputs (pinned on a card), copied into
        # the step program's buffers
        self._h_tokens = torch.zeros(self.max_slots, dtype=torch.int64, pin_memory=cuda)
        self._h_pos = torch.zeros(self.max_slots, dtype=torch.int32, pin_memory=cuda)
        self._h_feats = [torch.zeros((self.max_slots,) + tr, dtype=_torch_dtype(dt),
                                     pin_memory=cuda) for tr, dt in model.feature_spec]
        self._programs = {}  # key -> run
        self._builds = collections.Counter()  # key -> builds (captures on a card)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # one model call or build at a time; reentrant, so a call builds its
        # program at first use under the lock it already holds
        self._exec_lock = threading.RLock()
        self._pending = []  # FIFO of DecodeRequest
        self._joining = []  # (req, slot): popped, slot held, not yet prefilled
        self._active = []   # _Seq
        self._closed = False
        self._dead = None   # the exception that ended the scheduler
        self._counts = collections.Counter()
        self._retired = collections.Counter()
        self._step_ms = collections.deque(maxlen=4096)
        self._scheduler = threading.Thread(target=self._run_scheduler,
                                           name=f"{name}-scheduler", daemon=True)
        self._scheduler.start()

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens=None, features=(), token_budget_s=None,
               trace_id=None, eos_token_id=None, snapshot_every=None, speculative=False):
        """Enqueue one sequence; -> :class:`DecodeRequest`.

        ``prompt``: 1-D (or [1, P]) int32/int64 token ids in the model's
        vocabulary (the output echoes the dtype). ``features``: arrays
        matching the model's ``feature_spec``. ``token_budget_s``: the
        per-token budget (first token and every gap). ``snapshot_every``
        other than 0/None raises (kv snapshots are not ported);
        ``speculative`` is accepted and ignored (no draft model)."""
        del speculative
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
        if snapshot_every:
            raise ValueError("kv snapshots (snapshot_every) are not ported yet")
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
        req = DecodeRequest(np.ascontiguousarray(prompt.astype(np.int64)), features,
                            max_new_tokens, eos, token_budget_s, trace_id, token_dtype)
        with self._cond:
            if self._closed:
                raise EngineClosed(f"{self.name} is closed")
            if len(self._pending) >= self.max_queue:
                self._counts["shed"] += 1
                raise EngineOverloaded(f"{self.name} decode queue full ({len(self._pending)} "
                                       f"waiting, cap {self.max_queue}); request shed")
            self._pending.append(req)
            self._counts["requests"] += 1
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
            self._cond.notify_all()

    # --------------------------------------------------------- scheduler
    def _run_scheduler(self):
        try:
            with torch.inference_mode():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                self._scheduler_loop()
        except BaseException as e:  # noqa: BLE001 - fail what is in flight
            traceback.print_exc()
            self._fail_all(RetryableError(f"{self.name}: the decode scheduler died "
                                          f"({type(e).__name__}: {e}); retry the request"),
                           dead=e)

    def _scheduler_loop(self):
        while True:
            joiners = self._wait_for_work()
            if joiners is None:
                return
            for req, slot in joiners:
                self._prefill(req, slot)
            self._purge_blown_budgets()
            if self._active:
                self._step_group()

    def _wait_for_work(self):
        """Park until there is work; pop this iteration's joiners, each
        with a slot (bounded by the free slots). None = exit."""
        with self._cond:
            while True:
                self._purge_expired_pending_locked(time.monotonic())
                self._pending[:] = [r for r in self._pending if not r.cancelled]
                if self._closed:
                    return None
                if self._active or self._pending:
                    break
                self._cond.wait()
            while self._pending and self._slots.free_count():
                self._joining.append((self._pending.pop(0), self._slots.alloc()))
            return list(self._joining)

    def _purge_expired_pending_locked(self, now):
        """A queued request whose per-token budget elapsed before it could
        join is dropped without compute."""
        expired = [r for r in self._pending if r.token_budget_s is not None
                   and now - r.t_enqueue >= r.token_budget_s]
        for r in expired:
            self._pending.remove(r)
            self._counts["deadline_expired"] += 1
            r._fail(DeadlineExceeded(f"{self.name}: per-token budget elapsed before the "
                                     "sequence could join; dropped without compute"))

    def _purge_blown_budgets(self):
        """Retire running sequences that were cancelled or blew their
        per-token budget, before the next step, so the slot frees now."""
        now = time.monotonic()
        purged = []
        with self._lock:
            if self._closed:
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

    # ----------------------------------------------------- the two paths
    def _program(self, key):
        """The program of ``key``, built once (the reference's
        ``_program``): every build holds the exec lock, so warmup and the
        scheduler never build one key twice, and a capture never overlaps
        another model call. On a card a build warms the function up over
        its buffers as they are, then captures it."""
        with self._lock:
            run = self._programs.get(key)
        if run is not None:
            return run
        with self._exec_lock:
            with self._lock:
                run = self._programs.get(key)
            if run is None:
                run = self._graphs.build(key)
                with self._lock:
                    self._programs[key] = run
                    self._builds[key] += 1
        return run

    def _call(self, key, fill):
        """Under the exec lock: ``fill`` the inputs of ``key``'s program,
        build it at first use, run it; K1's launches in the run counted
        for stats (a replay credits those of its capture)."""
        with self._exec_lock:
            fill(*self._graphs.inputs(key))
            run = self._program(key)
            before = flash_attention.launches
            try:
                return run()
            finally:
                self._counts["k1_launches"] += flash_attention.launches - before

    def _prefill(self, req, slot):
        """Run one joiner's prompt at [1, seq_bucket(P)] and write its KV
        rows 0..P-1 into its slot; it then joins the running set, and its
        first token comes from its row of the next step."""
        P = req.prompt.size
        bucket = seq_bucket(P, self.min_seq_bucket, self.max_seq_len)

        def fill(tokens, lengths, feats):
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :P] = req.prompt
            tokens.copy_(torch.from_numpy(padded))
            lengths.fill_(P)
            for buf, f in zip(feats, req.features):
                buf.copy_(torch.from_numpy(f[None]))

        err = None
        try:
            with self._exec_lock:  # the outputs stay the program's until copied
                outs = self._call(("prefill", 1, bucket), fill)
                self._slots.write_prefill(slot, outs[1:], P)
        except Exception as e:  # noqa: BLE001 - fail this joiner
            err = e if isinstance(e, RetryableError) else RetryableError(
                f"{self.name}: prefill failed ({type(e).__name__}: {e}); retry the request")
        with self._lock:
            if self._closed:
                return  # close() failed the request and released the slot
            self._joining.remove((req, slot))
            if err is None:
                self._counts["prefills"] += 1
                self._active.append(_Seq(req, slot))
            else:
                self._slots.release(slot)
                self._retired["error"] += 1
        if err is not None:
            req._fail(err)

    def _step_group(self):
        """One step over every slot: the running sequences' rows and
        padding rows for the free slots."""
        active = list(self._active)
        tokens, pos = self._h_tokens.numpy(), self._h_pos.numpy()
        feats = [h.numpy() for h in self._h_feats]
        tokens[:] = 0
        pos[:] = 0
        for f in feats:
            f[:] = 0
        for s in active:
            tokens[s.slot] = s.last_token
            pos[s.slot] = s.pos
            for f, v in zip(feats, s.req.features):
                f[s.slot] = v

        def fill(d_tokens, d_pos, d_feats):
            d_tokens.copy_(self._h_tokens, non_blocking=True)
            d_pos.copy_(self._h_pos, non_blocking=True)
            for d, h in zip(d_feats, self._h_feats):
                d.copy_(h, non_blocking=True)

        t0 = time.monotonic()
        try:
            with self._exec_lock:
                nxt = self._call(self._step_key, fill).cpu().numpy()
        except Exception as e:  # noqa: BLE001 - fail the whole step batch
            err = e if isinstance(e, RetryableError) else RetryableError(
                f"{self.name}: decode step failed ({type(e).__name__}: {e}); retry the "
                "request")
            with self._lock:
                if self._closed:
                    return
                for s in active:
                    self._slots.release(s.slot)
                drop = {id(s) for s in active}
                self._active[:] = [x for x in self._active if id(x) not in drop]
                self._retired["error"] += len(active)
            for s in active:
                s.req._fail(err)
            return
        now = time.monotonic()
        finished = []
        with self._lock:
            if self._closed:
                return
            self._counts["steps"] += 1
            self._counts["step_rows"] += len(active)
            self._step_ms.append((now - t0) * 1e3)
            drop = set()
            for s in active:
                s.req.peak_batch = max(s.req.peak_batch, len(active))
                s.pos += 1
                s.last_token = int(nxt[s.slot])
                s.n_generated += 1
                # per-token budget enforced at emit: a token that arrived
                # late fails retryable and frees the slot
                if (s.req.token_budget_s is not None
                        and now - s.t_last > s.req.token_budget_s):
                    finished.append((s, "deadline", DeadlineExceeded(
                        f"{self.name}: token {s.n_generated} arrived {now - s.t_last:.3f}s "
                        f"after the previous one (per-token budget {s.req.token_budget_s}s);"
                        " slot purged")))
                else:
                    self._emit(s, now)
                    reason = self._stop_reason(s)
                    if reason is None:
                        continue
                    finished.append((s, reason, None))
                self._slots.release(s.slot)
                drop.add(id(s))
            if drop:
                self._active[:] = [x for x in self._active if id(x) not in drop]
        for s, reason, err in finished:
            self._notify_retired(s, reason, err)

    # ----------------------------------------------------------- helpers
    def _emit(self, s, now):
        s.t_last = now
        self._counts["tokens"] += 1
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
        with self._lock:
            if reason == "deadline":
                self._counts["deadline_late"] += 1
            self._retired[reason] += 1
        if err is not None:
            s.req._fail(err)
        else:
            s.req._finish(reason)

    def _fail_all(self, err, dead=None):
        """Fail every queued, joining and running request with ``err`` and
        free their slots (close, or a dead scheduler)."""
        with self._cond:
            if dead is not None:
                self._dead = dead
                self._closed = True
            pending, self._pending = self._pending, []
            joining, self._joining = self._joining, []
            active, self._active = self._active, []
            for _, slot in joining:
                self._slots.release(slot)
            for s in active:
                self._slots.release(s.slot)
            self._cond.notify_all()
        for r in pending + [r for r, _ in joining] + [s.req for s in active]:
            r._fail(err)

    # -------------------------------------------------------------- lifecycle
    def warmup(self):
        """Build every program before serving (the reference's ``warmup``):
        one prefill per prompt bucket (the ladder from ``min_seq_bucket`` to
        ``max_prompt_len``'s bucket) and the step. On a card each is warmed
        up and captured here, so no request pays a capture. The step's
        warm-up writes padding rows only (token 0 at position 0 in every
        slot), so it needs an idle engine: no sequence running or joining.
        Counted nowhere. Returns the prompt buckets."""
        top = seq_bucket(self.max_prompt_len, self.min_seq_bucket, self.max_seq_len)
        prompt_buckets, b = [], self.min_seq_bucket
        while b < top:
            prompt_buckets.append(b)
            b <<= 1
        prompt_buckets.append(top)
        with torch.inference_mode(), self._exec_lock:
            with self._lock:
                if self._active or self._joining:
                    raise RuntimeError("warmup() needs an idle engine")
            tokens, pos, feats = self._graphs.inputs(self._step_key)
            for buf in (tokens, pos, *feats):
                buf.zero_()
            for pb in prompt_buckets:
                self._program(("prefill", 1, pb))
            self._program(self._step_key)
        return prompt_buckets

    def stats(self):
        """Engine counters (the cmd-5 wire view's ``decode`` entry), in one
        lock acquisition. ``k1_launches``: K1 launches made inside the
        engine's prefill and step calls; ``step_rows``: running rows summed
        over steps (mean occupancy = step_rows / (steps * max_slots));
        ``step_ms_median``: of the last 4096 steps, host clock. ``programs``:
        the reference's map, ``"<phase><rows>x<seq>"`` -> builds
        (``compiles``: captures on a card; ``store_loads`` 0, no artifact
        store) and, for a graph, ``capture_ms``; ``graph_replays``: replays
        of every graph; ``graph_pool_bytes``: their shared memory pool."""
        with self._lock:
            c = self._counts
            ms = sorted(self._step_ms)
            programs = {}
            for key, n in sorted(self._builds.items()):
                entry = {"compiles": n, "store_loads": 0}
                if key in self._graphs.capture_ms:
                    entry["capture_ms"] = self._graphs.capture_ms[key]
                programs["%s%dx%d" % key] = entry
            return {
                "name": self.name,
                "device": str(self.device),
                "max_slots": self.max_slots,
                "max_seq_len": self.max_seq_len,
                "max_queue": self.max_queue,
                "active": len(self._active),
                "queue_depth": len(self._pending),
                "requests": c["requests"],
                "tokens": c["tokens"],
                "shed_count": c["shed"],
                "deadline_expired": c["deadline_expired"],
                "deadline_late": c["deadline_late"],
                "retired": {r: self._retired[r] for r in _RETIRE_REASONS},
                "prefills": c["prefills"],
                "steps": c["steps"],
                "step_rows": c["step_rows"],
                "step_ms_median": ms[len(ms) // 2] if ms else None,
                "k1_launches": c["k1_launches"],
                "kv_pool_bytes": self._slots.nbytes(),
                "programs": programs,
                "cuda_graphs": self._graphs.capture,
                "graph_replays": sum(g.replays for g in self._graphs.graphs),
                "graph_pool_bytes": self._graphs.pool_bytes,
            }

    def health(self):
        with self._lock:
            alive = self._scheduler.is_alive()
            return {
                "ok": alive and not self._closed,
                "closed": self._closed,
                "scheduler_alive": alive,
                "error": None if self._dead is None else repr(self._dead),
                "active": len(self._active),
                "free_slots": self._slots.free_count(),
                "queue_depth": len(self._pending),
                "device": str(self.device),
            }

    def close(self, timeout=5.0):
        """Stop the scheduler. Queued and running requests fail with
        EngineClosed (retryable on the wire); new submissions raise it."""
        with self._cond:
            already, self._closed = self._closed, True
        if not already:
            self._fail_all(EngineClosed(f"{self.name} is closing; retry elsewhere"))
        if self._scheduler is not threading.current_thread():
            self._scheduler.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
