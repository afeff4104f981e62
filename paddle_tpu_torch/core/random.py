"""RNG (counterpart of paddle_tpu/core/random.py).

Two sources of randomness, as in the JAX package:

- Initialisation draws from a seeded ``torch.Generator``: weights are
  carried across from the JAX package where two runs must agree, so the
  port does not reproduce jax.random's samples.
- Dropout is keyed by the threefry key stream, which IS bit-identical to
  the JAX package's (``jax_threefry_partitionable`` mode): ``PRNGKey``,
  ``split``, ``fold_in`` and ``key_data`` are threefry2x32 written as
  host-side integer math on Python ints. A key is a tuple of two uint32
  words; a training step uses a few dozen, so the stream costs no
  device work and no device-to-host sync. ``Generator``, ``next_key`` and
  ``rng_guard`` hand keys out in the reference's order (a split of the
  global key, or ``fold_in(key, counter)`` inside a guarded scope).

The counter-hash pieces (``fmix32``, ``keep_thresh_u32``,
``fast_keep_mask``) are bit-identical too: dropout masks and the flash
kernels' in-kernel masks are built from them. On tensors, uint32
arithmetic is done in int64 masked to 32 bits, with each multiply split in
16-bit halves so no product leaves int64's range.

Sampling draws from jax.random's own stream, bitwise: ``random_bits``
(jax's partitionable ``bits``), ``uniform``, ``gumbel`` (jax's default
"low" mode) and ``categorical``. Their keys are the ``(hi, lo)`` words of
a host key, or a 2-word int64 tensor on the device (``key_tensor``), which
``split`` splits there: a captured CUDA graph advances such a key without
the host.
"""
import contextlib
import contextvars
import math

import numpy as np
import torch

from .place import resolve_device

U32 = 0xFFFFFFFF

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & U32


def threefry2x32(key, count):
    """Threefry-2x32 with 20 rounds (the block function of jax.random):
    two uint32 key words and two uint32 counter words -> two uint32
    words, as Python ints."""
    k0, k1 = key[0] & U32, key[1] & U32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (count[0] + ks[0]) & U32
    x1 = (count[1] + ks[1]) & U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & U32
    return x0, x1


def PRNGKey(seed):
    """jax.random.PRNGKey with 32-bit integers (jax's default): the high
    word is 0 and the low word is the seed's 32 bits."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return (0, seed & U32)


def split(key, num=2):
    """jax.random.split in the partitionable mode: key i is
    threefry2x32(key, (0, i)). A host key gives a list of word tuples; a
    device key (``key_tensor``) gives an int64 tensor [num, 2], split on
    its device."""
    if isinstance(key, torch.Tensor):
        words = threefry2x32(key, (0, torch.arange(int(num), device=key.device)))
        return torch.stack(words, dim=-1)
    return [threefry2x32(key, (0, i)) for i in range(int(num))]


def key_tensor(key, device="cuda"):
    """A host key's two words as an int64 tensor [2] on ``device``."""
    return torch.tensor(key_data(key), dtype=torch.int64, device=resolve_device(device))


def fold_in(key, data):
    """jax.random.fold_in: threefry2x32(key, PRNGKey(data)) with ``data``
    taken as uint32."""
    return threefry2x32(key, (0, int(data) & U32))


def key_data(key):
    """The key's two uint32 words, as ``jax.random.key_data`` gives them."""
    return (key[0] & U32, key[1] & U32)


class Generator:
    """The stateful key source behind ``paddle.seed`` (the reference's
    ``Generator``): every ``next_key`` splits the held key in two, keeps
    the first half and hands out the second."""

    def __init__(self, seed=0):
        self.manual_seed(seed)

    def manual_seed(self, seed):
        self._seed = int(seed)
        self._key = PRNGKey(self._seed)
        return self

    @property
    def initial_seed(self):
        return self._seed

    def next_key(self):
        self._key, sub = split(self._key)
        return sub

    def get_state(self):
        return self._key

    def set_state(self, state):
        self._key = key_data(state)


_GLOBAL_GENERATOR = torch.Generator().manual_seed(0)
_KEY_GENERATOR = Generator(0)

# (key, [counter]) supplied by a guarded scope (a training step)
_RNG_SCOPE = contextvars.ContextVar("rng_scope", default=None)
# (table, [counter]) inside a captured program (key_table_guard)
_KEY_TABLE = contextvars.ContextVar("key_table", default=None)
# (rank, local batch) inside a data-parallel step (dp_shard_guard)
_DP_SHARD = contextvars.ContextVar("dp_shard", default=None)


def seed(s):
    """paddle.seed: reseed the initialisation generator and the key
    stream."""
    _KEY_GENERATOR.manual_seed(int(s))
    _GLOBAL_GENERATOR.manual_seed(int(s))
    return _GLOBAL_GENERATOR


def default_generator():
    """The ``torch.Generator`` the initializers draw from."""
    return _GLOBAL_GENERATOR


@contextlib.contextmanager
def rng_guard(key):
    """Supply an explicit key for the enclosed random ops: the n-th of them
    gets ``fold_in(key, n)``."""
    token = _RNG_SCOPE.set((key_data(key), [0]))
    try:
        yield
    finally:
        _RNG_SCOPE.reset(token)


@contextlib.contextmanager
def key_table_guard(table):
    """Inside a program being captured: the n-th random op gets row n of
    ``table`` (an int64 [rows, 2] tensor, the program's runtime input) as
    its key, two int64 scalar tensors, so the keys are fed at each run and
    not baked into the program. Yields a one-item list holding how many
    keys were taken; past the table's rows the keys repeat row 0 and the
    caller captures again with a larger table."""
    counter = [0]
    token = _KEY_TABLE.set((table, counter))
    try:
        yield counter
    finally:
        _KEY_TABLE.reset(token)


@contextlib.contextmanager
def dp_shard_guard(rank, local_batch):
    """Inside a data-parallel training step: this process holds rows
    ``[rank * local_batch, (rank + 1) * local_batch)`` of the global batch.
    The reference's mesh step is one program over the global batch, so its
    dropout masks are the global ones; inside this guard
    ``fast_keep_mask`` and the flash kernels draw this rank's slice of
    them (``dp_offset``). Rank 0 of any guard draws what no guard draws."""
    token = _DP_SHARD.set((int(rank), int(local_batch)))
    try:
        yield
    finally:
        _DP_SHARD.reset(token)


def dp_offset(shape, per_row):
    """The offset of this rank's slice of a global tensor whose leading
    axis is the batch: ``rank * local_batch * per_row`` (``per_row``: the
    elements, or batch-heads, one batch row holds), or 0 outside
    ``dp_shard_guard``. Raises where the leading axis is not the local
    batch: the mask drawn there would not be the global one."""
    shard = _DP_SHARD.get()
    if shard is None:
        return 0
    rank, local_batch = shard
    if len(shape) == 0 or int(shape[0]) != local_batch:
        raise ValueError(
            f"dropout under a data-parallel step on a tensor of shape {tuple(shape)}: its "
            f"leading axis is not the local batch ({local_batch}), so this rank's mask "
            "would not be its slice of the global one")
    return rank * local_batch * int(per_row)


def next_key():
    """A fresh key for one random op."""
    table = _KEY_TABLE.get()
    if table is not None:
        rows, counter = table
        i = counter[0]
        counter[0] += 1
        row = rows[i if i < rows.shape[0] else 0]
        return (row[0], row[1])
    scope = _RNG_SCOPE.get()
    if scope is not None:
        key, counter = scope
        sub = fold_in(key, counter[0])
        counter[0] += 1
        return sub
    return _KEY_GENERATOR.next_key()


def keep_thresh_u32(keep_prob):
    """keep probability -> uint32 comparison threshold (the same value the
    JAX package's functional dropout and flash kernel compare against)."""
    return min(int(float(keep_prob) * 4294967296.0), 4294967295)


def mul32(a, c):
    """(a * c) mod 2**32 for an int64 tensor ``a`` in [0, 2**32) and a
    Python int constant ``c`` in [0, 2**32)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def fmix32(h):
    """murmur3's 32-bit avalanche finalizer on int64 tensors holding
    uint32 values."""
    h = h & U32
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fast_keep_mask(key, keep_prob, shape, device="cuda"):
    """Counter-hash Bernoulli keep mask for dropout (the reference's
    ``fast_keep_mask``): the flat element index times the golden-ratio
    constant, each key word folded in by its own mix round, then fmix32,
    compared against the keep threshold. Built on ``device`` (the card
    unless the caller asks for the CPU) in int64 tensor math; bitwise the
    reference's mask for the same key and shape. Inside ``dp_shard_guard``
    the flat index starts at this rank's offset in the global tensor, so
    the ranks' masks concatenate to the global mask."""
    device = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n == 0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    first = dp_offset(shape, n // shape[0]) if shape else 0
    idx = torch.arange(first, first + n, dtype=torch.int64, device=device) & U32
    h = mul32(idx, 0x9E3779B1)
    for w in key_data(key):
        h = mul32(h ^ w, 0x85EBCA6B)
        h = h ^ (h >> 13)
    return (fmix32(h) < keep_thresh_u32(keep_prob)).reshape(shape)


def random_bits(key, shape, device="cuda"):
    """jax.random.bits (uint32, jax's partitionable threefry): the flat
    index of each element, split into its high and low 32 bits, through
    threefry2x32 under ``key``; the two output words xor-ed. An int64
    tensor of uint32 values, on the device key's card or on ``device``."""
    dev = key.device if isinstance(key, torch.Tensor) else resolve_device(device)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=dev)
    bits1, bits2 = threefry2x32(key, (idx >> 32, idx & U32))
    return (bits1 ^ bits2).reshape(tuple(shape))


def uniform(key, shape, minval=0.0, maxval=1.0, device="cuda"):
    """jax.random.uniform in float32: the top 23 bits of ``random_bits``
    as the mantissa of a float in [1, 2), minus 1, scaled to [minval,
    maxval) in float32 and floored at minval."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp_min(floats * float(span) + float(lo), float(lo))


def gumbel(key, shape, device="cuda"):
    """jax.random.gumbel in float32, jax's default ("low") mode:
    -log(-log(u)) of u uniform in [tiny, 1)."""
    u = uniform(key, shape, float(np.finfo(np.float32).tiny), 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key, logits):
    """jax.random.categorical over the last axis of float32 ``logits``
    (the Gumbel-max trick): the first maximum of logits + gumbel noise.
    int64 indices."""
    return torch.argmax(gumbel(key, logits.shape, logits.device) + logits, dim=-1)


# ---------------------------------------------------------------- more of
# jax.random's samplers, as jax computes them (the ``paddle.*`` random ops)

_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def normal(key, shape, device="cuda"):
    """jax.random.normal in float32: sqrt(2) * erfinv(u), u uniform in
    (-1, 1). ``torch.erfinv`` is not XLA's polynomial, so a value may
    differ from jax's by a few ulp (tests/test_torch_tensor_api.py)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return torch.erfinv(uniform(key, shape, lo, 1.0, device)) * _SQRT2_F32


def exponential(key, shape, device="cuda"):
    """jax.random.exponential in float32: -log1p(-u)."""
    return -torch.log1p(-uniform(key, shape, 0.0, 1.0, device))


def bernoulli(key, p):
    """jax.random.bernoulli: uniform(key, p.shape) < p (float32 ``p``)."""
    return uniform(key, tuple(p.shape), 0.0, 1.0, p.device) < p


def randint(key, shape, minval, maxval, device="cuda"):
    """jax.random.randint in int32: two words of bits per element (keys
    split from ``key``), each reduced modulo the span and combined in
    uint32 arithmetic as jax combines them."""
    i32_max = 2**31 - 1
    out_of_range = maxval > i32_max
    minval = min(max(int(minval), -2**31), i32_max)
    maxval = min(max(int(maxval), -2**31), i32_max)
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = (maxval - minval) & U32
    if maxval <= minval:
        span = 1
    if out_of_range and maxval > minval:
        span = (span + 1) & U32
    if span == 0:  # a span of 2**32 wraps to 0: the remainders do nothing
        offset = (mul32(higher, 0) + lower) & U32
    else:
        mult = (2**16 % span) * (2**16 % span) % span
        offset = ((mul32(higher % span, mult) + lower % span) & U32) % span
    val = (minval + offset + 2**31) % 2**32 - 2**31
    return val.to(torch.int32)


def permutation(key, n, device="cuda"):
    """jax.random.permutation of arange(n): rounds of a stable sort keyed
    by 32 random bits, as many rounds as jax's heuristic asks."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int32, device=resolve_device(device))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), x.device), stable=True).indices
        x = x[order]
    return x


def _poisson_knuth(key, lam):
    k = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros(lam.shape, dtype=torch.float32, device=lam.device)
    rng = key
    while bool((log_prod > -lam).any()):
        rng, sub = split(rng)
        k = torch.where(log_prod > -lam, k + 1, k)
        log_prod = log_prod + torch.log(uniform(sub, tuple(lam.shape), 0.0, 1.0, lam.device))
    return k - 1


def _poisson_rejection(key, lam):
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    shape = tuple(lam.shape)
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=lam.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=lam.device)
    while not bool(accepted.all()):
        key, sub0, sub1 = split(key, 3)
        u = uniform(sub0, shape, 0.0, 1.0, lam.device) - 0.5
        v = uniform(sub1, shape, 0.0, 1.0, lam.device)
        u_shifted = 0.5 - torch.abs(u)
        k = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = -lam + k * log_lam - torch.lgamma(k + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out.to(torch.int32)


def poisson(key, lam):
    """jax.random.poisson in int32 for float32 rates ``lam``: Knuth's method
    below 10, Hormann's transformed rejection from 10, both from the same
    key (the rejection loop runs only where a rate needs it: jax computes
    both and selects, and the selection alone reads it)."""
    lam = lam.to(torch.float32)
    use_knuth = torch.isnan(lam) | (lam < 10)
    result = _poisson_knuth(key, torch.where(use_knuth, lam, torch.zeros_like(lam)))
    if not bool(use_knuth.all()):
        rejection = _poisson_rejection(key, torch.where(use_knuth, torch.full_like(lam, 1e5),
                                                        lam))
        result = torch.where(use_knuth, result, rejection)
    return torch.where(lam == 0, torch.zeros_like(result), result)
