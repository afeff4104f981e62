"""Content-addressed KV prefix cache (counterpart of
paddle_tpu/inference/prefix_cache.py): the in-memory tier and the
persistent tier.

Decode traffic shares prefixes (system prompts, few-shot templates,
multi-turn history); the KV rows of a prefix depend only on its tokens
and the sequence's features. Token prefixes are hashed at page
boundaries, and the rows of each cached prefix live once, as pages of
the engine's device page store (``decode._PageStore``), so a hit fills
only the uncached suffix.

**Chain hashing**, bitwise the reference's::

    h_0       = sha256("pfx0:" + feature_seed(features))
    h_{i+1}   = sha256(h_i || tokens[i*page : (i+1)*page] as int32 bytes)

Two prompts share an entry exactly when their token pages and their
feature bytes agree.

**The memory tier** maps ``hash -> (n_tokens, page ids, tick)`` with LRU
eviction under a page budget: ``max_bytes // page_bytes`` pages, counted
per entry as the reference counts them (a page shared by two chain
entries counts twice). ``max_bytes`` defaults to 256 MiB, the
reference's ``_DEFAULT_MAX_BYTES``; the port reads no environment
variable, so the reference's ``PADDLE_TPU_PREFIX_*`` knobs are the
engine's arguments here.

**The persistent tier** (``store_dir``, the reference's
``PADDLE_TPU_PREFIX_DIR``): an artifact store (serialize/
artifact_store.py) of kv-snapshot blocks, one for the longest chain
boundary of each filled prompt, keyed by the replica's identity (model
fingerprint, weights digest, quant, mesh) and the prefix hash, so a
fresh replica, or a prefill-pool replica of a disaggregated fleet,
inherits the fleet's warm prefixes with no fill. A block is the
reference's (``publish``: the prompt's first ``n`` tokens, no generated
token, the KV rows ``[n, *trailing]`` per kv_spec entry in their wire
dtype, bf16 widened to f32 exactly), and one whose header identity,
page geometry or tokens skew from this replica is refused, counted in
``store_refused`` and never installed: wrong-model KV must never decode.
The tier's share of the byte budget is the store's retention cap:
``max_bytes`` bounds both tiers, as in the reference.

Concurrency, as in the reference: the page store is mutated only by the
owning engine's scheduler under its exec lock; the cache's own lock is a
leaf guarding the entry map and counters, so ``stats`` never waits on a
model call.
"""
import hashlib
import threading

import numpy as np

from ..serialize import artifact_store as _artifacts
from . import wire_spec as _wire_spec

__all__ = ["PrefixCache", "feature_seed", "prefix_hashes"]

_DEFAULT_MAX_BYTES = 256 << 20


def feature_seed(features):
    """Digest of a request's feature arrays (dtype/shape/bytes): the
    chain-hash seed, so feature-skewed requests never share entries."""
    h = hashlib.sha256(b"pfx-feat:")
    for f in features:
        a = np.ascontiguousarray(np.asarray(f))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.digest()


def prefix_hashes(prompt_i32, page_len, seed=b""):
    """Chain hashes at every full-page boundary of ``prompt_i32``:
    ``[(page_len, h1), (2*page_len, h2), ...]`` (hex digests), longest
    last."""
    prompt = np.ascontiguousarray(np.asarray(prompt_i32, dtype=np.int32))
    h = hashlib.sha256(b"pfx0:" + seed)
    out = []
    for i in range(prompt.size // int(page_len)):
        page = prompt[i * page_len:(i + 1) * page_len]
        h = hashlib.sha256(h.digest() + page.tobytes())
        out.append(((i + 1) * int(page_len), h.hexdigest()))
    return out


def _wire_dtype(dt):
    """The numpy dtype a kv buffer of (torch or numpy) dtype ``dt``
    travels as in a block: 16-bit floats widened to f32."""
    name = str(dt).replace("torch.", "")
    return np.dtype(np.float32) if name in ("bfloat16", "float16") else np.dtype(name)


class PrefixCache:
    """The memory tier over ``pages``, an engine's page store (anything
    with ``page_len``, ``kv_spec``, ``page_bytes()``, ``retain_page``,
    ``drop_page`` and, for the persistent tier, ``pages_from_arrays``),
    and the persistent tier at ``store_dir``. ``identity_fn`` returns the
    replica's identity for the persistent tier (a dict of
    ``fingerprint``, ``weights``, ``quant`` and ``mesh``), called lazily
    because the weights digest is costly."""

    def __init__(self, pages, max_bytes=None, store_dir=None, name="prefix",
                 identity_fn=None):
        self._pages = pages
        self.page_len = int(pages.page_len)
        self.name = name
        self._identity_fn = identity_fn
        self.max_bytes = int(_DEFAULT_MAX_BYTES if max_bytes is None else max_bytes)
        self.max_pages = max(1, self.max_bytes // max(1, pages.page_bytes()))
        self._store = None
        if store_dir:
            self._store = _artifacts.ArtifactStore(store_dir, max_bytes=self.max_bytes)
        self._lock = threading.Lock()
        self._entries = {}  # hash hex -> [n_tokens, [page ids], tick]
        self._tick = 0
        self._published = set()  # hashes already pushed to the store
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.store_hits = 0
        self.store_refused = 0
    def lookup(self, hashes):
        """Longest cached prefix among ``hashes`` (the chain, longest
        last) -> ``(n_tokens, page_ids)`` or None; counts a hit or a
        miss."""
        with self._lock:
            for _, hx in reversed(hashes):
                e = self._entries.get(hx)
                if e is not None:
                    self._tick += 1
                    e[2] = self._tick
                    self.hits += 1
                    return e[0], list(e[1])
            self.misses += 1
            return None

    def insert(self, hx, n_tokens, pages):
        """Retain ``pages`` as the entry for ``hx`` and evict LRU entries
        beyond the page budget; -> the number evicted (0 when ``hx`` was
        cached already: a duplicate retains nothing). The caller holds
        the engine's exec lock."""
        with self._lock:
            if hx in self._entries:
                return 0
            for pid in pages:
                self._pages.retain_page(pid)
            self._tick += 1
            self._entries[hx] = [int(n_tokens), list(pages), self._tick]
            evict = []
            while (sum(len(e[1]) for e in self._entries.values()) > self.max_pages
                   and len(self._entries) > 1):
                lru = min(self._entries, key=lambda k: self._entries[k][2])
                evict.append(self._entries.pop(lru))
            for e in evict:
                for pid in e[1]:
                    self._pages.drop_page(pid)
                self.evictions += 1
            return len(evict)

    def needs_publish(self, hx):
        """Would :meth:`publish` write ``hx``? Lets the engine skip the
        block's copy when there is no persistent tier or the prefix
        shipped already."""
        if self._store is None or self._store.disabled:
            return False
        with self._lock:
            return hx not in self._published

    def clear(self):
        """Drop every entry (the caller holds the engine's exec lock);
        engine close calls this so the page store drains."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            for pid in e[1]:
                self._pages.drop_page(pid)

    # --------------------------------------------------- persistent tier
    def _identity(self):
        ident = self._identity_fn() if self._identity_fn else None
        if not ident or not ident.get("fingerprint"):
            return None
        return ident

    def _store_key(self, hx, n_tokens, ident):
        """The reference's key: the fingerprint as the model, the pages as
        the bucket, the geometry, prefix hash and weights in the
        signature."""
        sig = (("decode:prefix", (self.page_len, int(n_tokens))),
               (hx, ()),
               ("w" + ident["weights"][:16], ()))
        return _artifacts.ArtifactKey(ident["fingerprint"], int(n_tokens) // self.page_len, sig,
                                      mesh=ident["mesh"], quant=ident["quant"])

    def load_store(self, hashes, prompt_i32):
        """Longest persistent-tier prefix among ``hashes`` -> ``(hx,
        n_tokens, kv_arrays)`` or None. File IO: the caller holds no
        engine lock and installs the arrays under it
        (:meth:`install_arrays`). A block whose identity skews from this
        replica is refused (counted), never installed."""
        if self._store is None or self._store.disabled:
            return None
        ident = self._identity()
        if ident is None:
            return None
        for n_tokens, hx in reversed(hashes):
            payload = self._store.get(self._store_key(hx, n_tokens, ident))
            if payload is None:
                continue
            got = self._check_block(payload, hx, n_tokens, ident, prompt_i32)
            if got is not None:
                with self._lock:
                    self.store_hits += 1
                return hx, n_tokens, got
        return None

    def _check_block(self, payload, hx, n_tokens, ident, prompt_i32):
        """Identity, geometry and content must all match, else refuse (a
        foreign KV prefix decodes garbage; a miss is always preferable)."""
        try:
            header, arrays, _ = _wire_spec.decode_kv_snapshot_off(payload)
        except Exception:  # noqa: BLE001 - a corrupt block is a refusal
            with self._lock:
                self.store_refused += 1
            return None
        kv_spec = self._pages.kv_spec
        ok = (header.get("fingerprint") == ident["fingerprint"]
              and header.get("weights") == ident["weights"]
              and header.get("quant") == ident["quant"]
              and header.get("mesh") == ident["mesh"]
              and int(header.get("page_len", -1)) == self.page_len
              and int(header.get("pos", -1)) == int(n_tokens)
              and header.get("prefix_hash") == hx
              and len(arrays) == 2 + len(kv_spec))
        if ok:
            stored = arrays[0]
            ok = (stored.ndim == 1 and stored.size == int(n_tokens)
                  and np.array_equal(stored, np.asarray(prompt_i32[:n_tokens], dtype=np.int32)))
        if ok:
            for a, (tr, dt) in zip(arrays[2:], kv_spec):
                if tuple(a.shape) != (int(n_tokens),) + tuple(tr) or a.dtype != _wire_dtype(dt):
                    ok = False
                    break
        if not ok:
            with self._lock:
                self.store_refused += 1
            return None
        return list(arrays[2:])

    def install_arrays(self, hx, n_tokens, kv_arrays):
        """Make a store-loaded prefix pages of the page store and insert
        its entry (the caller holds the engine's exec lock) -> the entry's
        page ids."""
        pages = self._pages.pages_from_arrays(kv_arrays, n_tokens)
        with self._lock:
            if hx in self._entries:
                # an identical prompt got there first: keep its entry
                for pid in pages:
                    self._pages.drop_page(pid)
                return list(self._entries[hx][1])
            self._tick += 1
            self._entries[hx] = [int(n_tokens), list(pages), self._tick]
        return pages

    def publish(self, hx, n_tokens, prompt_i32, kv_copies):
        """Best-effort persistent publish (file IO: the caller holds no
        engine lock) of the reference's block: the full replica identity
        and page geometry in its header, what :meth:`load_store` checks
        at the other end. ``kv_copies``: the rows ``[n_tokens,
        *trailing]`` per kv_spec entry in their wire dtype."""
        if self._store is None or self._store.disabled:
            return False
        with self._lock:
            if hx in self._published:
                return False
            self._published.add(hx)
        ident = self._identity()
        if ident is None:
            return False
        prompt = np.ascontiguousarray(np.asarray(prompt_i32[:n_tokens], dtype=np.int32))
        header = {
            "fingerprint": ident["fingerprint"],
            "weights": ident["weights"],
            "quant": ident["quant"],
            "mesh": ident["mesh"],
            "pos": int(n_tokens),
            "last_token": int(prompt[-1]),
            "n_generated": 0,
            "prompt_len": int(n_tokens),
            "page_len": self.page_len,
            "prefix_hash": hx,
        }
        arrays = [prompt, np.zeros((0,), np.int32)] + list(kv_copies)
        try:
            blob = _wire_spec.encode_kv_snapshot(header, arrays)
        except Exception:  # noqa: BLE001 - publish is best-effort
            return False
        return self._store.put(self._store_key(hx, n_tokens, ident), blob)

    def stats(self):
        with self._lock:
            return {
                "entries": len(self._entries),
                "pages": sum(len(e[1]) for e in self._entries.values()),
                "max_pages": self.max_pages,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "store_hits": self.store_hits,
                "store_refused": self.store_refused,
                "persistent": self._store is not None,
            }
