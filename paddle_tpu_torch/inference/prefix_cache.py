"""Content-addressed KV prefix cache (counterpart of
paddle_tpu/inference/prefix_cache.py), the in-memory tier.

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

**Not ported**: the persistent tier (``store_dir``, the reference's
``load_store``/``publish`` through the artifact store) raises
``NotImplementedError``; ``store_hits`` and ``store_refused`` read 0 and
``persistent`` False.

Concurrency, as in the reference: the page store is mutated only by the
owning engine's scheduler under its exec lock; the cache's own lock is a
leaf guarding the entry map and counters, so ``stats`` never waits on a
model call.
"""
import hashlib
import threading

import numpy as np

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


class PrefixCache:
    """The memory tier over ``pages``, an engine's page store (anything
    with ``page_len``, ``page_bytes()``, ``retain_page`` and
    ``drop_page``)."""

    def __init__(self, pages, max_bytes=None, store_dir=None, name="prefix"):
        if store_dir is not None:
            raise NotImplementedError("the persistent prefix tier (prefix_dir) is not ported "
                                      "yet (ROADMAP Queue 1)")
        self._pages = pages
        self.page_len = int(pages.page_len)
        self.name = name
        self.max_bytes = int(_DEFAULT_MAX_BYTES if max_bytes is None else max_bytes)
        self.max_pages = max(1, self.max_bytes // max(1, pages.page_bytes()))
        self._lock = threading.Lock()
        self._entries = {}  # hash hex -> [n_tokens, [page ids], tick]
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

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

    def clear(self):
        """Drop every entry (the caller holds the engine's exec lock);
        engine close calls this so the page store drains."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            for pid in e[1]:
                self._pages.drop_page(pid)

    def stats(self):
        with self._lock:
            return {
                "entries": len(self._entries),
                "pages": sum(len(e[1]) for e in self._entries.values()),
                "max_pages": self.max_pages,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "store_hits": 0,
                "store_refused": 0,
                "persistent": False,
            }
