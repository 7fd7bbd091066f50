"""LRU hot-term cache for decoded posting runs (the JAX package's
``serve/cache.py``).

The artifact stores postings delta-encoded; decoding is one cumsum per
term.  Under a Zipf workload a few hundred hot terms cover most lookups,
so the engine keeps their decoded arrays here — bounded by entry count
(hot terms are the frequent ones, so bounding by count bounds bytes by
roughly ``capacity * mean_hot_df * 4``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..obs import attribution as obs_attrib
from ..obs import metrics as obs_metrics

_MISSING = object()


class LRUCache:
    """Ordered-dict LRU with hit/miss counters.

    Thread-safe: the serve daemon shares one Engine (and therefore one
    cache) across every connection, so ``get``/``put`` race between the
    dispatcher and admin-stat readers.  A plain lock around the tiny
    OrderedDict ops costs ~100ns — noise next to the postings cumsum
    the cache exists to skip.
    """

    def __init__(self, capacity: int, *,
                 registry: obs_metrics.Registry | None = None,
                 prefix: str = "mri_cache", max_bytes: int = 0):
        if capacity < 0:
            raise ValueError(f"cache capacity must be >= 0, got {capacity}")
        if max_bytes < 0:
            raise ValueError(f"cache max_bytes must be >= 0, got {max_bytes}")
        self.capacity = capacity
        self.max_bytes = max_bytes  # 0 = unbounded by bytes
        self._data: OrderedDict = OrderedDict()  # guarded by: self._lock
        self._sizes: dict = {}        # key -> nbytes, guarded by: self._lock
        self._bytes = 0               # sum(self._sizes), guarded by: self._lock
        self._lock = threading.Lock()
        # hit/miss/eviction tallies are obs counters (each with its own
        # lock) so the engine's registry exposes them in the Prometheus
        # text; ``registry=None`` keeps them private to this cache.
        reg = registry if registry is not None else obs_metrics.Registry()
        self._prefix = prefix
        self._hits = reg.counter(f"{prefix}_hits_total")
        self._misses = reg.counter(f"{prefix}_misses_total")
        self._evictions = reg.counter(f"{prefix}_evictions_total")

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    def get(self, key, default=None):
        # the attribution feed sits beside the counter inc it mirrors:
        # the per-request cache tally can never drift from the registry
        coll = obs_attrib.active()
        with self._lock:
            value = self._data.get(key, _MISSING)
            if value is _MISSING:
                self._misses.inc()
                if coll is not None:
                    coll.cache_event(key, False, self._prefix)
                return default
            self._data.move_to_end(key)
            self._hits.inc()
        if coll is not None:
            coll.cache_event(key, True, self._prefix)
        return value

    def put(self, key, value, *, nbytes: int = 0) -> None:
        """Insert ``key``; ``nbytes`` is the caller-declared payload size
        counted against ``max_bytes`` (0 = entry-count bound only).  An
        entry larger than the whole byte budget is refused outright so
        one oversized payload cannot flush the working set."""
        with self._lock:
            if self.capacity == 0:
                return
            if self.max_bytes and nbytes > self.max_bytes:
                return
            if key in self._data:
                self._bytes -= self._sizes.get(key, 0)
                self._data.move_to_end(key)
            self._data[key] = value
            self._sizes[key] = nbytes
            self._bytes += nbytes
            while (len(self._data) > self.capacity
                   or (self.max_bytes and self._bytes > self.max_bytes)):
                old_key, _old = self._data.popitem(last=False)
                self._bytes -= self._sizes.pop(old_key, 0)
                self._evictions.inc()

    def peek(self, key, default=None):
        """``get`` without recency promotion or hit/miss accounting —
        for callers that only want to know whether paying the decode
        can be avoided (e.g. the v2 skip-AND arm)."""
        with self._lock:
            value = self._data.get(key, _MISSING)
            return default if value is _MISSING else value

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key) -> bool:  # no counter side effects
        with self._lock:
            return key in self._data

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def purge(self) -> int:
        """Drop every entry but keep the cumulative hit/miss/eviction
        tallies — the invalidation path, where history must survive the
        flush.  Returns the number of entries dropped."""
        with self._lock:
            n = len(self._data)
            self._data.clear()
            self._sizes.clear()
            self._bytes = 0
        return n

    def clear(self) -> None:
        self.purge()
        self._hits.reset()
        self._misses.reset()
        self._evictions.reset()

    def stats(self) -> dict:
        hits, misses = self._hits.value, self._misses.value
        total = hits + misses
        with self._lock:
            entries = len(self._data)
            nbytes = self._bytes
        return {
            "capacity": self.capacity,
            "entries": entries,
            "bytes": nbytes,
            "max_bytes": self.max_bytes,
            "hits": hits,
            "misses": misses,
            "evictions": self._evictions.value,
            "hit_rate": round(hits / total, 4) if total else 0.0,
        }
