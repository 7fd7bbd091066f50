"""The hot-term posting cache's counters (the JAX package's
``serve/cache.py`` ``LRUCache``), as far as the device engine uses it.

The device engine decodes on the card and never fills the cache; it
keeps one so ``describe()["cache"]`` has the JAX keys.  The lookups and
the LRU eviction arrive with the host engine (ROADMAP A9c).
"""

from __future__ import annotations

from ..obs import metrics as obs_metrics


class LRUCache:
    """An empty cache of ``capacity`` entries with hit/miss/eviction
    counters on a registry."""

    def __init__(self, capacity: int, *, registry: obs_metrics.Registry | None = None,
                 prefix: str = "mri_cache", max_bytes: int = 0):
        if capacity < 0:
            raise ValueError(f"cache capacity must be >= 0, got {capacity}")
        if max_bytes < 0:
            raise ValueError(f"cache max_bytes must be >= 0, got {max_bytes}")
        self.capacity = capacity
        self.max_bytes = max_bytes
        reg = registry if registry is not None else obs_metrics.Registry()
        self._hits = reg.counter(f"{prefix}_hits_total")
        self._misses = reg.counter(f"{prefix}_misses_total")
        self._evictions = reg.counter(f"{prefix}_evictions_total")

    def clear(self) -> None:
        self._hits.reset()
        self._misses.reset()
        self._evictions.reset()

    def stats(self) -> dict:
        hits, misses = self._hits.value, self._misses.value
        total = hits + misses
        return {
            "capacity": self.capacity,
            "entries": 0,
            "bytes": 0,
            "max_bytes": self.max_bytes,
            "hits": hits,
            "misses": misses,
            "evictions": self._evictions.value,
            "hit_rate": round(hits / total, 4) if total else 0.0,
        }
