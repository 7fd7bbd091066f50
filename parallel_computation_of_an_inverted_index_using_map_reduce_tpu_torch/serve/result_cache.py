"""Generation-keyed query-result cache (the JAX package's
``serve/result_cache.py``).

The serving layer recomputes every answer from postings on every
request; under a Zipf workload most requests are repeats of a small hot
set.  This cache stores whole response payloads keyed on
``(op, normalized terms, k, score, <epoch>)`` where the epoch is the
published segment-manifest generation — a live append, delete
or compact bumps the generation, so invalidation is exact and free: a
stale entry's key simply can never be probed again.  No TTLs, no
staleness window on the daemon.

Normalization is chosen so two requests share an entry *only* when the
engine provably returns byte-identical payloads for both:

- ``and`` / ``or``: results are ascending doc-id merges, independent of
  term order and duplicates — key is ``sorted(set(terms))``.
- ``top_k`` (ranked): BM25 adds per-term contributions in the query's
  term order, and float addition is not associative — the same terms
  in another order can score a document one ulp apart (or swap two near
  ties) — so key is the term tuple verbatim.  (The JAX package keys
  ``sorted(terms)`` here and so can answer one permutation with
  another's bytes; ROADMAP §C.)
- ``df`` / ``postings``: replies are positional per input term — key is
  the term tuple verbatim.
- letter ``top_k``: keyed on the letter (no terms).

Callers keep ``explain`` requests out of the cache (their payloads
carry per-request cost reports) and snapshot the generation under the
same lock that guards the engine they read, so a fill can never pair
old bytes with a new generation (see ``ServeDaemon._execute``).
"""

from __future__ import annotations

import json
import threading

from .cache import LRUCache
from ..obs import metrics as obs_metrics
from ..utils import envknobs

#: ops whose answers are cacheable (admin + mutation ops never are)
CACHEABLE_OPS = ("df", "postings", "and", "or", "top_k")


def key_for(op: str, terms, letter, k, score) -> tuple | None:
    """Epoch-free cache key for a request, or ``None`` when the request
    shape is not cacheable.  The caller appends the generation/epoch at
    probe and fill time."""
    if op not in CACHEABLE_OPS:
        return None
    if letter is not None:
        if op != "top_k":
            return None
        return ("top_k_letter", str(letter), int(k or 0), str(score or ""))
    if not terms:
        return None
    tt = tuple(str(t) for t in terms)
    if op in ("and", "or"):
        norm = tuple(sorted(set(tt)))
    else:  # ranked top_k (summed in term order), df / postings (positional)
        norm = tt
    return (op, norm, int(k or 0), str(score or ""))


class ResultCache:
    """LRU of full response payloads, bounded by entries and bytes.

    Thread-safe: probed on reader threads (daemon) / conn threads
    (router) while fills arrive from the dispatcher — the underlying
    :class:`LRUCache` lock covers both.  Stored and returned payloads
    are shallow copies, because ``_finish`` mutates its payload
    (``setdefault`` of id/trace_id) after the fact.
    """

    def __init__(self, *, registry: obs_metrics.Registry,
                 enabled: bool | None = None,
                 entries: int | None = None,
                 max_bytes: int | None = None,
                 prefix: str = "mri_serve_result_cache"):
        if enabled is None:
            enabled = bool(envknobs.get("MRI_SERVE_RESULT_CACHE"))
        if entries is None:
            entries = envknobs.get("MRI_SERVE_RESULT_CACHE_ENTRIES")
        if max_bytes is None:
            max_bytes = envknobs.get("MRI_SERVE_RESULT_CACHE_BYTES")
        self.enabled = bool(enabled)
        self._lru = LRUCache(int(entries) if self.enabled else 0,
                             registry=registry, prefix=prefix,
                             max_bytes=int(max_bytes))
        self._invalidations = registry.counter(f"{prefix}_invalidations_total")
        self._lock = threading.Lock()
        self._epoch = None  # last adopted epoch, guarded by: self._lock

    def lookup(self, key: tuple, epoch) -> dict | None:
        """Payload copy for ``key`` at ``epoch``, or ``None`` on miss."""
        if not self.enabled or key is None or epoch is None:
            return None
        hit = self._lru.get((key, epoch))
        return dict(hit) if hit is not None else None

    def fill(self, key: tuple, epoch, payload: dict) -> None:
        """Store a copy of ``payload`` under ``(key, epoch)``, sized by
        its JSON encoding (the bytes a hit saves re-serializing are the
        bytes it occupies)."""
        if not self.enabled or key is None or epoch is None:
            return
        try:
            nbytes = len(json.dumps(payload, separators=(",", ":")))
        except (TypeError, ValueError):
            return  # non-JSON payload: never cacheable on this protocol
        self._lru.put((key, epoch), dict(payload), nbytes=nbytes)

    def on_epoch(self, epoch) -> None:
        """Adopt a new epoch (generation bump or shard-vector change):
        entries keyed under older epochs can never be probed again, so
        drop them eagerly to free the byte budget."""
        if not self.enabled:
            return
        with self._lock:
            changed = epoch != self._epoch
            self._epoch = epoch
        if changed:
            self._invalidations.inc()
            self._lru.purge()

    def purge(self) -> None:
        """Drop everything without an epoch change — the reload path,
        where artifact content may change at an *unchanged* generation."""
        if not self.enabled:
            return
        self._invalidations.inc()
        self._lru.purge()

    def stats(self) -> dict:
        out = self._lru.stats()
        out["enabled"] = self.enabled
        out["invalidations"] = self._invalidations.value
        return out
