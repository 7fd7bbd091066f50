"""Wall-clock accounting: :class:`PhaseTimer` for one build run and
:class:`OpTimer` for the query engine's per-op latencies.

The build report has the JAX package's shape (``phases_ms``,
``total_ms``, then the counters flat), so the two packages' ``--stats``
lines compare key for key over the phases of the plans the port has:
pipelined ``tokenize_feed``, ``finalize_vocab``; one-shot ``load``,
``tokenize``, ``skew_stats``, ``feed``; streaming ``stream``; all-device
``load``, ``feed``, ``host_views``; all ``device_index``, ``fetch``,
``emit`` (and ``aborted_pipelined`` after a ``KeyOverflow`` restart,
``aborted_device_tokenize`` after a ``WidthOverflow`` one).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from . import metrics


class PhaseTimer:
    def __init__(self):
        self.phases: dict[str, float] = {}
        self.counters: dict = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def count(self, name: str, value) -> None:
        """Record a scalar alongside the timings (sets, not adds)."""
        self.counters[name] = value

    def report(self) -> dict:
        out = {
            "phases_ms": {k: round(v * 1e3, 3) for k, v in self.phases.items()},
            "total_ms": round(sum(self.phases.values()) * 1e3, 3),
        }
        out.update(self.counters)
        return out


class OpTimer:
    """Per-op latency of the serve engine, one histogram per op
    (``<prefix>_<op>_seconds`` on the registry); ``stats()`` has the JAX
    package's shape (``calls`` / ``total_ms`` / ``avg_us`` per op,
    sorted by op name)."""

    def __init__(self, registry: metrics.Registry | None = None,
                 prefix: str = "mri_engine_op"):
        self._registry = registry if registry is not None else metrics.Registry()
        self._prefix = prefix
        self._hists: dict[str, metrics.Histogram] = {}

    def _hist(self, op: str) -> metrics.Histogram:
        h = self._hists.get(op)
        if h is None:
            h = self._hists[op] = self._registry.histogram(f"{self._prefix}_{op}_seconds")
        return h

    @contextmanager
    def time(self, op: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._hist(op).observe(time.perf_counter() - t0)

    def histogram(self, op: str) -> metrics.Histogram:
        """The op's latency histogram, for a hot path that observes
        directly instead of paying for the context manager per call."""
        return self._hist(op)

    def stats(self) -> dict:
        out = {}
        for op in sorted(self._hists):
            h = self._hists[op]
            calls, secs = h.count, h.sum
            if not calls:
                continue
            out[op] = {"calls": calls, "total_ms": round(secs * 1e3, 3),
                       "avg_us": round(secs / calls * 1e6, 2)}
        return out
