"""Wall-clock phase accounting for one build run.

The report has the JAX package's shape (``phases_ms``, ``total_ms``,
then the counters flat), so the two packages' ``--stats`` lines compare
key for key over the phases of the plans the port has: pipelined
``tokenize_feed``, ``finalize_vocab``; one-shot ``load``, ``tokenize``,
``skew_stats``, ``feed``; streaming ``stream``; all-device ``load``,
``feed``, ``host_views``; all ``device_index``, ``fetch``, ``emit`` (and
``aborted_pipelined`` after a ``KeyOverflow`` restart,
``aborted_device_tokenize`` after a ``WidthOverflow`` one).
"""

from __future__ import annotations

import time
from contextlib import contextmanager


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
