"""Thread-safe counters, gauges and histograms, and the registry that
names them — the JAX package's serve-side metrics (``obs/metrics.py``)
as far as the query engine, its cache and its planner use them.

Registries are cheap instance objects: each engine owns one, and its
``describe()`` dict is a view over it.  :func:`default_registry` is the
one process-global registry, which holds the fault injector's firing
counters (faults.py).
"""

from __future__ import annotations

import threading


class Counter:
    """Monotonic (but resettable) counter with its own lock."""

    __slots__ = ("name", "_lock", "_n")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0  # guarded by: self._lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


class Gauge:
    """A value that goes up and down (vocab size, artifact bytes)."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0.0  # guarded by: self._lock

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Observation count and sum of one latency series (the JAX
    histogram's ``count`` / ``sum``, which the engine's op stats read)."""

    __slots__ = ("name", "_lock", "_count", "_sum")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0  # guarded by: self._lock
        self._sum = 0.0  # guarded by: self._lock

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += float(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class Registry:
    """Get-or-create home for named metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}  # guarded by: self._lock

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)


_default = Registry()


def default_registry() -> Registry:
    """The process-global registry (fault firings only: everything on
    the serving side lives on per-engine registries)."""
    return _default
