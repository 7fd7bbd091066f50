"""Wall-clock accounting: :class:`PhaseTimer` for one build run and
:class:`OpTimer` for the query engine's per-op latencies.

The build report has the JAX package's shape (``phases_ms``,
``total_ms``, then the counters flat), so the two packages' ``--stats``
lines compare key for key over the phases of the plans the port has:
pipelined ``tokenize_feed``, ``finalize_vocab``; one-shot ``load``,
``tokenize``, ``skew_stats``, ``feed``; streaming ``stream``; all-device
``load``, ``feed``, ``host_views``; all ``device_index``, ``fetch``,
``emit`` (and ``aborted_pipelined`` after a ``KeyOverflow`` restart,
``aborted_device_tokenize`` after a ``WidthOverflow`` one).  The port
adds ``card_wait_ms`` on the card: the host's time blocked on the card
(:func:`wait_on_card`), reached through the running build's timer
(:func:`current`) the way ``faults.current_report()`` reaches its report;
:func:`step` reaches it the same way for steps below the plans.

Given a span collector (``obs.chrometrace.TraceEvents``, ``--trace-out``)
every phase, :meth:`PhaseTimer.step` and wait on the card is also a span;
without one only the times and counters are kept.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from . import metrics


class Step:
    """One timed step of a loop: ``ms`` after the body ends without an
    exception (None before, or when it raised).  With a span collector
    it is also a span, the parent of the spans recorded inside it, whose
    ``args`` carry the thread's CPU ms (``cpu_ms``) when ``cpu`` is set."""

    __slots__ = ("name", "trace", "cpu", "ms", "_t0", "_c0")

    def __init__(self, name: str, trace=None, *, cpu: bool = False):
        self.name, self.trace, self.cpu = name, trace, cpu
        self.ms: float | None = None

    def __enter__(self) -> Step:
        if self.trace is not None:
            self.trace.enter(self.name)
            if self.cpu:
                self._c0 = time.thread_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self.trace is not None:
            self.trace.leave()
            if exc_type is None:
                args = ({"cpu_ms": round((time.thread_time() - self._c0) * 1e3, 3)}
                        if self.cpu else None)
                self.trace.span(self.name, self._t0, t1, args=args)
        if exc_type is None:
            self.ms = (t1 - self._t0) * 1e3
        return False


class PhaseTimer:
    def __init__(self, trace=None):
        self.phases: dict[str, float] = {}
        self.counters: dict = {}
        self.trace = trace
        self._lock = threading.Lock()
        self._card_wait_s = 0.0  # guarded by: self._lock
        self._card_waits = 0  # guarded by: self._lock

    @contextmanager
    def phase(self, name: str):
        if self.trace is not None:
            self.trace.enter(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.phases[name] = self.phases.get(name, 0.0) + t1 - t0
            if self.trace is not None:
                self.trace.leave()
                self.trace.span(name, t0, t1)

    def step(self, name: str) -> Step:
        """A :class:`Step` on this run's collector, with its CPU ms."""
        return Step(name, self.trace, cpu=True)

    def card_waited(self, t0: float, t1: float) -> None:
        """Add one wait of the host on the card (``perf_counter`` s)."""
        with self._lock:
            self._card_wait_s += t1 - t0
            self._card_waits += 1
        if self.trace is not None:
            self.trace.span("card_wait", t0, t1)

    def count(self, name: str, value) -> None:
        """Record a scalar alongside the timings (sets, not adds)."""
        self.counters[name] = value

    def report(self) -> dict:
        out = {
            "phases_ms": {k: round(v * 1e3, 3) for k, v in self.phases.items()},
            "total_ms": round(sum(self.phases.values()) * 1e3, 3),
        }
        out.update(self.counters)
        with self._lock:
            if self._card_waits:
                out["card_wait_ms"] = round(self._card_wait_s * 1e3, 3)
        return out


_current_lock = threading.Lock()
_current: PhaseTimer | None = None


def current() -> PhaseTimer | None:
    """The timer of the build running in this process (None outside one)."""
    with _current_lock:
        return _current


def make_current(timer: PhaseTimer | None) -> None:
    """Make ``timer`` the running build's (None: no build runs)."""
    global _current
    with _current_lock:
        _current = timer


def step(name: str) -> Step:
    """A :class:`Step` of the running build (a span with its CPU ms), or
    a bare timed step outside one: for code below the plans, which
    reaches the timer the way :func:`wait_on_card` does."""
    timer = current()
    return Step(name) if timer is None else timer.step(name)


def wait_on_card(sync):
    """Call ``sync``, a blocking wait of the host on the card, and add
    its time to the running build's ``card_wait_ms`` (and its span);
    returns what ``sync`` returns."""
    timer = current()
    if timer is None:
        return sync()
    t0 = time.perf_counter()
    out = sync()
    timer.card_waited(t0, time.perf_counter())
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
