"""Request-scoped cost attribution: the EXPLAIN collector + flight ring
(the JAX package's ``obs/attribution.py``; this package's host and
device engines, planner and cache feed the collector at the same sites).

The aggregate obs layer (:mod:`.metrics`, :mod:`.tracing`) answers
"how is the daemon doing?"; this module answers "why was THIS query
slow?".  A :class:`Collector` rides one request end to end — installed
in a :mod:`contextvars` context variable so the engines, planner and
cache can feed it without threading a handle through every signature —
and every feed sits directly beside the registry-counter increment it
mirrors, so summing per-request reports over a run reproduces the
registry counters exactly.

Cost discipline: when no collector is installed (the default serving
path) the only overhead is one ``ContextVar.get`` returning ``None``
per feed site — no allocation, no locking.  Feeds on an installed
collector are plain attribute adds and list appends; a collector is
single-writer by construction (it lives in one request's context), so
no lock is taken on the hot path.

The :class:`FlightRecorder` is the after-the-incident black box: a
bounded ring (``MRI_OBS_FLIGHT_RING``) of the last N completed request
records (trace + optional cost report) plus the slow-log offenders,
dumped as one JSON file on SIGQUIT, on daemon crash or abnormal drain,
and on demand via the ``flightdump`` admin op.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from collections import deque

from ..utils import envknobs

FLIGHT_RING_ENV = "MRI_OBS_FLIGHT_RING"
EXEMPLARS_ENV = "MRI_OBS_EXEMPLARS"

#: the request-scoped collector; ``None`` means attribution is off and
#: every feed site reduces to one ContextVar.get.
_current: contextvars.ContextVar = contextvars.ContextVar(
    "mri_attribution", default=None)


def active():
    """The installed :class:`Collector`, or ``None`` (the fast path)."""
    return _current.get()


def install(coll):
    """Install ``coll`` for the current context; returns a reset token."""
    return _current.set(coll)


def uninstall(token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def collect(op: str = ""):
    """Run a block under a fresh collector and yield it.

    >>> with attribution.collect("top_k_scored") as coll:
    ...     engine.top_k_scored(batch, k=10)
    >>> coll.report()["engine"]["blocks_decoded"]
    """
    coll = Collector(op=op)
    token = _current.set(coll)
    try:
        yield coll
    finally:
        _current.reset(token)


def flight_ring_capacity() -> int:
    return envknobs.get(FLIGHT_RING_ENV)


def exemplars_enabled() -> bool:
    return envknobs.get(EXEMPLARS_ENV) != 0


class Collector:
    """Cost ledger for one request.

    Every mutator mirrors exactly one registry-counter increment at its
    call site; :meth:`report` assembles the structured JSON cost report
    the ``explain`` surface returns.  Single-writer: one request, one
    context, one collector (multi-segment requests attach one child
    collector per segment via :meth:`child`).
    """

    __slots__ = (
        "op", "terms", "blocks_decoded", "blocks_skipped",
        "bytes_decoded", "cache_hits", "cache_misses", "cache_events",
        "planner_mode", "planner_scored", "planner_skipped",
        "planner_candidates", "thetas", "and_arms", "stages_us",
        "segments",
    )

    def __init__(self, op: str = ""):
        self.op = op
        self.terms: list = []
        self.blocks_decoded = 0
        self.blocks_skipped = 0
        self.bytes_decoded = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_events: list = []
        self.planner_mode = ""
        self.planner_scored = 0
        self.planner_skipped = 0
        self.planner_candidates = 0
        self.thetas: list = []
        self.and_arms: list = []
        self.stages_us: dict = {}
        self.segments: list = []

    # -- feeds (each mirrors one registry increment) --------------------

    def term(self, term, idx: int, found: bool, df: int,
             path: str) -> None:
        """One resolved query term: ``path`` is how the lex index was
        found — ``memo`` / ``bisect`` (host), ``device`` (device
        bisect), ``cache`` (whole-batch occ memo)."""
        if isinstance(term, bytes):
            term = term.decode("utf-8", "replace")
        self.terms.append({"term": str(term), "idx": int(idx),
                           "found": bool(found), "df": int(df),
                           "path": path})

    def decoded(self, blocks: int, nbytes: int) -> None:
        """Mirrors ``mri_engine_blocks_decoded_total`` +
        ``mri_engine_bytes_decoded_total``."""
        self.blocks_decoded += int(blocks)
        self.bytes_decoded += int(nbytes)

    def skipped(self, blocks: int) -> None:
        """Mirrors ``mri_engine_blocks_skipped_total``."""
        self.blocks_skipped += int(blocks)

    def cache_event(self, key, hit: bool, cache: str = "") -> None:
        """Mirrors ``<cache>_{hits,misses}_total`` for one probe;
        ``key`` is the lex index, joinable against :meth:`term`."""
        if hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        if not isinstance(key, (int, str)):
            try:
                key = int(key)  # numpy integer keys
            except (TypeError, ValueError):
                key = str(key)
        self.cache_events.append(
            {"cache": cache, "key": key, "hit": bool(hit)})

    def ranked(self, mode: str, scored: int, skipped: int,
               candidates: int) -> None:
        """Mirrors ``Planner.note_ranked``'s counter increments."""
        self.planner_mode = mode
        self.planner_scored += int(scored)
        self.planner_skipped += int(skipped)
        self.planner_candidates += int(candidates)

    def and_arm(self, arm: str) -> None:
        """Mirrors ``mri_planner_and_{gallop,merge}_total``."""
        self.and_arms.append(arm)

    def theta(self, value: float) -> None:
        """One point of the pruning threshold's progression."""
        self.thetas.append(float(value))

    def stage(self, name: str, us: float) -> None:
        """Per-stage wall time in microseconds (queue/coalesce/engine)."""
        self.stages_us[name] = round(float(us), 1)

    def child(self, segment: str) -> "Collector":
        """A per-segment child collector (multi-segment engines install
        it around each segment-engine call; totals roll up)."""
        c = Collector(op=self.op)
        self.segments.append((str(segment), c))
        return c

    # -- assembly -------------------------------------------------------

    def totals(self) -> dict:
        """Rolled-up counts (self plus all segment children): the
        numbers the parity gate sums against the registry."""
        t = {
            "blocks_decoded": self.blocks_decoded,
            "blocks_skipped": self.blocks_skipped,
            "bytes_decoded": self.bytes_decoded,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "planner_blocks_scored": self.planner_scored,
            "planner_blocks_skipped": self.planner_skipped,
        }
        for _name, c in self.segments:
            for k, v in c.totals().items():
                t[k] += v
        return t

    def report(self) -> dict:
        """The structured JSON cost report for the explain surface."""
        rep: dict = {"op": self.op, "terms": self.terms}
        rep["planner"] = {
            "mode": self.planner_mode,
            "blocks_scored": self.planner_scored,
            "blocks_skipped": self.planner_skipped,
            "candidates": self.planner_candidates,
            "theta": self.thetas,
            "and_arms": self.and_arms,
        }
        rep["engine"] = {
            "blocks_decoded": self.blocks_decoded,
            "blocks_skipped": self.blocks_skipped,
            "bytes_decoded": self.bytes_decoded,
        }
        rep["cache"] = {
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "events": self.cache_events,
        }
        if self.stages_us:
            rep["stages_us"] = dict(self.stages_us)
        if self.segments:
            rep["segments"] = [
                {"segment": name, **c.report()}
                for name, c in self.segments
            ]
        rep["totals"] = self.totals()
        return rep


class FlightRecorder:
    """Bounded ring of completed request records + slow offenders.

    Each entry is ``{"trace": <trace dict>, "report": <cost report or
    None>}``; slow requests (``dur_ms >= slow_threshold_ms > 0``) are
    additionally retained in a separate offenders ring so one burst of
    fast traffic cannot evict the evidence.  ``capacity == 0`` disables
    recording entirely (every method is a cheap no-op).
    """

    def __init__(self, capacity: int | None = None,
                 slow_threshold_ms: float = 0.0):
        cap = capacity if capacity is not None else flight_ring_capacity()
        self.capacity = max(0, int(cap))
        self.slow_threshold_ms = float(slow_threshold_ms)
        self._lock = threading.Lock()
        self._dq: deque = deque(
            maxlen=max(1, self.capacity))  # guarded by: self._lock
        self._slow: deque = deque(
            maxlen=max(1, self.capacity))  # guarded by: self._lock

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(self, trace: dict, report: dict | None = None) -> None:
        if self.capacity <= 0:
            return
        entry = {"trace": trace, "report": report}
        with self._lock:
            self._dq.append(entry)
            dur = trace.get("dur_ms")
            if (self.slow_threshold_ms > 0 and dur is not None
                    and dur >= self.slow_threshold_ms):
                self._slow.append(entry)

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def dump(self, reason: str) -> dict:
        """One self-describing JSON document (most-recent-first)."""
        with self._lock:
            recent = list(self._dq)
            slow = list(self._slow)
        recent.reverse()
        slow.reverse()
        return {
            "event": "flight_dump",
            "reason": reason,
            "pid": os.getpid(),
            "ts": time.time(),
            "capacity": self.capacity,
            "slow_threshold_ms": self.slow_threshold_ms,
            "requests": recent,
            "slow": slow,
        }

    def dump_to_file(self, where: str, reason: str) -> str | None:
        """Write :meth:`dump` as ``flight-<pid>-<reason>.json`` under
        ``where`` (a directory, or a file whose directory is used).
        Crash-path safe: returns the path, or ``None`` — never raises.
        """
        if self.capacity <= 0:
            return None
        try:
            d = where if os.path.isdir(where) else os.path.dirname(
                os.path.abspath(where))
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason) or "dump"
            path = os.path.join(d, f"flight-{os.getpid()}-{safe}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.dump(reason), f, separators=(",", ":"))
            os.replace(tmp, path)
            return path
        except Exception:
            return None
