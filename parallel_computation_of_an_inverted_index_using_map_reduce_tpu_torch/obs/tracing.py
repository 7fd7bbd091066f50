"""Per-request tracing: trace ids, the recent-trace ring, slow log.

The daemon accepts an optional ``trace_id`` on every wire request and
echoes it on the response (auto-generating one when observability is
on).  Each finished request leaves one trace record — contiguous spans
covering queue wait → coalesce → engine — in a bounded ring queryable
via the ``trace`` admin op, and requests slower than
``MRI_OBS_SLOW_MS`` additionally emit one structured JSON line on the
``mri_torch.obs`` logger.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from collections import deque

from ..utils import envknobs
from . import logging as obs_logging

ENABLE_ENV = "MRI_OBS_ENABLE"
RING_ENV = "MRI_OBS_TRACE_RING"
SLOW_ENV = "MRI_OBS_SLOW_MS"

#: The slow-query logger: one ``{"event":"slow_query",...}`` JSON line
#: per offending request (WARNING level, never raises into serving).
slow_log = logging.getLogger("mri_torch.obs")


def enabled() -> bool:
    return envknobs.get(ENABLE_ENV) != 0


def slow_ms() -> float:
    return envknobs.get(SLOW_ENV)


def ring_capacity() -> int:
    return envknobs.get(RING_ENV)


#: seeded once from the OS, stepped in C thereafter: trace ids are
#: collision-avoidance for a bounded ring, not secrets, and a
#: getrandom(2) syscall per request dominates the serve loop's serial
#: read path on slow-entropy hosts.  getrandbits is a single C call,
#: so concurrent callers are safe under the GIL.
_trace_rng = random.Random(os.urandom(16))


def gen_trace_id() -> str:
    """16 hex chars, collision-safe for a ring of recent traces."""
    return f"{_trace_rng.getrandbits(64):016x}"


class TraceRing:
    """Bounded, thread-safe ring of completed trace records (dicts)."""

    def __init__(self, capacity: int | None = None):
        cap = capacity if capacity is not None else ring_capacity()
        self._lock = threading.Lock()
        self._dq: deque = deque(maxlen=max(1, cap))  # guarded by: self._lock

    def push(self, trace: dict) -> None:
        with self._lock:
            self._dq.append(trace)

    def snapshot(self, n: int | None = None) -> list[dict]:
        """Most-recent-first list of up to ``n`` traces."""
        with self._lock:
            out = list(self._dq)
        out.reverse()
        if n is not None:
            out = out[:max(0, n)]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


def emit_slow(trace: dict) -> None:
    """One structured JSON line for a slow request — routed through
    the unified obs logging funnel (rate-limited).  Never raises."""
    obs_logging.emit(slow_log, "slow_query", level=logging.WARNING,
                     **trace)
