"""The router's timer wheel: hedges, RPC timeouts, client deadlines.

One thread, one heap.  Every timed decision the router makes — fire a
hedge RPC because the primary is quiet past the shard's p95, expire a
scatter because the client's ``deadline_ms`` passed, condemn an RPC at
``MRI_CLUSTER_RPC_TIMEOUT_MS`` — is an entry here, so the router needs
no per-request timer threads and a 10k-deep pipeline costs one heap.

Hedge delay policy (``MRI_CLUSTER_HEDGE_MS``):

* ``-1`` (default) — adaptive: the shard's rolling p95 with a 1 ms
  floor.  The canonical tail-at-scale setting: hedges fire only for
  the slowest ~5% of RPCs, bounding duplicate work at ~5%.
* ``0`` — hedging off.
* ``> 0`` — fixed delay in milliseconds.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time

log = logging.getLogger("mri_torch.cluster")

#: adaptive-mode floor: never hedge inside 1 ms — faster than that the
#: duplicate would race the original's serialization, not its tail
MIN_HEDGE_S = 1e-3


def hedge_delay_s(knob_ms: float, p95_s: float | None) -> float | None:
    """Seconds to wait before hedging, or ``None`` for no hedge."""
    if knob_ms == 0:
        return None
    if knob_ms > 0:
        return knob_ms / 1e3
    if p95_s is None:
        return None  # adaptive with no samples yet: nothing to beat
    return max(MIN_HEDGE_S, p95_s)


class _Timer:
    __slots__ = ("fn", "cancelled")

    def __init__(self, fn):
        self.fn = fn
        self.cancelled = False


class Clock:
    """Single-threaded monotonic timer heap.

    ``schedule`` returns a token for ``cancel``; callbacks run on the
    clock thread and must be quick (the router's are: enqueue a send,
    flip a flag).  A callback that raises is logged and dropped — one
    bad timer must not stop the wheel.
    """

    def __init__(self, name: str = "mri-router-clock"):
        self._heap: list = []  # guarded by: self._cv
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._stopped = False
        self._cancelled = 0  # cancelled-but-enqueued  # guarded by: self._cv
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=name)
        self._thread.start()

    def schedule(self, delay_s: float, fn) -> _Timer:
        t = _Timer(fn)
        when = time.monotonic() + max(0.0, delay_s)
        item = (when, next(self._seq), t)
        with self._cv:
            heapq.heappush(self._heap, item)
            # wake the wheel only when the new timer is the next to
            # fire: a steady pipeline arms thousands of far-future RPC
            # timeouts per second, and a notify per arm would burn a
            # thread wakeup each (the scatter hot path's biggest cost)
            if self._heap[0] is item:
                self._cv.notify()
        return t

    def cancel(self, token: _Timer) -> None:
        token.cancelled = True  # lazily reaped when it surfaces
        with self._cv:
            self._cancelled += 1
            # rebuild once dead weight dominates, so far-future
            # cancelled timeouts cannot grow the heap without bound
            if self._cancelled > 2048 \
                    and self._cancelled > len(self._heap) // 2:
                self._heap = [e for e in self._heap
                              if not e[2].cancelled]
                heapq.heapify(self._heap)
                self._cancelled = 0

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    if not self._heap:
                        self._cv.wait()
                    else:
                        self._cv.wait(
                            max(0.0,
                                self._heap[0][0] - time.monotonic()))
                if self._stopped:
                    return
                _, _, timer = heapq.heappop(self._heap)
            if timer.cancelled:
                continue
            try:
                timer.fn()
            except Exception:
                log.exception("router timer callback failed")
