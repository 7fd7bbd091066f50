"""Host-side window plans (the reference's scheduler, done safely).

The reference sorts files by size descending (main.c:300) and greedily
cuts contiguous ranges once a shard's byte total reaches
``total / num_mappers`` (main.c:307-323); with more mappers than files
its range arrays stay uninitialized.  Here the cut is total: every
document lands in exactly one range, and surplus ranges are empty.
The pipelined plan's upload windows use it, and the native scan's
per-thread ranges (native/tokenizer.cc PlanRanges) mirror it; the
overlap plan cuts uneven byte shares the same way.  The multi-shard
letter emit and the cpu backend's reducers take the reference's reducer
letter ranges (:func:`plan_letter_ranges`).  The cpu backend's K scan
workers pull byte windows from one :class:`StealQueue` instead of a
static split, and :func:`plan_host_shards` is the LPT balance of files
across host shards.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

import numpy as np

from ..config import ALPHABET_SIZE
from .manifest import Manifest


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Per-shard index lists into a manifest (not necessarily contiguous)."""

    shards: tuple[tuple[int, ...], ...]

    @property
    def num_shards(self) -> int:
        return len(self.shards)


def plan_host_shards(manifest: Manifest, num_shards: int) -> ShardPlan:
    """LPT (longest-processing-time) balance of files across host shards.

    Same goal as the reference's sort+greedy-cut (main.c:300-323) but a
    proper LPT assignment: files sorted by size descending, each placed on
    the currently lightest shard.  Total under any num_shards >= 1,
    including num_shards > len(manifest) (empty shards, not UB).
    """
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    order = sorted(range(len(manifest)), key=lambda i: (-manifest.sizes[i], i))
    loads = [0] * num_shards
    buckets: list[list[int]] = [[] for _ in range(num_shards)]
    for i in order:
        lightest = min(range(num_shards), key=lambda s: (loads[s], s))
        buckets[lightest].append(i)
        loads[lightest] += manifest.sizes[i]
    return ShardPlan(shards=tuple(tuple(sorted(b)) for b in buckets))


def plan_contiguous_windows(manifest: Manifest,
                            num_windows: int) -> tuple[tuple[int, int], ...]:
    """Contiguous byte-balanced doc ranges ``[lo, hi)`` covering the
    manifest: the reference's greedy cut at ``total/N`` without its sort
    (main.c:307-323)."""
    return plan_contiguous_ranges(manifest.sizes, num_windows)


def plan_contiguous_ranges(sizes, num_windows: int) -> tuple[tuple[int, int], ...]:
    """:func:`plan_contiguous_windows` over a plain sizes sequence."""
    if num_windows < 1:
        raise ValueError("num_windows must be >= 1")
    n = len(sizes)
    total = sum(sizes)
    cuts = [0]
    d = 0
    cum = 0
    for t in range(1, num_windows):
        target = total * t // num_windows
        while d < n and cum < target:
            cum += sizes[d]
            d += 1
        cuts.append(d)
    cuts.append(n)
    return tuple((cuts[t], cuts[t + 1]) for t in range(num_windows))


def plan_fraction_windows(manifest: Manifest,
                          fractions) -> tuple[tuple[int, int], ...]:
    """Contiguous doc ranges ``[lo, hi)`` with byte shares ~ ``fractions``
    (the overlap plan's device windows, then its host tail): cut points
    sit at the cumulative-byte targets ``total * sum(fractions[:k])``.
    ``fractions`` must be positive and sum to ~1; every doc lands in
    exactly one range (a degenerate manifest gives empty ranges)."""
    fr = [float(f) for f in fractions]
    if not fr or any(f <= 0 for f in fr):
        raise ValueError(f"fractions must be positive, got {fractions!r}")
    if abs(sum(fr) - 1.0) > 1e-6:
        raise ValueError(f"fractions must sum to 1, got sum={sum(fr)}")
    n = len(manifest)
    total = sum(manifest.sizes)
    cuts = [0]
    d = 0
    cum = 0
    acc = 0.0
    for f in fr[:-1]:
        acc += f
        target = total * acc
        while d < n and cum < target:
            cum += manifest.sizes[d]
            d += 1
        cuts.append(d)
    cuts.append(n)
    return tuple((cuts[t], cuts[t + 1]) for t in range(len(fr)))


class StealQueue:
    """Steal-safe window queue shared by K scan workers.

    The reference statically pre-assigns file ranges to mappers
    (main.c:307-328), so one slow disk stripe idles every other thread
    until the join.  Here the byte-window plan goes into one shared
    queue and each worker's reader pulls the next window when its ring
    has a free arena — dynamic self-scheduling, the degenerate-deque
    form of work stealing (every pop is a "steal" from the shared pool),
    which is all the structure K independent readers need.

    Windows are handed out with their GLOBAL 1-based plan index so
    fault hooks keyed on window numbers (``sigkill:window=N``) stay
    deterministic under any worker interleaving, and ``shuffle_seed``
    deliberately scrambles hand-out order — the output-invariance tests
    use it to prove scheduling can never change the emitted bytes.

    Lease/ack semantics (the in-run fault-tolerance layer): a popped
    window is LEASED to the popping worker and only retired by
    :meth:`ack`.  When a worker dies, :meth:`fail_worker` requeues
    every window attributed to it — outstanding leases AND windows it
    already completed, because its partial native handle (holding
    those windows' postings) is discarded with it — and blacklists the
    worker so a zombie thread that wakes up later pops nothing more.
    Requeued windows keep their global plan index, so a rescan by any
    survivor merges byte-identically; re-execution is MapReduce's
    defining recovery move (a failed task is rescheduled, the job
    completes with identical output).

    Callers that never ack (the single-reader plan mode, older tests)
    see the original contract unchanged: ``pop_window()`` with no
    worker drains in order and ``len(q)`` counts windows not yet
    handed out.
    """

    def __init__(self, windows, shuffle_seed: int | None = None):
        items = list(enumerate(windows, start=1))
        if shuffle_seed is not None:
            random.Random(shuffle_seed).shuffle(items)
        self._lock = threading.Lock()
        # every field below is guarded by self._lock
        self._items = items
        self._pos = 0
        self._window_of = {wi: w for wi, w in items}
        self._leases: dict[int, tuple[object, float]] = {}  # wi -> (worker, t)
        self._completed: dict[int, object] = {}  # wi -> worker
        self._failed: set = set()  # retired workers

    def pop_window(self, worker=None) -> tuple[int, tuple[int, int]] | None:
        """Next ``(global_index, (lo, hi))``, or None when drained.

        ``worker`` attributes the lease; a worker retired by
        :meth:`fail_worker` gets None forever (closes the race where a
        hung reader wakes up after its windows were already requeued
        and would otherwise strand a fresh lease)."""
        with self._lock:
            if worker is not None and worker in self._failed:
                return None
            if self._pos >= len(self._items):
                return None
            item = self._items[self._pos]
            self._pos += 1
            self._leases[item[0]] = (worker, time.monotonic())
            return item

    def ack(self, window_index: int, worker=None) -> None:
        """Retire a completed window (idempotent).  A retired worker's
        late ack is dropped — its windows were already requeued."""
        with self._lock:
            lease = self._leases.pop(window_index, None)
            owner = lease[0] if lease is not None else worker
            if owner is not None and owner in self._failed:
                return
            self._completed[window_index] = owner

    def fail_worker(self, worker) -> list[int]:
        """Requeue every window attributed to ``worker`` and retire it.

        Returns the requeued global window indices (sorted).  Both
        outstanding leases and completed windows come back: the dead
        worker's native handle — the only place its completed windows'
        postings lived — is discarded by the caller."""
        with self._lock:
            self._failed.add(worker)
            back = [wi for wi, (w, _) in self._leases.items() if w == worker]
            back += [wi for wi, w in self._completed.items() if w == worker]
            back.sort()
            for wi in back:
                self._leases.pop(wi, None)
                self._completed.pop(wi, None)
                self._items.append((wi, self._window_of[wi]))
            return back

    def expired_workers(self, deadline_s: float) -> set:
        """Workers holding any lease older than ``deadline_s`` — the
        per-window deadline watchdog's trigger set (a worker wedged in
        a hung read/scan past the deadline is treated as dead)."""
        now = time.monotonic()
        with self._lock:
            return {w for w, t in self._leases.values()
                    if w is not None and w not in self._failed
                    and now - t > deadline_s}

    def outstanding(self) -> int:
        """Leased-but-unacked window count (0 after a clean drain)."""
        with self._lock:
            return len(self._leases)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items) - self._pos


def plan_letter_ranges(num_reducers: int) -> tuple[tuple[int, int], ...]:
    """Contiguous letter ranges per reduce partition.

    Mirrors the reference's arithmetic (main.c:129-130) *including* its
    degenerate R > 26 behavior (empty ranges for all but the last
    partition), since it is part of the observable contract (SURVEY.md
    §2.3).
    """
    if num_reducers < 1:
        raise ValueError("num_reducers must be >= 1")
    per = ALPHABET_SIZE // num_reducers
    ranges = []
    for r in range(num_reducers):
        start = per * r
        end = per * (r + 1) if r < num_reducers - 1 else ALPHABET_SIZE
        ranges.append((start, max(start, end)))
    return tuple(ranges)


def owner_of_letter_table(num_owners: int):
    """``(ranges, owner_of_letter)``: the letter-ownership map every
    per-owner emit shares — ``owner_of_letter[l]`` is the partition
    owning letter ``l`` under :func:`plan_letter_ranges` (one table, so
    the host-scan and device-scan letter emits cannot diverge)."""
    ranges = plan_letter_ranges(num_owners)
    owner_of_letter = np.zeros(ALPHABET_SIZE, dtype=np.int32)
    for o, (lo, hi) in enumerate(ranges):
        owner_of_letter[lo:hi] = o
    return ranges, owner_of_letter


def _balance(loads: list[int]) -> dict:
    mean = sum(loads) / len(loads) if loads else 0.0
    return {
        "bytes_per_shard": loads,
        "max_over_mean": round(max(loads) / mean, 3) if mean else 0.0,
    }


def shard_balance_stats(manifest: Manifest, plan: ShardPlan) -> dict:
    """Bytes per shard + imbalance ratio, for the metrics subsystem."""
    return _balance(
        [sum(manifest.sizes[i] for i in shard) for shard in plan.shards])


def term_shard_balance(postings_per_shard: list[int]) -> dict:
    """Postings per term-hash shard + skew ratio (max/mean) — the
    out-of-core build's balance report, directly comparable against the
    reference's 26-letter split (pass per-letter postings counts to see
    why hash sharding wins: Zipf mass concentrates on a few letters but
    spreads evenly under the term hash)."""
    loads = [int(n) for n in postings_per_shard]
    mean = sum(loads) / len(loads) if loads else 0.0
    return {
        "shards": len(loads),
        "postings_per_shard": loads,
        "max_over_mean": round(max(loads) / mean, 3) if mean else 0.0,
    }


def window_balance_stats(manifest: Manifest, windows) -> dict:
    """Bytes per ``[lo, hi)`` window and the max/mean imbalance ratio
    (the pipelined plan's ``window_plan_bytes`` / ``window_imbalance``)."""
    return _balance([int(sum(manifest.sizes[lo:hi])) for lo, hi in windows])
