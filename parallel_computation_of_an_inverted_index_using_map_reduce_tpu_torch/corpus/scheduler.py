"""Host-side window plans (the reference's scheduler, done safely).

The reference sorts files by size descending (main.c:300) and greedily
cuts contiguous ranges once a shard's byte total reaches
``total / num_mappers`` (main.c:307-323); with more mappers than files
its range arrays stay uninitialized.  Here the cut is total: every
document lands in exactly one range, and surplus ranges are empty.
The pipelined plan's upload windows use it, and the native scan's
per-thread ranges (native/tokenizer.cc PlanRanges) mirror it; the
overlap plan cuts uneven byte shares the same way.  The multi-shard
letter emit takes the reference's reducer letter ranges
(:func:`plan_letter_ranges`).
"""

from __future__ import annotations

import numpy as np

from ..config import ALPHABET_SIZE
from .manifest import Manifest


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


def window_balance_stats(manifest: Manifest, windows) -> dict:
    """Bytes per ``[lo, hi)`` window and the max/mean imbalance ratio
    (the pipelined plan's ``window_plan_bytes`` / ``window_imbalance``)."""
    return _balance([int(sum(manifest.sizes[lo:hi])) for lo, hi in windows])
