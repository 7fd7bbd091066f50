"""Host-side window plans (the reference's scheduler, done safely).

The reference sorts files by size descending (main.c:300) and greedily
cuts contiguous ranges once a shard's byte total reaches
``total / num_mappers`` (main.c:307-323); with more mappers than files
its range arrays stay uninitialized.  Here the cut is total: every
document lands in exactly one range, and surplus ranges are empty.
The pipelined plan's upload windows use it, and the native scan's
per-thread ranges (native/tokenizer.cc PlanRanges) mirror it; the
overlap plan cuts uneven byte shares the same way.
"""

from __future__ import annotations

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
