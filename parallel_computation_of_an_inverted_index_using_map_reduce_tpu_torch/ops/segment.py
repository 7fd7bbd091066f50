"""Segmented primitives over sorted key arrays.

These replace the reference reducer's O(tokens x unique_words) linear
dictionary scan and O(n^2) bubble sort (main.c:172-187, 217-226) with
O(n) boundary diffs, cumsums, binary searches and compactions over a
sorted array.  Every output has a size fixed by the inputs' shapes, so
no primitive waits for the card to learn a length: a compaction writes
each kept value to its rank (a cumsum of the mask) and sends the
dropped ones to a spare slot past the end.
"""

from __future__ import annotations

import torch

from .keys import INT32_MAX


def searchsorted_device(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``searchsorted(a, v, side='left')`` as int64, for ascending ``a``.

    CONTRACT: ``v`` must be nondecreasing.  Every caller passes an
    ``arange``; the JAX package's formulation relies on it, and callers
    here keep to it so both packages take the same inputs.
    """
    return torch.searchsorted(a, v.to(a.dtype), side="left")


def _rank_slots(mask: torch.Tensor, out_len: int) -> torch.Tensor:
    """Destination slot of each element: its rank among set bits where
    set and that rank is below ``out_len``, else the spare slot
    ``out_len``."""
    rank = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    keep = mask & (rank < out_len)
    return torch.where(keep, rank, torch.full_like(rank, out_len))


def set_bit_positions(mask: torch.Tensor, out_len: int) -> torch.Tensor:
    """Positions of ``mask``'s True slots, in order, as an
    ``out_len``-long int32 array padded with INT32_MAX; set bits past
    ``out_len`` are dropped."""
    n = mask.shape[0]
    out = torch.full((out_len + 1,), INT32_MAX, dtype=torch.int32, device=mask.device)
    if n:
        pos = torch.arange(n, dtype=torch.int32, device=mask.device)
        out.scatter_(0, _rank_slots(mask, out_len), pos)
    return out[:out_len]


def first_occurrence_mask(sorted_keys: torch.Tensor) -> torch.Tensor:
    """mask[i] = sorted_keys[i] is the first of its run.

    On a sorted pair array this is exactly the reference's per-(word, doc)
    dedup (main.c:176-184): one True per unique pair.
    """
    prev = torch.cat([sorted_keys[:1] - 1, sorted_keys[:-1]])
    return sorted_keys != prev


def sorted_segment_counts(segment_ids: torch.Tensor, weights: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Sum ``weights`` per segment id over a NONDECREASING id array;
    ids >= num_segments are dropped.  Each segment is one contiguous
    run, so its sum is a cumsum difference at the run's edges.

    Used for document frequency: df[t] = number of unique (t, doc) pairs
    (the count the reference accumulates per dictionary entry at
    main.c:176-187).
    """
    wext = torch.cat([torch.zeros(1, dtype=weights.dtype, device=weights.device),
                      torch.cumsum(weights, 0, dtype=weights.dtype)])
    edges = searchsorted_device(
        segment_ids, torch.arange(num_segments + 1, device=segment_ids.device))
    return wext[edges[1:]] - wext[edges[:-1]]


def bucket_edges(sorted_bucket_ids: torch.Tensor, num_buckets: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts, offsets)`` of each bucket's run in a sorted id array
    (ids >= num_buckets — the padding bucket — are dropped)."""
    edges = searchsorted_device(
        sorted_bucket_ids,
        torch.arange(num_buckets + 1, device=sorted_bucket_ids.device)).to(torch.int32)
    return edges[1:] - edges[:-1], edges[:-1]


def compact(values: torch.Tensor, keep_mask: torch.Tensor, out_size: int, fill) -> torch.Tensor:
    """Stable-compact ``values[keep_mask]`` into a fixed-size array.

    The result's first ``keep_mask.sum()`` slots are the kept values in
    order, remaining slots are ``fill`` (kept values past ``out_size``
    are dropped).
    """
    out = torch.full((out_size + 1,), fill, dtype=values.dtype, device=values.device)
    if values.shape[0]:
        out.scatter_(0, _rank_slots(keep_mask, out_size), values)
    return out[:out_size]
