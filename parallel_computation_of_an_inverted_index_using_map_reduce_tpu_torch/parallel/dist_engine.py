"""Multi-shard engine: hash-bucket ``all_to_all`` shuffle over the mesh.

The replacement for the reference's shuffle — 26 shared spill files
written by every mapper under stdio locks and re-read by letter-owning
reducers (main.c:116, 332-341, 135-137):

- pairs are split over the shards in contiguous ranges (data
  parallelism over documents, main.c:307-328's file ranges);
- each shard buckets its pairs by ``term % n`` — a uniform hash
  partition, unlike the reference's ~1000x-skewed first-letter
  partition (SURVEY.md §2.3) — or by a term -> owner map (the letter
  ownership of the per-owner emit), and exchanges them with one
  ``all_to_all``;
- each owner sorts what it received: a term's pairs all land on its
  owner, so the owner's dedup is the global one;
- only vocab-sized aggregates are reduced across shards (document
  frequency by ``psum``); the host fetches each owner's valid prefix
  and merges the n sorted runs in O(N) during the emit.

The exchange has a fixed per-bucket capacity; an overflow flag (the
one value read before the fetch) triggers one retry at the capacity
that provably suffices.  This is the counterpart of the JAX package's
``parallel/dist_engine.py``: the same capacities, bucket rule, retry
condition and fetch sizes, so its ``dist_fetched_bytes`` and
``dist_valid_pairs`` agree with the JAX build's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import keys as K
from ..ops.engine import PendingFetch, emit_order
from ..ops.segment import bucket_edges, compact, first_occurrence_mask, sorted_segment_counts
from ..utils.rounding import round_up
from .mesh import Mesh, all_to_all, gather_host, psum, replicate

_LOW32 = 0xFFFFFFFF


def default_capacity(local_size: int, num_shards: int, factor: float = 2.0) -> int:
    """Per-(source, destination) bucket capacity.

    Expected load is ``local_size / num_shards``; ``factor`` covers hash
    imbalance.  Capped at ``local_size`` (the provably-safe value: one
    source cannot send more pairs than it holds).
    """
    if num_shards == 1:
        return local_size
    return min(local_size, round_up(int(math.ceil(local_size / num_shards * factor)), 8))


def send_buffer(rows, order, counts, offsets, *, capacity: int) -> torch.Tensor:
    """Fixed-shape ``(n, len(rows) * capacity)`` send buffer: row ``b``
    holds bucket ``b``'s first ``capacity`` entries of each of ``rows``
    (gathered through ``order``, the bucket-sorted positions, or
    directly when ``order`` is None), side by side, INT32_MAX past the
    bucket's count."""
    local = rows[0].shape[0]
    dev = rows[0].device
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)[None, :]
    idx = torch.clamp(offsets.to(torch.int64)[:, None] + slot, 0, local - 1)
    if order is not None:
        idx = order[idx]
    in_bucket = slot < counts[:, None]
    return torch.cat([torch.where(in_bucket, r[idx], K.INT32_MAX) for r in rows], dim=1)


def bucket_sends(keys_local: torch.Tensor, valid_limit: int, *, num_shards: int,
                 capacity: int, stride: int, owner_of_term: torch.Tensor | None = None):
    """One shard's side of the exchange: bucket its packed keys by
    ``term % num_shards`` (or by ``owner_of_term``, a term -> owner map,
    terms clipped into its range) and lay them out per destination.

    Keys ``>= valid_limit`` go to the padding bucket.  The two-key sort
    by (bucket, key) is one int64 sort of ``bucket << 32 | key`` (keys
    are >= 0).  Returns ``(send, overflow)``: the ``(num_shards,
    capacity)`` buffer whose row ``b`` goes to shard ``b``, and whether
    a bucket held more than ``capacity`` keys.
    """
    term = keys_local // stride
    if owner_of_term is None:
        owner = term % num_shards
    else:
        owner = owner_of_term[torch.clamp(term, 0, owner_of_term.shape[0] - 1).to(torch.int64)]
    bucket = torch.where(keys_local < valid_limit, owner, num_shards)
    s = torch.sort((bucket.to(torch.int64) << 32) | keys_local.to(torch.int64)).values
    bucket_s = (s >> 32).to(torch.int32)
    keys_s = (s & _LOW32).to(torch.int32)
    counts, offsets = bucket_edges(bucket_s, num_shards)
    overflow = (counts > capacity).any()
    return send_buffer([keys_s], None, counts, offsets, capacity=capacity), overflow


def _shuffle(keys, letter_of_term, *, mesh: Mesh, capacity: int, vocab_size: int,
             max_doc_id: int) -> dict:
    """The one-shot exchange program: bucket, exchange, owner-side sort
    and dedup, df by ``psum``, emit order on shard 0's device."""
    n = mesh.size
    stride = max_doc_id + 2
    valid_limit = vocab_size * stride
    sends, overflows = zip(*(
        bucket_sends(k, valid_limit, num_shards=n, capacity=capacity, stride=stride)
        for k in keys))
    recv = all_to_all(list(sends), mesh)
    uniq, df_parts, uniq_counts = [], [], []
    for r in recv:
        recv_s = torch.sort(r).values
        first = first_occurrence_mask(recv_s) & (recv_s < valid_limit)
        uniq.append(compact(recv_s, first, recv_s.shape[0], K.INT32_MAX))
        first32 = first.to(torch.int32)
        df_parts.append(sorted_segment_counts(recv_s // stride, first32, vocab_size))
        uniq_counts.append(first32.sum(dtype=torch.int32))
    df = psum(df_parts, mesh)
    return {
        "uniq": uniq,
        "df": df,
        "order": emit_order(letter_of_term, df, vocab_size, max_doc_id),
        "offsets": torch.cumsum(df, 0, dtype=df.dtype) - df,
        "num_unique": psum(uniq_counts, mesh),
        "overflow": psum([o.to(torch.int32) for o in overflows], mesh),
    }


def assemble_postings(uniq, max_doc_id: int, valid_limit: int, offsets: np.ndarray,
                      num_pairs: int) -> np.ndarray:
    """O(N) host merge of the per-owner deduped keys into the global
    term-major postings array.  Each owner's keys are ascending
    (INT32_MAX padding at the tail) and every term's pairs live on one
    owner, so scattering each owner's term runs at the global
    ``offsets`` is a complete, collision-free merge."""
    stride = max_doc_id + 2
    postings = np.empty(max(num_pairs, 1), dtype=np.int32)
    pending = [PendingFetch(u) for u in uniq]  # every copy starts before any is read
    for p in pending:
        keys = p.wait()
        keys = keys[: np.searchsorted(keys, valid_limit)]
        if keys.size:
            _scatter_run(keys // stride, keys % stride, offsets, postings)
    return postings[:num_pairs]


def dist_index(keys, letter_of_term: torch.Tensor, *, vocab_size: int, max_doc_id: int,
               mesh: Mesh, capacity_factor: float = 2.0) -> dict:
    """Index packed pair keys split over the mesh.

    ``keys`` is the per-shard list of equal-length int32 tensors
    (``mesh.shard`` of an INT32_MAX-padded array); ``letter_of_term``
    lies on shard 0's device.  Returns the single-device engine's dict:
    ``df``, ``order``, ``offsets`` and ``num_unique`` as tensors on
    shard 0's device, ``postings`` assembled on the host.  If the hash
    partition overflows the default capacity, the exchange runs once
    more at the capacity that provably suffices.
    """
    n = mesh.size
    local = keys[0].shape[0]
    capacity = default_capacity(local, n, capacity_factor)
    out = _shuffle(keys, letter_of_term, mesh=mesh, capacity=capacity,
                   vocab_size=vocab_size, max_doc_id=max_doc_id)
    if capacity < local and int(out["overflow"]) > 0:
        out = _shuffle(keys, letter_of_term, mesh=mesh, capacity=local,
                       vocab_size=vocab_size, max_doc_id=max_doc_id)
    out.pop("overflow")
    uniq = out.pop("uniq")
    num_unique = int(out["num_unique"])
    out["postings"] = assemble_postings(
        uniq, max_doc_id, vocab_size * (max_doc_id + 2), out["offsets"].cpu().numpy(),
        num_unique)
    return out


def _exchange_owned(keys_local, *, mesh: Mesh, capacity: int, stride: int, owner_dev):
    """The pipelined exchange program: bucket, exchange, owner-side
    sort.  Returns the per-owner ascending buffers and, read in one
    wait, each owner's valid count beside its overflow flag."""
    n = mesh.size
    sends, overflows = zip(*(
        bucket_sends(k, K.INT32_MAX, num_shards=n, capacity=capacity, stride=stride,
                     owner_of_term=None if owner_dev is None else owner_dev[s])
        for s, k in enumerate(keys_local)))
    owned = [torch.sort(r).values for r in all_to_all(list(sends), mesh)]
    flags = gather_host([torch.stack([(o < K.INT32_MAX).sum(dtype=torch.int32),
                                      f.to(torch.int32)]) for o, f in zip(owned, overflows)],
                        mesh)
    return owned, flags


def _exchange_and_fetch_rows(windows, *, stride: int, mesh: Mesh, capacity_factor: float,
                             owner_of_prov: np.ndarray | None,
                             stats: dict | None) -> dict[int, np.ndarray]:
    """Shared tail of both pipelined mesh paths: the (possibly
    letter-keyed) exchange with the overflow retry, then each owner's
    valid prefix — one slice per owner at the max count rounded to a
    reuse granule, so fetched bytes track unique pairs, not the
    overprovisioned capacity.  Returns ``{owner: keys}``."""
    n = mesh.size
    keys_local = [torch.cat([w[s] for w in windows]) if len(windows) > 1 else windows[0][s]
                  for s in range(n)]
    local_total = keys_local[0].shape[0]
    capacity = default_capacity(local_total, n, capacity_factor)
    keep: list = []
    owner_dev = (None if owner_of_prov is None else
                 replicate(np.ascontiguousarray(owner_of_prov, dtype=np.int32), mesh, keep))
    owned, flags = _exchange_owned(keys_local, mesh=mesh, capacity=capacity, stride=stride,
                                   owner_dev=owner_dev)
    if capacity < local_total and int(flags[:, 1].sum()) > 0:
        del owned
        owned, flags = _exchange_owned(keys_local, mesh=mesh, capacity=local_total,
                                       stride=stride, owner_dev=owner_dev)
    del keys_local
    counts = [int(c) for c in flags[:, 0]]
    local_len = owned[0].shape[0]
    nfetch = min(local_len, round_up(max(max(counts), 1), 1 << 13))
    pending = [PendingFetch(o[:nfetch]) for o in owned]
    rows = {}
    fetched = 0
    for owner, p in enumerate(pending):
        row = p.wait()
        rows[owner] = row[: counts[owner]]
        fetched += row.nbytes
    if stats is not None:
        stats["dist_fetched_bytes"] = fetched + 4 * len(counts)
        stats["dist_valid_pairs"] = int(sum(counts))
    return rows


def dist_letter_windows(windows, owner_of_prov: np.ndarray, *, stride: int, mesh: Mesh,
                        capacity_factor: float = 2.0,
                        stats: dict | None = None) -> dict[int, np.ndarray]:
    """Per-owner-emit tail of the pipelined plan: exchange the sharded
    upload windows by letter owner (the reference's reducer letter
    ranges, main.c:129-130, via corpus/scheduler.plan_letter_ranges);
    returns ``{owner: keys}`` (prov-grouped ascending, docs ascending
    inside each term).  The letter partition is skewed by construction
    (SURVEY.md §2.3); the overflow retry at the safe capacity absorbs
    it."""
    return _exchange_and_fetch_rows(
        windows, stride=stride, mesh=mesh, capacity_factor=capacity_factor,
        owner_of_prov=owner_of_prov, stats=stats)


def _scatter_run(term: np.ndarray, doc: np.ndarray, offsets_prov: np.ndarray,
                 postings: np.ndarray) -> None:
    """Scatter one owner's (term-grouped ascending) run into the global
    postings array — vectorized, collision-free because every term
    lives on exactly one owner."""
    change = np.empty(term.shape[0], dtype=bool)
    change[0] = True
    np.not_equal(term[1:], term[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    run_of_elem = np.cumsum(change) - 1
    within = np.arange(term.shape[0], dtype=np.int64) - starts[run_of_elem]
    postings[offsets_prov[term] + within] = doc


def merge_owner_runs(rows, stride: int, offsets_prov: np.ndarray,
                     num_pairs: int) -> np.ndarray:
    """O(N) host merge of per-owner sorted *packed-key* runs into the
    global prov-grouped postings array: each ``rows[d]`` is owner d's
    valid keys, ascending, and every term's pairs live on one owner, so
    each group scatters to its term's slot (``offsets_prov``)."""
    postings = np.empty(max(num_pairs, 1), dtype=np.int32)
    for row in rows:
        if row.size:
            _scatter_run(row // stride, row % stride, offsets_prov, postings)
    return postings[:num_pairs]


def merge_owner_pair_runs(rows, offsets_prov: np.ndarray, num_pairs: int) -> np.ndarray:
    """Pair-mode :func:`merge_owner_runs`: each ``rows[d]`` is
    ``(terms, docs)`` sorted by (term, doc)."""
    postings = np.empty(max(num_pairs, 1), dtype=np.int32)
    for term, doc in rows:
        if term.size:
            _scatter_run(term.astype(np.int64), doc, offsets_prov, postings)
    return postings[:num_pairs]


def dist_sort_prov_windows(windows, *, stride: int, mesh: Mesh, offsets_prov: np.ndarray,
                           num_pairs: int, capacity_factor: float = 2.0,
                           stats: dict | None = None) -> np.ndarray:
    """Mesh tail of the pipelined plan: shuffle and sort the sharded
    provisional-key upload windows; returns the host-assembled postings
    (docs grouped by prov term id, ascending).

    Each element of ``windows`` is one window's per-shard list of int32
    tensors (``mesh.shard`` of an INT32_MAX-padded buffer).
    ``offsets_prov`` (prov-space offsets from the combiner's df) drives
    the O(N) :func:`merge_owner_runs`; only each owner's valid prefix
    is fetched.  ``stats`` receives ``dist_fetched_bytes`` and
    ``dist_valid_pairs``.
    """
    rows = _exchange_and_fetch_rows(
        windows, stride=stride, mesh=mesh, capacity_factor=capacity_factor,
        owner_of_prov=None, stats=stats)
    return merge_owner_runs(rows.values(), stride, offsets_prov, num_pairs)
