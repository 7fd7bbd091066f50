"""Mesh all-device engine: sharded raw bytes in, per-owner index out.

Completes {host scan, device scan} x {one device, mesh}.  Each shard
receives a contiguous doc range's raw bytes and tokenizes them with the
single-device engine's stages (ops/device_tokenizer.py); one
``all_to_all`` then exchanges whole word rows (the live 5-bit (hi, lo)
group halves and the doc, side by side), bucketed by a word-content
hash, so every term is deduped and counted by exactly one owner — the
reference's reducer ownership (main.c:129-150) re-keyed from its
~1000x-skewed letters to a near-uniform hash.  With ``owner_of_letter``
the rows are bucketed by first letter instead, and each owner holds
whole letters (the per-owner letter emit).

Per shard:

    rows   <- tokenize_groups(bytes_shard)
    owner  <- mix32(word columns) % n
    recv   <- all_to_all(bucket(rows, owner))
    index  <- sort_dedup_groups(recv)

with a fixed exchange capacity and one retry at the safe capacity when
a bucket overflows.  The host then fetches each owner's valid prefix
with the single-device tail's transfer trimming.  The counterpart of
the JAX package's ``parallel/dist_device_tokenizer.py``: the same hash,
capacities and fetch sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.device_tokenizer import (INT32_MAX, doc_pack_width, fetch_pack, live_groups_for,
                                    num_groups_for, rebuild_tail_groups, sort_dedup_groups,
                                    tokenize_groups, unpack_postings)
from ..ops.engine import PendingFetch, host_view, leaves
from ..ops.segment import bucket_edges
from ..utils.rounding import round_up
from .dist_engine import default_capacity, send_buffer
from .mesh import Mesh, all_to_all, gather_host, replicate, shard_parts

_LOW32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32): split ``c`` in
    16-bit halves so no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _LOW32


def _mix32(cols) -> torch.Tensor:
    """Deterministic word-content hash of the packed columns — the JAX
    package's uint32 mul-xor mix, bit for bit, in int64 arithmetic
    masked to 32 bits (torch has no uint32 multiply on the card).
    Returns the hash as int64 in [0, 2**32)."""
    h = cols[0].to(torch.int64) & _LOW32
    for c in cols[1:]:
        h = _mul32(h ^ (c.to(torch.int64) & _LOW32), 0x9E3779B1)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def exchange_rows(send_rows, owner, *, mesh: Mesh, capacity: int):
    """Bucket each shard's word rows by ``owner`` (``num_shards`` =
    padding) and run the exchange.  ``send_rows[s]`` is shard ``s``'s
    list of equal-length int32 columns.  Returns the per-shard received
    columns (each ``n * capacity`` long) and the per-shard overflow
    flags (tensors)."""
    n = mesh.size
    sends, overflows = [], []
    for rows, own in zip(send_rows, owner):
        b_s, perm = torch.sort(own, stable=True)
        counts, offsets = bucket_edges(b_s, n)
        overflows.append((counts > capacity).any())
        sends.append(send_buffer(rows, perm, counts, offsets, capacity=capacity))
    nrows = len(send_rows[0])
    recv = []
    for r in all_to_all(sends, mesh):
        r = r.reshape(n, nrows, capacity)
        recv.append([r[:, i, :].reshape(-1) for i in range(nrows)])
    return recv, overflows


def _shard_rows(data, ends, ids, *, width: int, tok_cap: int, num_docs: int,
                sort_cols: int | None, num_shards: int, owner_of_letter):
    """One shard's tokenize and owner assignment: ``(send_rows, owner,
    max_len, num_tokens)``."""
    groups, doc_col, max_len, num_tokens = tokenize_groups(
        data, ends, ids, width=width, tok_cap=tok_cap, num_docs=num_docs, sort_cols=sort_cols)
    live = live_groups_for(sort_cols, width)
    # group pairs past the host-exact sort_cols bound are zero in every
    # row: they are neither exchanged nor sorted
    rows = [h for pair in groups[:live] for h in pair] + [doc_col]
    valid = groups[0][0] != INT32_MAX
    if owner_of_letter is None:  # near-uniform content-hash ownership
        dest = (_mix32(rows[:-1]) % num_shards).to(torch.int32)
    else:
        # letter ownership: the first char's 5-bit code sits at the top
        # field of group 0's hi (pad 0, a=1 .. z=26)
        letter = ((groups[0][0] >> 25) & 31) - 1
        dest = owner_of_letter[torch.clamp(letter, 0, 25).to(torch.int64)]
    owner = torch.where(valid, dest, num_shards)
    return rows, owner, max_len.to(torch.int32), num_tokens


def index_bytes_dist(shard_bufs, shard_ends, shard_ids, *, width: int, tok_cap: int,
                     mesh: Mesh, stats: dict | None = None, sort_cols: int | None = None,
                     max_doc_id: int | None = None, owner_of_letter: np.ndarray | None = None):
    """Sharded raw bytes -> per-owner index blocks, over the mesh.

    ``shard_bufs``: n equal-length uint8 buffers (space-padded contiguous
    doc ranges); ``shard_ends`` / ``shard_ids``: per-shard int32 arrays
    of one length (ends padded with the buffer length — padding spaces
    make no tokens).  ``tok_cap``: per-shard token capacity (the max of
    the exact per-shard counts, rounded up).  Returns ``(owners,
    (max_word_len, exchange_retries))`` where ``owners`` maps owner ->
    dict(num_words, num_pairs, df, postings, unique_groups), valid
    prefixes cut.
    """
    n = mesh.size
    num_docs = shard_ends[0].shape[0]
    keep: list = []
    data = shard_parts(shard_bufs, mesh, keep)
    ends = shard_parts(shard_ends, mesh, keep)
    ids = shard_parts(shard_ids, mesh, keep)
    owner_dev = (None if owner_of_letter is None else
                 replicate(np.asarray(owner_of_letter, np.int32), mesh, keep))
    capacity = default_capacity(tok_cap, n)
    retries = 0
    while True:
        per_shard = [_shard_rows(data[s], ends[s], ids[s], width=width, tok_cap=tok_cap,
                                 num_docs=num_docs, sort_cols=sort_cols, num_shards=n,
                                 owner_of_letter=None if owner_dev is None else owner_dev[s])
                     for s in range(n)]
        recv, overflows = exchange_rows([p[0] for p in per_shard], [p[1] for p in per_shard],
                                        mesh=mesh, capacity=capacity)
        live = live_groups_for(sort_cols, width)
        ngroups = num_groups_for(width)
        blocks = []
        for rows in recv:
            zero = torch.zeros(n * capacity, dtype=torch.int32, device=rows[0].device)
            groups = ([(rows[2 * g], rows[2 * g + 1]) for g in range(live)]
                      + [(zero, zero)] * (ngroups - live))
            num_words, num_pairs, df, postings, unique_groups = sort_dedup_groups(
                groups, rows[-1], n * capacity, live)
            # unique_groups are zero past num_words, so the nonzero count
            # of group 1's hi IS the >12-char word count
            num_long = ((unique_groups[1][0] != 0).sum(dtype=torch.int32)
                        if len(unique_groups) > 1
                        else torch.zeros((), dtype=torch.int32, device=df.device))
            blocks.append({"counts": torch.stack([num_words, num_pairs, num_long]),
                           "df": df, "postings": postings, "unique_groups": unique_groups})
        # [max word len, overflow, max shard tokens, max owner words,
        #  pairs, long words]: one read
        g = gather_host([torch.cat([torch.stack([p[2], o.to(torch.int32), p[3]]), b["counts"]])
                         for p, o, b in zip(per_shard, overflows, blocks)], mesh)
        if int(g[:, 1].sum()) > 0 and capacity < tok_cap:
            capacity = tok_cap  # provably safe: a shard holds <= tok_cap rows
            retries += 1
            continue
        break
    max_len = int(g[:, 0].max())
    max_shard_tokens = int(g[:, 2].max())
    if max_shard_tokens + 1 > tok_cap:
        raise AssertionError(
            f"device token count {max_shard_tokens} exceeded tok_cap {tok_cap}: host mask "
            "count diverged from the device classifier (bug)")
    mx = g[:, 3:].max(axis=0)
    owners = fetch_owner_blocks(
        blocks, counts=g[:, 3:], local_len=n * capacity, width=width, sort_cols=sort_cols,
        max_doc_id=max_doc_id, max_words=int(mx[0]), max_pairs=int(mx[1]),
        max_long=int(mx[2]), stats=stats)
    if stats is not None:
        stats["exchange_retries"] = retries
        stats["exchange_capacity"] = capacity
    return owners, (max_len, retries)


def fetch_owner_blocks(blocks, *, counts: np.ndarray, local_len: int, width: int,
                       sort_cols: int | None, max_doc_id: int | None, max_words: int,
                       max_pairs: int, max_long: int, stats: dict | None = None) -> dict:
    """Fetch each owner's index block — the shared tail of the mesh
    device engines (one-shot and streaming).

    ``blocks[o]`` holds owner o's ``df``, ``postings`` and
    ``unique_groups`` tensors; ``counts[o]`` its (words, pairs, long
    words); ``max_*`` the maxima over owners, which size one prefix
    slice for every owner.  Transfer trimming is the single-device
    tail's (``device_tokenizer.fetch_pack``): postings pack 3 doc ids
    per int32 when they fit 10 bits (16 bits under 2^16, int32 above),
    and tail groups travel sparsely.
    """
    ngroups_fetch = min(len(blocks[0]["unique_groups"]), live_groups_for(sort_cols, width))
    narrow = max_doc_id is not None and max_doc_id < (1 << 16)
    k = doc_pack_width(max_doc_id) if max_doc_id else 1
    # 1k granule: fetched bytes track the largest owner's unique counts
    nu = min(local_len, round_up(max(max_words, 1), 1 << 10))
    npairs = min(local_len, round_up(max(max_pairs, 1), 1 << 10))
    nlong = (min(nu, round_up(max_long, 1 << 10))
             if ngroups_fetch > 1 and max_long else 0)
    pending = []
    for b in blocks:  # every copy starts before any is read
        packed = fetch_pack(b, nu=nu, npairs=npairs, nlong=nlong, k=k, live=ngroups_fetch,
                            narrow=narrow)
        pending.append({name: [PendingFetch(t) for t in leaves(v)]
                        for name, v in packed.items()})
    owners = {}
    fetched = 0
    for o, ps in enumerate(pending):
        host = {name: [host_view(p.wait()) for p in lst] for name, lst in ps.items()}
        fetched += sum(a.nbytes for arrays in host.values() for a in arrays)
        num_words, num_pairs, num_long = (int(v) for v in counts[o])
        tails = host.get("tail", [])
        groups = ([tuple(h[:num_words] for h in host["g0"])]
                  + rebuild_tail_groups(
                      num_words, ngroups_fetch,
                      idx=host["long_idx"][0][:num_long] if nlong else None,
                      tails=[(tails[2 * g], tails[2 * g + 1]) for g in range(len(tails) // 2)],
                      num_long=num_long if nlong else 0))
        owners[o] = {
            "num_words": num_words, "num_pairs": num_pairs,
            "df": host["df"][0][:num_words].astype(np.int32),
            "postings": unpack_postings(host["post"][0], num_pairs, k),
            "unique_groups": groups,
        }
    if stats is not None:
        stats["dist_fetched_bytes"] = fetched
    return owners
