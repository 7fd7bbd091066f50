"""Mesh streaming engine: bounded per-owner accumulators over a pair
stream.

Combines the two scale axes the single-device engines cover apart:

- **streaming** (ops/streaming.py): the device carries only the sorted
  unique pairs seen so far, bounded by output size, not stream length;
- **mesh** (parallel/dist_engine.py): pairs are hash-partitioned over
  the shards with one ``all_to_all`` per window, so each owner's
  accumulator holds only its own terms — memory per shard is
  O(unique / n), and the map->reduce spill files of the reference
  (main.c:332-341) never exist.

Per window, for every shard:

    recv   <- all_to_all(bucket(window, term % n))
    acc_d  <- compact(unique(sort(acc_d ++ recv)))

Two accumulator forms switch automatically mid-stream, as in the
single-device engine: **packed** (one int32 ``term * stride + doc``
key) while the growing vocabulary still packs (``K.can_pack``), and
**pairs** (term and doc arrays, one int64 key per sort) once it
outgrows int32.  Cross-window duplicates fold into the accumulator
like the reference reducer's dedup (main.c:176-184).

A per-owner bound cannot be derived on the host without assuming hash
uniformity, so each feed reads the max per-owner count (one value per
window) and an overflowing merge is retried against the preserved
previous accumulator at a doubled capacity.  The counterpart of the JAX
package's ``parallel/dist_streaming.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import keys as K
from ..ops.engine import PendingFetch
from ..ops.segment import bucket_edges
from ..ops.streaming import _merge_unique, _merge_unique_pairs, _regrow, _unpack_acc
from ..utils.rounding import round_up
from .dist_engine import bucket_sends, default_capacity, send_buffer
from .mesh import Mesh, all_to_all, gather_host, shard


def _pair_sends(term: torch.Tensor, doc: torch.Tensor, *, num_shards: int, capacity: int):
    """Pair-mode side of the exchange: bucket (term, doc) rows by
    ``term % n`` and lay both halves side by side (``[terms | docs]``
    per destination row).  The three-key (bucket, term, doc) order is
    two stable sorts: by ``term << 31 | doc``, then by bucket."""
    valid = term < K.INT32_MAX
    bucket = torch.where(valid, term % num_shards, num_shards)
    perm = torch.sort((term.to(torch.int64) << 31) | doc.to(torch.int64)).indices
    b_s, inner = torch.sort(bucket[perm], stable=True)
    perm = perm[inner]
    counts, offsets = bucket_edges(b_s, num_shards)
    overflow = (counts > capacity).any()
    return send_buffer([term, doc], perm, counts, offsets, capacity=capacity), overflow


class DistStreamingIndexEngine:
    """Hash-sharded bounded accumulator over a provisional-id pair stream.

    One sorted-unique buffer per owner; each :meth:`feed` shuffles a
    window over the mesh and folds it in.  ``initial_capacity`` is *per
    owner*.  Starts packed and switches for good to pairs the first
    time ``vocab_size_so_far`` stops packing into int32 keys.
    """

    def __init__(self, *, max_doc_id: int, mesh: Mesh, window_pad: int = 1 << 16,
                 initial_capacity: int = 1 << 16):
        self._stride = max_doc_id + 2
        self._max_doc_id = max_doc_id
        self._mesh = mesh
        self._n = mesh.size
        self._window_pad = window_pad
        self._cap = initial_capacity
        self._acc = None        # packed: per-owner keys
        self._acc_pair = None   # pairs: per-owner (terms, docs)
        self._count = 0         # last observed max per-owner count
        self.windows_fed = 0
        self.merge_retries = 0

    @property
    def capacity(self) -> int:
        """Per-owner accumulator capacity."""
        return self._cap

    @property
    def mode(self) -> str:
        return "pairs" if self._acc_pair is not None else "packed"

    def _empty(self) -> list[torch.Tensor]:
        return [torch.full((self._cap,), K.INT32_MAX, dtype=torch.int32, device=d)
                for d in self._mesh.devices]

    def _switch_to_pairs(self) -> None:
        if self._acc is None:
            self._acc_pair = (self._empty(), self._empty())
            return
        unpacked = [_unpack_acc(a, self._stride) for a in self._acc]
        self._acc_pair = ([t for t, _ in unpacked], [d for _, d in unpacked])
        self._acc = None

    def _merge(self, window, exchange_cap: int):
        """One exchange and fold; returns the new per-owner accumulators
        and ``[max count, exchange overflow]`` read on the host."""
        n = self._n
        if self.mode == "packed":
            sends, overflows = zip(*(
                bucket_sends(w, K.INT32_MAX, num_shards=n, capacity=exchange_cap,
                             stride=self._stride) for w in window[0]))
            recv = all_to_all(list(sends), self._mesh)
            acc, counts = zip(*(_merge_unique(a, r, self._cap)
                                for a, r in zip(self._acc, recv)))
            acc = list(acc)
        else:
            sends, overflows = zip(*(
                _pair_sends(t, d, num_shards=n, capacity=exchange_cap)
                for t, d in zip(*window)))
            recv = [r.reshape(n, 2, exchange_cap) for r in all_to_all(list(sends), self._mesh)]
            folded, counts = zip(*(
                _merge_unique_pairs(at, ad, r[:, 0, :].reshape(-1), r[:, 1, :].reshape(-1),
                                    self._cap)
                for at, ad, r in zip(*self._acc_pair, recv)))
            acc = ([f[0] for f in folded], [f[1] for f in folded])
        flags = gather_host([torch.stack([c, o.to(torch.int32)])
                             for c, o in zip(counts, overflows)], self._mesh)
        return acc, int(flags[:, 0].max()), int(flags[:, 1].sum())

    def feed(self, prov_term_ids: np.ndarray, doc_ids: np.ndarray,
             vocab_size_so_far: int) -> None:
        """Shuffle and fold one window of (provisional term, doc) pairs."""
        n_pairs = int(prov_term_ids.shape[0])
        if n_pairs == 0:
            return
        if self.mode == "packed" and not K.can_pack(vocab_size_so_far, self._max_doc_id):
            self._switch_to_pairs()
        padded = round_up(round_up(n_pairs, max(self._window_pad, self._n)), self._n)
        window_local = padded // self._n
        exchange_cap = default_capacity(window_local, self._n)
        keep: list = []
        if self.mode == "packed":
            if self._acc is None:
                self._acc = self._empty()
            host = np.full(padded, K.INT32_MAX, np.int32)
            np.multiply(prov_term_ids, self._stride, out=host[:n_pairs])
            host[:n_pairs] += doc_ids
            window = (shard(host, self._mesh, keep),)
        else:
            ht = np.full(padded, K.INT32_MAX, np.int32)
            hd = np.full(padded, K.INT32_MAX, np.int32)
            ht[:n_pairs] = prov_term_ids
            hd[:n_pairs] = doc_ids
            window = (shard(ht, self._mesh, keep), shard(hd, self._mesh, keep))

        while True:
            acc, max_count, overflow = self._merge(window, exchange_cap)
            if overflow > 0:
                exchange_cap = window_local  # provably safe
                self.merge_retries += 1
                continue
            if max_count > self._cap:
                # grow and retry against the preserved accumulator
                while self._cap < max_count:
                    self._cap *= 2
                self.merge_retries += 1
                self._regrow_acc()
                continue
            break
        if self.mode == "packed":
            self._acc = acc
        else:
            self._acc_pair = acc
        self._count = max_count
        # grow ahead of the next window once 3/4 full (amortized)
        if self._count * 4 > self._cap * 3:
            self._cap *= 2
            self._regrow_acc()
        self.windows_fed += 1

    def _regrow_acc(self) -> None:
        """Pad the live accumulator buffers up to the current capacity."""
        if self._acc is not None and self._acc[0].shape[0] < self._cap:
            self._acc = [_regrow(a, self._cap) for a in self._acc]
        if self._acc_pair is not None and self._acc_pair[0][0].shape[0] < self._cap:
            self._acc_pair = tuple([_regrow(a, self._cap) for a in half]
                                   for half in self._acc_pair)

    def finalize(self, stats: dict | None = None):
        """``(mode, {owner: rows})``, valid prefix only — the capacity
        tail never crosses to the host.  Packed: rows are sorted packed
        keys.  Pairs: rows are ``(terms, docs)`` sorted by (term, doc)."""
        mode = self.mode
        if self._acc is None and self._acc_pair is None:
            return mode, {}
        nfetch = min(self._cap, round_up(max(self._count, 1), 1 << 13))

        def start(arrs):
            return [PendingFetch(a[:nfetch]) for a in arrs]

        if mode == "packed":
            pending = start(self._acc)
            rows_k = [p.wait() for p in pending]
            fetched = sum(r.nbytes for r in rows_k)
            rows = {o: r[r < K.INT32_MAX] for o, r in enumerate(rows_k)}
        else:
            pending_t, pending_d = start(self._acc_pair[0]), start(self._acc_pair[1])
            rows_t = [p.wait() for p in pending_t]
            rows_d = [p.wait() for p in pending_d]
            fetched = sum(r.nbytes for r in rows_t) + sum(r.nbytes for r in rows_d)
            rows = {}
            for o, (t, d) in enumerate(zip(rows_t, rows_d)):
                valid = t < K.INT32_MAX
                rows[o] = (t[valid], d[valid])
        if stats is not None:
            stats["dist_fetched_bytes"] = fetched
        self._acc = self._acc_pair = None
        return mode, rows
