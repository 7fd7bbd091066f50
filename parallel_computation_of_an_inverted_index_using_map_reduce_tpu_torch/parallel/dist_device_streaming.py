"""Mesh streaming all-device engine: sharded raw byte windows in,
bounded per-owner word-row accumulators on every shard.

The last cell of {device scan} x {mesh} x {streaming}:

- **device scan** (ops/device_tokenizer.py): the whole map phase as
  tensor ops over raw bytes — no host tokenizer;
- **streaming** (ops/device_streaming.py): each owner carries only the
  unique (word, doc) rows seen so far, as 30-bit (hi, lo) code pairs
  plus the doc, bounded by output size, not stream length;
- **mesh** (parallel/dist_device_tokenizer.py): word rows are
  content-hash-partitioned with one ``all_to_all`` per window, so each
  owner's accumulator holds only its own terms.

Per window, for every shard:

    rows   <- tokenize_groups(local byte shard)
    recv   <- all_to_all(bucket(rows, mix32 % n))
    acc_o  <- compact(unique(sort(acc_o ++ recv)))

A per-owner bound cannot be derived on the host without assuming hash
uniformity, so each merge reads the max per-owner count (one read per
window) and an overflowing merge retries against the preserved previous
accumulator at a doubled capacity.  Exactness is the family's: the
caller rejects an over-width window before feeding it (WidthOverflow),
and every window's device statistics are checked against the host
classifier at finalize.  The counterpart of the JAX package's
``parallel/dist_device_streaming.py``.
"""

from __future__ import annotations

import torch

from ..ops.device_streaming import _merge_unique_rows, _regrow_rows, finalize_rows_body
from ..ops.device_tokenizer import INT32_MAX, live_groups_for, num_groups_for, tokenize_groups
from ..utils.rounding import round_up
from .dist_device_tokenizer import _mix32, exchange_rows, fetch_owner_blocks
from .dist_engine import default_capacity
from .mesh import Mesh, gather_host, shard_parts


class DistDeviceStreamEngine:
    """Hash-sharded bounded row accumulators over a raw byte-window
    stream.  ``initial_capacity`` is *per owner*.  The caller rejects
    WidthOverflow per window before feeding and supplies the window's
    host statistics (``host_token_stats`` per byte shard)."""

    def __init__(self, *, width: int, mesh: Mesh, window_pad: int = 1 << 13,
                 initial_capacity: int = 1 << 15):
        self._width = width
        self._num_groups = num_groups_for(width)
        self._mesh = mesh
        self._n = mesh.size
        self._window_pad = window_pad
        self._cap = initial_capacity
        self._acc = None         # per owner: 2 * num_groups + 1 columns
        self._count = 0          # last observed max per-owner count
        self._live_groups = 1
        self.windows_fed = 0
        self.max_word_len = 0
        self.merge_retries = 0
        self._window_checks: list = []  # (device max len, tok_cap, device tokens, host max len)

    @property
    def capacity(self) -> int:
        """Per-owner accumulator capacity."""
        return self._cap

    def _regrow(self) -> None:
        if self._acc is not None and self._acc[0][0].shape[0] < self._cap:
            self._acc = [_regrow_rows(acc, cap=self._cap) for acc in self._acc]

    def _merge(self, data, ends, ids, *, tok_cap: int, num_docs: int, sort_cols: int,
               exchange_cap: int):
        """Tokenize every shard, exchange rows by content hash, fold each
        owner's received rows into its accumulator.  Returns the new
        accumulators and ``[max count, overflow, max word len, max shard
        tokens]`` read on the host."""
        n = self._n
        lg = self._live_groups
        send_rows, owners, lens, toks = [], [], [], []
        for s in range(n):
            groups, doc_col, max_len, num_tokens = tokenize_groups(
                data[s], ends[s], ids[s], width=self._width, tok_cap=tok_cap,
                num_docs=num_docs, sort_cols=sort_cols)
            valid = groups[0][0] != INT32_MAX
            # ownership is stable over the whole stream: the hash folds
            # every group pair (the ones past the live bound are the
            # constant zeros they provably are) — hashing only the live
            # columns would re-home a word once longer words appear
            h = _mix32([g for pair in groups for g in pair])
            owners.append(torch.where(valid, (h % n).to(torch.int32), n))
            send_rows.append([g for pair in groups[:lg] for g in pair] + [doc_col])
            lens.append(max_len.to(torch.int32))
            toks.append(num_tokens)
        recv, overflows = exchange_rows(send_rows, owners, mesh=self._mesh,
                                        capacity=exchange_cap)
        del send_rows, owners
        new_acc, counts = [], []
        for acc, rows in zip(self._acc, recv):
            # the un-exchanged group pairs are the zeros they provably are
            zero = torch.zeros(n * exchange_cap, dtype=torch.int32, device=rows[0].device)
            full = rows[:-1] + [zero] * (2 * (self._num_groups - lg)) + [rows[-1]]
            folded, count = _merge_unique_rows(acc, full, cap=self._cap, live_groups=lg)
            new_acc.append(folded)
            counts.append(count)
        g = gather_host([torch.stack([c, o.to(torch.int32), ml, nt])
                         for c, o, ml, nt in zip(counts, overflows, lens, toks)], self._mesh)
        return new_acc, [int(g[:, 0].max()), int(g[:, 1].sum()), int(g[:, 2].max()),
                         int(g[:, 3].max())]

    def feed(self, shard_bufs, shard_ends, shard_ids, *, tok_count: int, max_len: int) -> None:
        """Tokenize, exchange and fold one sharded byte window.

        ``tok_count`` / ``max_len``: the max per-shard token count and
        max cleaned length over the window's shards (host-exact); the
        caller has already rejected ``max_len > width``.  Each shard's
        arrays are copied fresh before upload."""
        if tok_count == 0:
            return
        self.max_word_len = max(self.max_word_len, max_len)
        # sort_cols tracks the stream's running max length, so the
        # window's live group count equals self._live_groups
        sort_cols = -(-max(self.max_word_len, 1) // 4)
        self._live_groups = max(self._live_groups, live_groups_for(sort_cols, self._width))
        tok_cap = round_up(tok_count + 1, self._window_pad)
        exchange_cap = default_capacity(tok_cap, self._n)
        keep: list = []
        data = shard_parts(shard_bufs, self._mesh, keep)
        ends = shard_parts(shard_ends, self._mesh, keep)
        ids = shard_parts(shard_ids, self._mesh, keep)
        num_docs = shard_ends[0].shape[0]
        if self._acc is None:
            self._acc = [tuple(torch.full((self._cap,), INT32_MAX, dtype=torch.int32, device=d)
                               for _ in range(2 * self._num_groups + 1))
                         for d in self._mesh.devices]
        while True:
            acc, g = self._merge(data, ends, ids, tok_cap=tok_cap, num_docs=num_docs,
                                 sort_cols=sort_cols, exchange_cap=exchange_cap)
            if g[1] > 0 and exchange_cap < tok_cap:
                exchange_cap = tok_cap  # provably safe: <= tok_cap rows per shard
                self.merge_retries += 1
                continue
            if g[0] > self._cap:
                while self._cap < g[0]:
                    self._cap *= 2
                self.merge_retries += 1
                self._regrow()
                continue
            break
        self._acc = acc
        self._count = g[0]
        self._window_checks.append((g[2], tok_cap, g[3], max_len))
        # grow ahead of the next window once 3/4 full (amortized)
        if self._count * 4 > self._cap * 3:
            self._cap *= 2
            self._regrow()
        self.windows_fed += 1

    def finalize(self, *, sort_cols: int | None, max_doc_id: int, stats: dict | None = None):
        """Per-owner index blocks (``{owner: dict}``, the one-shot mesh
        engine's contract).  Checks every window's device statistics
        against the host classifier first."""
        if self._acc is None:
            raise ValueError("no windows fed")
        for dev_max_len, tok_cap, dev_tokens, host_max_len in self._window_checks:
            if dev_tokens + 1 > tok_cap:
                raise AssertionError(
                    f"device token count {dev_tokens} exceeded tok_cap {tok_cap}: host mask "
                    "count diverged from the device classifier (bug)")
            if dev_max_len != host_max_len:
                raise AssertionError(
                    f"device max word len {dev_max_len} != host {host_max_len}: "
                    "classifier divergence (bug)")
        blocks = [finalize_rows_body(acc, num_groups=self._num_groups) for acc in self._acc]
        self._acc = None
        self._window_checks = []
        counts = gather_host([b["counts"] for b in blocks], self._mesh)
        mx = counts.max(axis=0)
        owners = fetch_owner_blocks(
            blocks, counts=counts, local_len=self._cap, width=self._width,
            sort_cols=sort_cols, max_doc_id=max_doc_id, max_words=int(mx[0]),
            max_pairs=int(mx[1]), max_long=int(mx[2]), stats=stats)
        if stats is not None:
            stats["merge_retries"] = self.merge_retries
            stats["accumulator_capacity_per_owner"] = self._cap
        return owners
