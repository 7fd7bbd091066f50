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

    rows   <- sort_unique_rows(tokenize_window(local byte shard))
    counts <- bucket(rows, mix32 % n)        read on the host
    recv   <- all_to_all(live columns of rows, capacity = the largest bucket)
    acc_o  <- sort_unique_rows(acc_o[:count_o] ++ recv[valid])
    at the end: finalize_rows_body(acc_o)

``sort_unique_rows`` and ``finalize_rows_body`` are the word-row
reduction of ``ops/device_tokenizer.py``, which every all-device plan
runs; the owners' fold, ``_merge_unique_rows``, calls it on the live
pairs and the doc alone, so exchanged columns merge as they arrive.

Each shard dedups its window before the exchange, so a word crosses at
most once per (shard, document), and the Zipf head, which would fill
one owner's buckets with its tokens, sends one row a document.  The one
host read of a window holds every shard's bucket counts and every
owner's count after the previous merge: the exchange is sized to the
largest bucket, and each owner merges its valid rows with the rows it
received (each source's block cut to its count) into an accumulator of
that many rows.  Neither can overflow, so nothing is retried, and the
card's work follows each owner's rows: no capacity grown ahead of them,
no owner padded to the largest.  Exactness is the
family's: the caller rejects an over-width window before feeding it
(WidthOverflow), and every window's device statistics are checked
against the host classifier at finalize.  Inside a process group each
process holds its own positions' accumulators: every size is taken from
the read, the same array in every process, and :meth:`finalize` fetches
this process's owners.  The port's own design: the JAX package's
``parallel/dist_device_streaming.py`` exchanges every token at a fixed
capacity and sort-merges each owner's whole capacity.

Inside a build each window's ``tokenize``, ``exchange`` and ``merge``
are steps of the running timer (spans under the plan's ``feed``), the
per-window read a ``card_wait``.  What crossed between positions is
counted as the engine goes (:attr:`exchange_bytes`, as
``mesh.all_to_all`` sent it; :attr:`exchange_valid_rows` and
:attr:`exchange_valid_bytes`, the rows of it that are not padding), and
:meth:`finalize` keeps each owner's unique rows (:attr:`owner_rows`);
the ``stats`` it fills keep the JAX package's keys.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import timing
from ..ops.device_streaming import _merge_unique_rows, window_rows
from ..ops.device_tokenizer import (INT32_MAX, check_max_word_len, check_token_count,
                                    finalize_rows_body, live_groups_for, num_groups_for)
from ..utils.rounding import round_up
from .dist_device_tokenizer import _mix32, bucket_rows, exchange_buckets, fetch_owner_blocks
from .mesh import Mesh, agree_max, gather_host, shard_parts


class DistDeviceStreamEngine:
    """Hash-sharded bounded row accumulators over a raw byte-window
    stream.  ``initial_capacity`` is the least length of an owner's
    accumulator.  The caller rejects WidthOverflow per window before
    feeding and supplies the window's host statistics
    (``host_token_stats`` per byte shard)."""

    def __init__(self, *, width: int, mesh: Mesh, window_pad: int = 1 << 13,
                 initial_capacity: int = 1 << 15):
        self._width = width
        self._num_groups = num_groups_for(width)
        self._mesh = mesh
        self._n = mesh.size
        self._window_pad = window_pad
        self._least = self._cap = initial_capacity
        self._acc = None         # per local owner: 2 * num_groups + 1 columns
        self._counts = None      # per local owner: its unique rows, on its card
        self._live_groups = 1
        self.windows_fed = 0
        self.max_word_len = 0
        #: nothing is retried (every size comes from the window's read);
        #: kept for the stats' keys
        self.merge_retries = 0
        #: bytes of every exchange, as sent (padding included), and the
        #: rows, and their bytes, that changed position
        self.exchange_bytes = 0
        self.exchange_valid_rows = 0
        self.exchange_valid_bytes = 0
        #: each owner's unique (word, doc) rows, set by finalize
        self.owner_rows: list[int] = []
        self._window_checks: list = []  # (device max len, tok_cap, device tokens, host max len)

    @property
    def capacity(self) -> int:
        """The longest owner's accumulator (its valid rows first,
        INT32_MAX padding after), over every owner of the mesh."""
        return self._cap

    def feed(self, shard_bufs, shard_ends, shard_ids, *, tok_count: int, max_len: int) -> None:
        """Tokenize, dedup, exchange and fold one sharded byte window.

        ``tok_count`` / ``max_len``: the max per-shard token count and
        max cleaned length over the window's shards (host-exact; the max
        over the processes is taken); the caller has already rejected
        ``max_len > width``.  Only this process's positions of the
        per-shard lists are read, each copied fresh before upload."""
        tok_count, max_len = agree_max([tok_count, max_len], self._mesh)
        if tok_count == 0:
            return
        n = self._n
        self.max_word_len = max(self.max_word_len, max_len)
        # sort_cols tracks the stream's running max length, so the
        # window's live group count equals self._live_groups
        sort_cols = -(-max(self.max_word_len, 1) // 4)
        self._live_groups = lg = max(self._live_groups, live_groups_for(sort_cols, self._width))
        tok_cap = round_up(tok_count + 1, self._window_pad)
        out_cap = round_up(min(tok_count, tok_cap), self._window_pad)
        keep: list = []
        data = shard_parts(shard_bufs, self._mesh, keep)
        ends = shard_parts(shard_ends, self._mesh, keep)
        ids = shard_parts(shard_ids, self._mesh, keep)
        num_docs = shard_ends[self._mesh.first].shape[0]
        devices = self._mesh.devices
        if self._acc is None:
            self._acc = [tuple(torch.empty(0, dtype=torch.int32, device=d)
                               for _ in range(2 * self._num_groups + 1)) for d in devices]
            self._counts = [torch.zeros((), dtype=torch.int32, device=d) for d in devices]
        send_rows, buckets, reads = [], [], []
        with timing.step("tokenize"):
            for s in range(len(devices)):
                rows, checks = window_rows(
                    data[s], ends[s], ids[s], width=self._width, tok_cap=tok_cap,
                    num_docs=num_docs, sort_cols=sort_cols, num_groups=self._num_groups,
                    out_cap=out_cap)
                # ownership is stable over the whole stream: the hash folds
                # every group pair (the ones past the live bound are the
                # constant zeros they provably are) — hashing only the live
                # columns would re-home a word once longer words appear
                h = _mix32(rows[:-1])
                owner = torch.where(rows[0] != INT32_MAX, (h % n).to(torch.int32), n)
                buckets.append(bucket_rows(owner, n))
                send_rows.append(list(rows[:2 * lg]) + [rows[-1]])
                reads.append(torch.cat([self._counts[s].reshape(1), buckets[-1][1], checks[1:]]))
        # row p is position p's: its owner's rows after the last merge,
        # its shard's bucket counts (its own included), max len, tokens
        g = gather_host(reads, self._mesh).astype(np.int64)
        held, sent = g[:, 0], g[:, 1:1 + n]
        self._window_checks.append((int(g[:, -2].max()), tok_cap, int(g[:, -1].max()), max_len))
        capacity = round_up(max(int(sent.max()), 1), 8)
        ncols = len(send_rows[0])
        with timing.step("exchange"):
            before = self._mesh.exchanged_bytes
            recv = exchange_buckets(send_rows, buckets, mesh=self._mesh, capacity=capacity)
            self.exchange_bytes += self._mesh.exchanged_bytes - before
        del send_rows, buckets
        moved = int(sent.sum() - np.trace(sent))
        self.exchange_valid_rows += moved
        self.exchange_valid_bytes += moved * ncols * 4
        # an owner's valid rows plus what it receives bound its new
        # unique rows: that is its accumulator's length
        lens = np.maximum(held + sent.sum(axis=0), self._least)
        self._cap = int(lens.max())
        new_acc, counts = [], []
        with timing.step("merge"):
            for acc, rows, o in zip(self._acc, recv, self._mesh.local_positions):
                got = [torch.cat([c[s * capacity:s * capacity + int(sent[s, o])]
                                  for s in range(n)]) for c in rows]
                folded, count = _merge_unique_rows(tuple(a[:int(held[o])] for a in acc), got,
                                                   cap=int(lens[o]), live_groups=lg)
                new_acc.append(folded)
                counts.append(count)
        self._acc, self._counts = new_acc, counts
        self.windows_fed += 1

    def finalize(self, *, sort_cols: int | None, max_doc_id: int, stats: dict | None = None):
        """This process's owners' index blocks (``{owner: dict}``, the
        one-shot mesh engine's contract).  Checks every window's device
        statistics against the host classifier first."""
        if self._acc is None:
            raise ValueError("no windows fed")
        for dev_max_len, tok_cap, dev_tokens, host_max_len in self._window_checks:
            check_token_count(dev_tokens, tok_cap)
            check_max_word_len(dev_max_len, host_max_len)
        blocks = [finalize_rows_body(acc, num_groups=self._num_groups,
                                     live_groups=self._live_groups) for acc in self._acc]
        self._acc = self._counts = None
        self._window_checks = []
        counts = gather_host([b["counts"] for b in blocks], self._mesh)
        self.owner_rows = [int(v) for v in counts[:, 1]]
        mx = counts.max(axis=0)
        owners = fetch_owner_blocks(
            blocks, counts=counts, width=self._width,
            sort_cols=sort_cols, max_doc_id=max_doc_id, max_words=int(mx[0]),
            max_pairs=int(mx[1]), max_long=int(mx[2]), stats=stats,
            positions=self._mesh.local_positions)
        if stats is not None:
            stats["merge_retries"] = self.merge_retries
            stats["accumulator_capacity_per_owner"] = self._cap
        return owners
