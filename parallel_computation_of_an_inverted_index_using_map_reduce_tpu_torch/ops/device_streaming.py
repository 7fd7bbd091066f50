"""Streaming all-device engine: raw byte windows in, bounded rows kept.

The one-shot all-device program (ops/device_tokenizer.py) needs the whole
corpus byte tensor and its token-capacity arrays on the card at once.
Here the corpus arrives in document-aligned byte windows and the card
carries only the **unique (word, doc) rows seen so far**, each row the
``num_groups_for(width)`` 30-bit (hi, lo) 5-bit-group code pairs that
``device_tokenizer.tokenize_groups`` emits, plus the doc id — bounded by
the output's unique-pair count, not the stream length.  The
accumulator discipline of the integer-pair streaming engine
(ops/streaming.py), lifted from packed ints to word rows:

    per window:  rows  <- sort_unique_rows(tokenize_window(bytes))
                 acc   <- merge(acc, rows)
    at the end:  index <- finalize_rows_body(acc)

``sort_unique_rows`` and ``finalize_rows_body`` are the word-row
reduction of ``ops/device_tokenizer.py``, the one every all-device plan
runs (one-shot or streaming, one card or the mesh); the two kernels are
hand-written (``kernels.tokenize_window``, which tokenizes the window in
one read of its bytes, and ``kernels.merge_sorted_rows``: both operands
are sorted and unique, so the merge needs no sort).  Sizes are fixed by
the host and no wait on the card in the stream loop: the
host bounds the unique rows by the tokens fed (``host_token_stats``,
already computed per window for ``tok_cap``) and doubles the capacity
*before* a window that could overflow it; the merge writes straight
into the larger capacity.  The merge reads its operands' valid counts on
the card; they travel back through ``engine.PendingFetch`` and are read
two merges late; the per-window device checks are read only at
``snapshot`` and ``finalize``.  Radix passes over word groups the stream
has not reached yet are skipped (the host's running max cleaned length
is exact).

Exactness: rows are the actual cleaned bytes under an injective code map
— no hashing; a window whose longest cleaned token exceeds ``width``
raises WidthOverflow in the caller *before* it is fed, and the model
restarts on a host-scan plan.  The counterpart of the JAX package's
``ops/device_streaming.py``: the same rows, counts and outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import faults
from ..utils.rounding import round_up
from . import engine, kernels
from .device_tokenizer import (INT32_MAX, check_max_word_len, check_token_count,
                               finalize_rows_body, live_groups_for, num_groups_for,
                               sort_unique_rows)


def window_rows(data, doc_ends, doc_id_values, *, width: int, tok_cap: int, num_docs: int,
                sort_cols: int, num_groups: int, out_cap: int):
    """One byte window -> its deduped (group rows…, doc) rows:
    ``kernels.tokenize_window``, then the one reduction,
    :func:`device_tokenizer.sort_unique_rows`, over its live pairs.

    Returns ``(rows, counts)``: ``rows`` is ``2 * num_groups + 1`` int32
    tensors of length ``out_cap`` (the unique rows first, in sorted
    order, INT32_MAX padding after); ``counts = [num_pairs,
    max_word_len, num_tokens]`` for the caller's divergence checks (read
    later, never inside the stream loop).
    """
    groups, doc_col, max_word_len, num_tokens = kernels.tokenize_window(
        data, doc_ends, doc_id_values, width=width, tok_cap=tok_cap,
        num_docs=num_docs, sort_cols=sort_cols)
    cols = [h for pair in groups[:live_groups_for(sort_cols, width)] for h in pair] + [doc_col]
    del groups, doc_col
    rows, count = sort_unique_rows(cols, num_groups=num_groups, out_cap=out_cap)
    return rows, torch.stack([count, max_word_len.to(torch.int32), num_tokens])


def _merge_unique_rows(acc, window, *, cap: int, live_groups: int):
    """Fold a window's rows into the sorted-unique accumulator ``acc``
    (``2 * num_groups + 1`` columns): the operands' first
    ``live_groups`` pairs and their doc columns, concatenated, through
    :func:`device_tokenizer.sort_unique_rows` into ``cap`` rows.
    Returns ``(rows, count)``, the count exact (padding rows never
    count).

    ``window`` comes in any order, with the later pairs or without
    them: the mesh engine passes its exchanged live columns as they
    arrive.  The later pairs are zero on every valid row of both
    operands (the stream's running ``live_groups`` covers every nonzero
    char), so they are never read.  The single-card engine, whose
    windows come sorted and unique, merges with
    ``kernels.merge_sorted_rows``, whose plain version this is."""
    cols = [torch.cat([acc[i], window[i]]) for i in [*range(2 * live_groups), -1]]
    return sort_unique_rows(cols, num_groups=len(acc) // 2, out_cap=cap)


def _head_rows(acc, *, pad: int) -> tuple:
    """The first ``pad`` rows of every accumulator column: a snapshot
    fetches only these instead of the whole capacity, which can sit at
    ~2x the live count right after a doubling."""
    return tuple(a[:pad] for a in acc)


class DeviceStreamEngine:
    """Bounded-memory all-device reduction over a raw byte-window stream
    on ``device``.

    ``width`` fixes the row shape for the whole stream; the caller
    rejects a window whose host-exact max cleaned length exceeds it
    (WidthOverflow) before feeding it, so the accumulator never holds a
    truncated row.  ``window_pad`` rounds each window's token capacity.

    Each window is staged in pinned memory (``engine.upload``) from the
    caller's fresh host arrays, which it must not mutate afterwards (on
    the CPU the tensors share their memory); the pinned blocks are held
    until that window's merge count has been read.
    """

    def __init__(self, *, width: int, device: torch.device | str = "cuda",
                 window_pad: int = 1 << 14, initial_capacity: int = 1 << 16):
        self._width = width
        self._device = torch.device(device)
        self._num_groups = num_groups_for(width)
        self._window_pad = window_pad
        self._cap = initial_capacity
        self._acc = None
        self._acc_count = None     # the accumulator's valid rows, on the card
        self._unique_bound = 0     # host bound on the unique rows in acc
        self._resolved_rows = 0    # the last resolved merge's count
        # in-flight merges, oldest first: (count fetch, tokens folded,
        # pinned uploads, the window's counts fetch); depth 2 keeps one
        # merge queued while the previous one still runs
        self._pending: list = []
        self._max_inflight = 2
        self._live_groups = 1      # running ceil(ceil(maxlen / 4) / 3)
        self.windows_fed = 0
        self.max_word_len = 0
        self._window_checks: list = []   # (counts fetch, tok_cap, host max len)
        # snapshot prefix rounding: bounds the distinct prefix sizes while
        # keeping the over-fetch under one granule of rows per column
        self._snapshot_granule = 1 << 16
        # resolved unique-row counts in resolution order: the
        # accumulator's growth curve (trails windows_fed by the
        # in-flight merges; snapshot drains them, finalize leaves them)
        self.rows_curve: list[int] = []
        # window rows already in the accumulator, over the resolved merges
        self.merge_dup_rows = 0

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def snapshot_nbytes(self) -> int:
        """Bytes a :meth:`snapshot` would fetch now: a granule-padded
        prefix of every int32 column.  The snapshot drains the in-flight
        merges first, so the projection starts from the last resolved
        count, not from the bound that counts every pending window's
        tokens as unique."""
        if self._acc is None:
            return 0
        drained_bound = self._unique_bound - sum(p[1] for p in self._pending)
        pad = min(round_up(max(drained_bound, 1), self._snapshot_granule), self._cap)
        return (2 * self._num_groups + 1) * pad * 4

    def _ensure_capacity(self, extra: int) -> None:
        self._unique_bound += extra
        while self._unique_bound > self._cap:
            # grow BEFORE a merge that could overflow: no data loss and
            # no wait on the card; the next merge writes the new capacity
            self._cap *= 2

    def _resolve_oldest(self) -> int:
        fetch, _, _, checks = self._pending.pop(0)
        resolved = int(fetch.wait())
        # the window's pairs were counted before its merge ran: no wait
        pairs = int(checks.wait()[0])
        self.merge_dup_rows += self._resolved_rows + pairs - resolved
        self._resolved_rows = resolved
        self.rows_curve.append(resolved)
        return resolved

    def feed(self, buf: np.ndarray, ends: np.ndarray, ids: np.ndarray, *, tok_count: int,
             max_len: int, stage_hook=None) -> None:
        """Tokenize one padded byte window on the card and fold its
        unique rows into the accumulator.  ``tok_count`` and ``max_len``
        are the window's host-exact statistics (``host_token_stats``);
        the caller has already rejected ``max_len > width``.

        ``stage_hook(name, value)``, when given, is called after each
        stage (``upload``, ``window_rows``, ``merge``) with the stage's
        device tensors, so a caller can synchronize and time the stages
        of this very path.  A hooked feed also resolves every in-flight
        merge count at its end, which keeps capacity growth identical
        to a run with resolved counts.
        """
        if tok_count == 0:
            return
        self.max_word_len = max(self.max_word_len, max_len)
        sort_cols = -(-max(self.max_word_len, 1) // 4)
        self._live_groups = max(self._live_groups, live_groups_for(sort_cols, self._width))
        tok_cap = round_up(tok_count + 1, self._window_pad)
        out_cap = round_up(min(tok_count, tok_cap), self._window_pad)
        staged: list = []
        d_buf, d_ends, d_ids = (engine.upload(a, self._device, staged) for a in (buf, ends, ids))
        if stage_hook is not None:
            stage_hook("upload", (d_buf, d_ends, d_ids))
        rows, counts = window_rows(
            d_buf, d_ends, d_ids, width=self._width, tok_cap=tok_cap,
            num_docs=ends.shape[0], sort_cols=sort_cols, num_groups=self._num_groups,
            out_cap=out_cap)
        del d_buf, d_ends, d_ids
        checks = engine.PendingFetch(counts)
        self._window_checks.append((checks, tok_cap, max_len))
        if stage_hook is not None:
            stage_hook("window_rows", counts)
        # tighten the host bound with the count of the merge two back:
        # reading it before queueing this merge keeps two merges in
        # flight.  The bound stays safe — the last resolved true count
        # plus every token folded by the unresolved merges.
        while len(self._pending) >= self._max_inflight:
            resolved = self._resolve_oldest()
            self._unique_bound = resolved + sum(p[1] for p in self._pending)
        self._ensure_capacity(tok_count)
        if self._acc is None:
            # an empty accumulator: the first merge writes the capacity
            self._acc = tuple(torch.empty(0, dtype=torch.int32, device=self._device)
                              for _ in range(2 * self._num_groups + 1))
            self._acc_count = torch.zeros((), dtype=torch.int32, device=self._device)
        self._acc, count = kernels.merge_sorted_rows(
            self._acc, rows, self._acc_count, counts[0], cap=self._cap,
            live_groups=self._live_groups)
        self._acc_count = count
        del rows
        self._pending.append((engine.PendingFetch(count), tok_count, staged, checks))
        self.windows_fed += 1
        # fault hook (faults.py stream-crash:window=K): raise after this
        # window's merge is queued on the card but before any later
        # checkpoint — the worst crash position for the resume contract
        inj = faults.active()
        if inj is not None:
            inj.on_stream_window(self.windows_fed)
        if stage_hook is not None:
            stage_hook("merge", count)
            while self._pending:
                self._unique_bound = self._resolve_oldest()

    def _verify_window_checks(self) -> None:
        """Read and check every window's device statistics against the
        host classifier (shared by finalize and snapshot: a snapshot must
        not persist an unverified prefix)."""
        for fetch, tok_cap, host_max_len in self._window_checks:
            _pairs, dev_max_len, dev_tokens = (int(v) for v in fetch.wait())
            check_token_count(dev_tokens, tok_cap)
            check_max_word_len(dev_max_len, host_max_len)
        self._window_checks = []

    def snapshot(self) -> dict | None:
        """Verified host snapshot of the stream state — the durable form
        of the reference's spill files (main.c:332-341).

        Drains the in-flight merges, verifies every window fed so far,
        then fetches the accumulator's valid row prefix.  ``None`` when
        nothing has been fed.  The engine stays live: streaming goes on
        after a snapshot.
        """
        if self._acc is None:
            return None
        while self._pending:
            self._unique_bound = self._resolve_oldest()
        self._verify_window_checks()
        count = self._unique_bound
        # every valid row sits in acc[:count] (merges compact valid rows
        # first): fetch a granule-padded prefix, not the capacity
        pad = min(round_up(max(count, 1), self._snapshot_granule), self._cap)
        fetches = [engine.PendingFetch(h) for h in _head_rows(self._acc, pad=pad)]
        return {
            "width": self._width,
            # bytes this fetch moved: the checkpoint budget calibrates
            # its link rate from this, not from the pre-drain projection
            "fetched_nbytes": (2 * self._num_groups + 1) * pad * 4,
            "count": count,
            "cap": self._cap,
            "live_groups": self._live_groups,
            "max_word_len": self.max_word_len,
            "windows_fed": self.windows_fed,
            "rows_curve": list(self.rows_curve),
            "columns": [f.wait()[:count].copy() for f in fetches],
        }

    def restore(self, state: dict) -> None:
        """Rebuild the device accumulator from :meth:`snapshot` output
        (or a loaded stream checkpoint).  The engine must be fresh and of
        the same ``width``."""
        if self._acc is not None or self.windows_fed:
            raise ValueError("restore() requires a fresh engine")
        if state["width"] != self._width:
            raise ValueError(
                f"checkpoint width {state['width']} != engine width {self._width}")
        ncols = 2 * self._num_groups + 1
        if len(state["columns"]) != ncols:
            raise ValueError(
                f"checkpoint has {len(state['columns'])} row columns, "
                f"engine width {self._width} needs {ncols}")
        count = int(state["count"])
        cap = int(state["cap"])
        if count > cap:
            raise ValueError(
                f"checkpoint count {count} exceeds its capacity {cap}: "
                "truncated or corrupt stream checkpoint")
        for i, c in enumerate(state["columns"]):
            if len(c) != count:
                raise ValueError(
                    f"checkpoint column {i} holds {len(c)} rows, header "
                    f"says {count}: truncated or corrupt stream checkpoint")
        self._cap = cap
        staged: list = []
        cols = []
        for c in state["columns"]:
            host = np.full(cap, INT32_MAX, np.int32)
            host[:count] = c
            cols.append(engine.upload(host, self._device, staged))
        self._acc = tuple(cols)
        self._acc_count = torch.full((), count, dtype=torch.int32, device=self._device)
        self._unique_bound = count
        self._resolved_rows = count
        self._live_groups = int(state["live_groups"])
        self.max_word_len = int(state["max_word_len"])
        self.windows_fed = int(state["windows_fed"])
        # the pre-crash growth history, so a resumed run's curve covers
        # the whole stream
        self.rows_curve = [int(v) for v in state["rows_curve"]]
        self._pending = []
        self._window_checks = []

    def finalize(self) -> dict:
        """Device dict with the one-shot all-device program's output
        contract (``counts`` / ``df`` / ``postings`` / ``unique_groups``
        valid prefixes).  Checks every window's device statistics against
        the host classifier first — one read per window, all outside the
        stream loop."""
        if self._acc is None:
            raise ValueError("no windows fed")
        self._verify_window_checks()
        out = finalize_rows_body(self._acc, num_groups=self._num_groups,
                                 live_groups=self._live_groups)
        self._acc = self._acc_count = None
        self._pending = []
        return out
