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

    per window:  rows  <- tokenize ► sort ► dedup
                 acc   <- merge(acc, rows)

as torch calls and two hand-written kernels (``kernels.tokenize_window``,
which tokenizes the window in one read of its bytes, and
``kernels.merge_sorted_rows``: both operands are sorted and unique, so
the merge needs no sort), with
sizes fixed by the host and no wait on the card in the stream loop: the
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
from .device_tokenizer import INT32_MAX, groups_sort_perm, live_groups_for, num_groups_for
from .segment import _rank_slots, first_occurrence_mask, set_bit_positions


def _row_first_mask(rows) -> torch.Tensor:
    """First-occurrence mask over sorted (group halves…, doc) rows;
    ``rows[0]`` (group 0's hi) is INT32_MAX on padding rows, which never
    count."""
    neq = first_occurrence_mask(rows[0])
    for r in rows[1:]:
        neq = neq | first_occurrence_mask(r)
    return neq & (rows[0] != INT32_MAX)


def _compact_rows(rows: list, mask: torch.Tensor, out_cap: int) -> tuple:
    """Stable compaction of every column of a row list into ``out_cap``
    slots: the rank slots are computed once per mask and each column is
    scattered with them; dropped slots become padding rows (INT32_MAX in
    every column, so later sorts push them last).  The list's entries
    are released one by one as they are consumed."""
    slots = _rank_slots(mask, out_cap)
    out = []
    for i in range(len(rows)):
        col = torch.full((out_cap + 1,), INT32_MAX, dtype=torch.int32, device=mask.device)
        col.scatter_(0, slots, rows[i])
        out.append(col[:out_cap])
        rows[i] = None
    return tuple(out)


def window_rows(data, doc_ends, doc_id_values, *, width: int, tok_cap: int, num_docs: int,
                sort_cols: int, num_groups: int, out_cap: int):
    """One byte window -> its deduped (group rows…, doc) rows.

    Returns ``(rows, counts)``: ``rows`` is ``2 * num_groups + 1`` int32
    tensors of length ``out_cap`` (the unique rows first, in sorted
    order, INT32_MAX padding after); ``counts = [num_pairs,
    max_word_len, num_tokens]`` for the caller's divergence checks (read
    later, never inside the stream loop).
    """
    groups, doc_col, max_word_len, num_tokens = kernels.tokenize_window(
        data, doc_ends, doc_id_values, width=width, tok_cap=tok_cap,
        num_docs=num_docs, sort_cols=sort_cols)
    live = live_groups_for(sort_cols, width)
    perm = groups_sort_perm(groups[:live], doc_col)
    zero = torch.zeros(tok_cap, dtype=torch.int32, device=data.device)
    s_rows = ([g[perm] for pair in groups[:live] for g in pair]
              + [zero] * (2 * (num_groups - live)) + [doc_col[perm]])
    del groups, doc_col, perm
    first = _row_first_mask(s_rows)
    count = first.sum(dtype=torch.int32)
    rows = _compact_rows(s_rows, first, out_cap)
    return rows, torch.stack([count, max_word_len.to(torch.int32), num_tokens])


def _merge_unique_rows(acc, window, *, cap: int, live_groups: int):
    """Fold a window's row tuple into the sorted-unique accumulator;
    also returns the accumulator's exact unique-row count (padding rows
    never count).  It takes the window's rows in any order (the mesh
    engine's exchanged rows); the single-card engine, whose windows come
    sorted and unique, merges with ``kernels.merge_sorted_rows``, whose
    plain version this is.  Only the ``live_groups`` group pairs (the ones the
    stream has produced a nonzero char for so far) are sort passes; the
    later groups are zero in both operands except on padding rows, where
    every column is INT32_MAX, so a pass over them is the identity.  The
    dedup still compares every column.  The concatenation is released
    column by column as its sorted copy is made, so the merge holds about
    the old accumulator, the concatenation and one column more."""
    cat = [torch.cat([a, w]) for a, w in zip(acc, window)]
    doc = cat[-1]
    perm = groups_sort_perm([(cat[2 * g], cat[2 * g + 1]) for g in range(live_groups)], doc)
    del doc
    s_rows = []
    for i in range(len(cat)):
        s_rows.append(cat[i][perm])
        cat[i] = None
    del perm
    first = _row_first_mask(s_rows)
    count = first.sum(dtype=torch.int32)
    return _compact_rows(s_rows, first, cap), count


def _regrow_rows(acc, *, cap: int) -> tuple:
    """Copy row columns into larger INT32_MAX-padded buffers."""
    out = []
    for a in acc:
        col = torch.full((cap,), INT32_MAX, dtype=torch.int32, device=a.device)
        col[: a.shape[0]] = a
        out.append(col)
    return tuple(out)


def _head_rows(acc, *, pad: int) -> tuple:
    """The first ``pad`` rows of every accumulator column: a snapshot
    fetches only these instead of the whole capacity, which can sit at
    ~2x the live count right after a doubling."""
    return tuple(a[:pad] for a in acc)


def finalize_rows_body(acc, *, num_groups: int) -> dict:
    """The one-shot all-device program's output contract from the
    accumulator.

    Every valid row is one unique (word, doc) pair and the rows are
    already in emit-ready lexicographic order, so: postings are the doc
    column's valid prefix verbatim; df falls out of the word-run edges;
    the unique word rows come back as the 5-bit group pairs gathered at
    each run's first row, which the host decodes at vocab scale
    (``device_tokenizer.decode_word_groups``).  Returns ``counts =
    [num_words, num_pairs, num_long]``, ``df``, ``postings`` and
    ``unique_groups``, each ``cap`` long with a valid prefix.
    """
    cap = acc[0].shape[0]
    dev = acc[0].device
    doc = acc[-1]
    valid = acc[0] != INT32_MAX
    neq = first_occurrence_mask(acc[0])
    for r in acc[1:-1]:
        neq = neq | first_occurrence_mask(r)
    first_word = neq & valid
    num_words = first_word.sum(dtype=torch.int32)
    num_pairs = valid.sum(dtype=torch.int32)

    slots = torch.arange(cap, device=dev)
    # word-start positions by the shared set-bit compaction; W[cap] ==
    # cap keeps the df difference below in range
    W = torch.cat([torch.clamp(set_bit_positions(first_word, cap), max=cap),
                   torch.full((1,), cap, dtype=torch.int32, device=dev)])
    word_live = slots < num_words
    Wg = torch.clamp(W[:-1], 0, cap - 1).to(torch.int64)
    df = torch.where(word_live, torch.minimum(W[1:], num_pairs) - W[:-1], 0)
    postings = torch.where(slots < num_pairs, doc, 0)
    groups = [(torch.where(word_live, acc[2 * g][Wg], 0),
               torch.where(word_live, acc[2 * g + 1][Wg], 0))
              for g in range(num_groups)]
    # >12-char word count, so the sparse tail-group fetch can size its
    # transfer (device_tokenizer.fetch_pack)
    num_long = ((word_live & (groups[1][0] != 0)).sum(dtype=torch.int32) if num_groups > 1
                else torch.zeros((), dtype=torch.int32, device=dev))
    return {
        "counts": torch.stack([num_words, num_pairs, num_long]),
        "df": df,
        "postings": postings,
        "unique_groups": tuple(groups),
    }


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
            if dev_tokens + 1 > tok_cap:
                raise AssertionError(
                    f"device token count {dev_tokens} exceeded tok_cap "
                    f"{tok_cap}: host mask count diverged from the "
                    "device classifier (bug)")
            if dev_max_len != host_max_len:
                raise AssertionError(
                    f"device max word len {dev_max_len} != host "
                    f"{host_max_len}: classifier divergence (bug)")
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
        out = finalize_rows_body(self._acc, num_groups=self._num_groups)
        self._acc = self._acc_count = None
        self._pending = []
        return out
