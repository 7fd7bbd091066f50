"""Streaming device engine: blockwise reduction over a pair stream with
a bounded on-device accumulator.

The one-shot engine (ops/engine.py) needs the whole packed-key array on
the card at once.  Here the pairs arrive in document windows
(text/streaming.py feeds them) and the card carries only the **sorted
unique (term, doc) pairs seen so far** — bounded by the output's
unique-pair count, not the stream length.  Per window:

    acc <- unique(sort(concat(acc, window)))

as a few torch calls (cat -> torch.sort -> boundary dedup -> rank
compaction), all with sizes fixed by the host.  The accumulator
capacity grows by host-side doubling *before* a window that could
overflow it is merged (the host tracks ``unique <= fed pairs``), so
nothing in the feed loop waits for the card.

Two accumulator representations, switched automatically mid-stream:

- **packed**: one int32 key per pair (``term * stride + doc``) while
  the growing vocabulary still packs (``keys.can_pack``);
- **pairs**: separate (term, doc) int32 arrays, sorted as one int64
  key ``term << 31 | doc``, once the vocabulary outgrows the packed key
  space — the streaming counterpart of ``engine.index_pairs``.

At :meth:`StreamingIndexEngine.finalize` the provisional (append-stable)
term ids are remapped on the card to sorted-vocab rank with one gather,
re-sorted, and handed to the engine's shared tail
(``postings_from_sorted``, whose dedup is the ``unique_mask_count``
kernel, or ``index_pairs``) — output byte-identical to the one-shot
plan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.rounding import round_up
from . import engine
from . import keys as K
from .segment import compact, first_occurrence_mask


def _merge_unique(acc: torch.Tensor, window: torch.Tensor, cap: int):
    """Fold a packed-key window into the sorted-unique accumulator;
    returns it and the unique count (above ``cap``, rows were dropped)."""
    s = torch.sort(torch.cat([acc, window])).values
    first = first_occurrence_mask(s) & (s < K.INT32_MAX)
    return compact(s, first, cap, K.INT32_MAX), first.sum(dtype=torch.int32)


def _merge_unique_pairs(acc_t: torch.Tensor, acc_d: torch.Tensor, win_t: torch.Tensor,
                        win_d: torch.Tensor, cap: int):
    """Pair-mode merge of a (terms, docs) window; returns the (terms,
    docs) accumulator and the unique count.  Both fields are nonnegative
    int32, so ``term << 31 | doc`` sorts in (term, doc) order and is
    equal exactly where both fields are."""
    t = torch.cat([acc_t, win_t]).to(torch.int64)
    d = torch.cat([acc_d, win_d]).to(torch.int64)
    key = torch.sort((t << 31) | d).values
    t_s = (key >> 31).to(torch.int32)
    d_s = (key & K.INT32_MAX).to(torch.int32)
    first = first_occurrence_mask(key) & (t_s < K.INT32_MAX)
    return ((compact(t_s, first, cap, K.INT32_MAX), compact(d_s, first, cap, K.INT32_MAX)),
            first.sum(dtype=torch.int32))


def _regrow(acc: torch.Tensor, cap: int) -> torch.Tensor:
    """Copy a buffer into a larger one (INT32_MAX padded)."""
    out = torch.full((cap,), K.INT32_MAX, dtype=torch.int32, device=acc.device)
    out[: acc.shape[0]] = acc
    return out


def _unpack_acc(acc: torch.Tensor, stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed accumulator -> (term, doc) pair accumulator (mode switch)."""
    valid = acc < K.INT32_MAX
    return (torch.where(valid, acc // stride, K.INT32_MAX),
            torch.where(valid, acc % stride, K.INT32_MAX))


def _final_index(acc: torch.Tensor, remap: torch.Tensor, letter_of_term: torch.Tensor, *,
                 vocab_size: int, max_doc_id: int) -> dict:
    """Packed provisional keys -> sorted-rank keys -> shared tail."""
    stride = max_doc_id + 2
    valid = acc < K.INT32_MAX
    term = torch.where(valid, acc // stride, 0)
    doc = acc % stride
    final = torch.where(valid, remap[term.long()] * stride + doc, K.INT32_MAX)
    return engine.postings_from_sorted(
        torch.sort(final).values, letter_of_term,
        vocab_size=vocab_size, max_doc_id=max_doc_id)


def _final_pairs(acc_t: torch.Tensor, acc_d: torch.Tensor, remap: torch.Tensor,
                 letter_of_term: torch.Tensor, *, vocab_size: int, max_doc_id: int) -> dict:
    """Pair-mode finalize: remap terms, then the engine's pairs path."""
    valid = acc_t < K.INT32_MAX
    final_t = torch.where(valid, remap[torch.where(valid, acc_t, 0).long()], K.INT32_MAX)
    return engine.index_pairs(final_t, acc_d, letter_of_term,
                              vocab_size=vocab_size, max_doc_id=max_doc_id)


class StreamingIndexEngine:
    """Bounded-memory device reduction over a provisional-id pair stream.

    ``max_doc_id`` fixes the key stride for the whole stream; the vocab
    may keep growing while feeding (provisional ids).  Starts in packed
    mode and switches for good to pair mode the first time the
    vocabulary seen so far stops packing into int32 keys.

    Each window is staged in pinned memory (``engine.upload``) from a
    fresh host array, so no buffer the card may still be reading is ever
    refilled; the pinned block goes back to torch's caching host
    allocator, which reuses it only after the copy has completed.
    """

    def __init__(self, *, max_doc_id: int, device: torch.device | str = "cuda",
                 window_pad: int = 1 << 16, initial_capacity: int = 1 << 18):
        self._stride = max_doc_id + 2
        self._max_doc_id = max_doc_id
        self._device = torch.device(device)
        self._window_pad = window_pad
        self._cap = initial_capacity
        self._acc = None            # packed mode: int32 (cap,)
        self._acc_pair = None       # pair mode: (term, doc) int32 (cap,) each
        self._unique_bound = 0      # host upper bound on unique pairs in acc
        self.windows_fed = 0

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def mode(self) -> str:
        return "pairs" if self._acc_pair is not None else "packed"

    def _empty(self) -> torch.Tensor:
        return torch.full((self._cap,), K.INT32_MAX, dtype=torch.int32, device=self._device)

    def _ensure_capacity(self, extra: int) -> None:
        self._unique_bound += extra
        while self._unique_bound > self._cap:
            # grow BEFORE a merge that could overflow: no data loss and
            # no wait on the card
            self._cap *= 2
            if self._acc is not None:
                self._acc = _regrow(self._acc, self._cap)
            if self._acc_pair is not None:
                t, d = self._acc_pair
                self._acc_pair = (_regrow(t, self._cap), _regrow(d, self._cap))

    def _switch_to_pairs(self) -> None:
        if self._acc is None:
            self._acc_pair = (self._empty(), self._empty())
        else:
            self._acc_pair = _unpack_acc(self._acc, self._stride)
            self._acc = None

    def feed(self, prov_term_ids: np.ndarray, doc_ids: np.ndarray,
             vocab_size_so_far: int) -> None:
        """Merge one window of (provisional term, doc) pairs."""
        n = int(prov_term_ids.shape[0])
        if n == 0:
            return
        if self.mode == "packed" and not K.can_pack(vocab_size_so_far, self._max_doc_id):
            self._switch_to_pairs()
        if self.mode == "packed" and self._acc is None:
            self._acc = self._empty()

        padded = round_up(n, self._window_pad)
        self._ensure_capacity(n)
        staged: list = []
        if self.mode == "packed":
            host = np.full(padded, K.INT32_MAX, np.int32)
            np.multiply(prov_term_ids, self._stride, out=host[:n])
            host[:n] += doc_ids
            self._acc, _ = _merge_unique(
                self._acc, engine.upload(host, self._device, staged), self._cap)
        else:
            host = np.full(2 * padded, K.INT32_MAX, np.int32)
            host[:n] = prov_term_ids
            host[padded : padded + n] = doc_ids
            feed = engine.upload(host, self._device, staged)
            self._acc_pair, _ = _merge_unique_pairs(
                *self._acc_pair, feed[:padded], feed[padded:], self._cap)
        self.windows_fed += 1

    def finalize(self, remap: np.ndarray, letter_of_term: np.ndarray,
                 vocab_size: int) -> dict:
        """Device dict of postings/df/order/offsets/num_unique (the
        ``engine.postings_from_sorted`` interface) from the accumulated
        stream.  ``remap[prov_id] == sorted rank``."""
        staged: list = []  # pinned: the copies queue behind the merges, no wait
        remap_dev = engine.upload(remap.astype(np.int32), self._device, staged)
        letters_dev = engine.upload(letter_of_term.astype(np.int32), self._device, staged)
        if self._acc is not None:
            out = _final_index(self._acc, remap_dev, letters_dev,
                               vocab_size=vocab_size, max_doc_id=self._max_doc_id)
        elif self._acc_pair is not None:
            out = _final_pairs(*self._acc_pair, remap_dev, letters_dev,
                               vocab_size=vocab_size, max_doc_id=self._max_doc_id)
        else:
            raise ValueError("no windows fed")
        self._acc = self._acc_pair = None
        return out
