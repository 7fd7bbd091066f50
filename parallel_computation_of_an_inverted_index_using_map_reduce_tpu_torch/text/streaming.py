"""Streaming tokenizer frontend: fixed-size document windows, one
incremental vocabulary.

The one-shot frontend (text/tokenizer.py) holds the whole corpus in
host memory.  Here the corpus is processed per document window: the
window advances over the token stream while a carried state (the
vocabulary here; the device pair accumulator in ops/streaming.py)
stays bounded by the *unique* content, not the stream length.

Term ids while streaming are **provisional**: new words get the next
free id in their window's sorted order, and ids never change once
assigned (append-only).  One remap to sorted-vocab rank at finalize
restores the order semantics of the reference's strcmp ordering
(main.c:55-64, via text/tokenizer.py's sorted-vocab invariant).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .tokenizer import tokenize


@dataclasses.dataclass(frozen=True)
class StreamChunk:
    """One window of emitted pairs, in provisional (append-stable) ids."""

    prov_term_ids: np.ndarray  # int32, ids into the growing vocab
    doc_ids: np.ndarray        # int32, 1-based manifest positions
    raw_tokens: int


class StreamingTokenizer:
    """Incremental vocabulary over per-window tokenizer runs.

    Each ``feed`` tokenizes one document window with the (native or
    numpy) frontend, then folds the window's sorted vocab into the
    global first-occurrence vocab — vocab-scale work only; the
    token-scale arrays are remapped with one gather.
    """

    def __init__(self, use_native: bool = True, num_threads: int = 1):
        self._use_native = use_native
        self._num_threads = num_threads
        self._vocab_ids: dict[bytes, int] = {}
        self._finalized = False

    @property
    def vocab_size(self) -> int:
        return len(self._vocab_ids)

    def feed(self, contents: list[bytes], doc_ids: list[int]) -> StreamChunk:
        """Tokenize one whole-document window into provisional-id pairs.

        Documents must not span windows: the map-side combiner dedups
        within a window, so whole-document windows keep feeds
        combiner-clean."""
        if self._finalized:
            raise RuntimeError("finalize() already called")
        chunk = tokenize(contents, doc_ids, use_native=self._use_native,
                         dedup_pairs=True, num_threads=self._num_threads)
        vocab_ids = self._vocab_ids
        local2prov = np.empty(chunk.vocab_size, dtype=np.int32)
        next_id = len(vocab_ids)
        for local_id, word in enumerate(chunk.vocab.tolist()):
            prov = vocab_ids.setdefault(word, next_id)
            if prov == next_id:
                next_id += 1
            local2prov[local_id] = prov
        prov_terms = (
            local2prov[chunk.term_ids] if chunk.num_tokens else
            np.empty(0, np.int32))
        raw = chunk.raw_tokens if chunk.raw_tokens is not None else chunk.num_tokens
        return StreamChunk(prov_term_ids=prov_terms, doc_ids=chunk.doc_ids,
                           raw_tokens=int(raw))

    def finalize(self):
        """``(sorted vocab 'S' array, prov->rank remap, letter_of_term)``."""
        self._finalized = True
        words = list(self._vocab_ids)
        vocab_sorted = np.sort(np.array(words, dtype=bytes)) if words else np.empty(0, "S1")
        rank_of_word = {w: r for r, w in enumerate(vocab_sorted.tolist())}
        remap = np.empty(len(words), dtype=np.int32)
        for word, prov in self._vocab_ids.items():
            remap[prov] = rank_of_word[word]
        width = vocab_sorted.dtype.itemsize
        if len(words):
            first = vocab_sorted.view(np.uint8).reshape(len(words), width)[:, 0]
            letters = first.astype(np.int32) - ord("a")
        else:
            letters = np.empty(0, np.int32)
        return vocab_sorted, remap, letters
