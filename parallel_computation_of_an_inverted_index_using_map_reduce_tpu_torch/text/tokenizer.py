"""Vectorized host tokenizer + sorted-vocab id assignment (numpy).

Reproduces the reference map phase's token semantics exactly
(main.c:102-117) as O(bytes) numpy table lookups:

- tokens are split on C-locale whitespace (``fscanf %s``, main.c:102):
  space, \\t, \\n, \\v, \\f, \\r
- inside a token every byte outside [A-Za-z] is *deleted* (not split on)
  and letters are lowercased (main.c:105-111); ``don't`` -> ``dont``,
  UTF-8 bytes are dropped (``café`` -> ``caf``)
- a cleaned token keeps at most 299 letters (MAX_WORD-1 guard at
  main.c:105)
- tokens that clean to nothing are skipped (main.c:113)

Term ids are assigned in **sorted vocab order**, so integer order on
the device == strcmp order on the host, and the final (df desc, word
asc) output ordering (main.c:55-64) needs no strings on the card.
Every (term, doc) occurrence is kept: the device engine folds the
duplicates (the reference reducer's dedup, main.c:172-187).
:func:`tokenize` dispatches to the native scan (native/), which can
apply that dedup in the map phase instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import MAX_WORD_LETTERS

# Byte classes.
_DROP, _LETTER, _SPACE = 0, 1, 2

_CLASS = np.full(256, _DROP, dtype=np.uint8)
_LOWER = np.zeros(256, dtype=np.uint8)
for _b in range(ord("a"), ord("z") + 1):
    _CLASS[_b] = _LETTER
    _LOWER[_b] = _b
for _b in range(ord("A"), ord("Z") + 1):
    _CLASS[_b] = _LETTER
    _LOWER[_b] = _b + 32
for _b in b" \t\n\v\f\r":
    _CLASS[_b] = _SPACE


@dataclasses.dataclass(frozen=True)
class TokenizedCorpus:
    """Integer view of a corpus, ready for the device engine.

    vocab is lexicographically sorted, so ``term_ids`` compare like the
    underlying strings.  ``doc_ids`` are the 1-based manifest positions
    (main.c:116 emits ``id + 1``).
    """

    term_ids: np.ndarray      # int32 (num_tokens,), values in [0, vocab_size)
    doc_ids: np.ndarray       # int32 (num_tokens,)
    vocab: np.ndarray         # (vocab_size,) numpy bytes (S) array, sorted
    letter_of_term: np.ndarray  # int32 (vocab_size,), first letter - 'a'
    # combiner applied: each (term, doc) pair appears exactly once (the
    # reducer dedup of main.c:176-184 pulled into the map phase)
    pairs_deduped: bool = False
    raw_tokens: int | None = None  # tokens scanned before the combiner

    @property
    def num_tokens(self) -> int:
        return int(self.term_ids.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.vocab.shape[0])


def corpus_from_numpy(term_ids, doc_ids, vocab, letter_of_term) -> TokenizedCorpus:
    """A :class:`TokenizedCorpus` from plain arrays — e.g. the fields of
    another tokenizer's output — so one tokenization can feed several
    engines."""
    return TokenizedCorpus(
        term_ids=np.ascontiguousarray(term_ids, dtype=np.int32),
        doc_ids=np.ascontiguousarray(doc_ids, dtype=np.int32),
        vocab=np.asarray(vocab),
        letter_of_term=np.ascontiguousarray(letter_of_term, dtype=np.int32),
    )


def clean_token(raw: str | bytes) -> str:
    """Reference-exact cleaning of one whitespace-free token (main.c:105-111)."""
    if isinstance(raw, str):
        raw = raw.encode("utf-8", "surrogateescape")
    out = bytearray()
    for b in raw:
        if len(out) >= MAX_WORD_LETTERS:
            break
        if ord("A") <= b <= ord("Z"):
            out.append(b + 32)
        elif ord("a") <= b <= ord("z"):
            out.append(b)
    return out.decode("ascii")


def _extract_letters(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-byte pass: returns (lowercased letters, token id of each letter).

    Token ids count whitespace-delimited tokens over the whole buffer;
    letters of a token share an id.  Dropped bytes vanish without
    splitting their token.
    """
    cls = _CLASS[data]
    token_id = np.cumsum(cls == _SPACE)
    keep = cls == _LETTER
    return _LOWER[data[keep]], token_id[keep]


# Words longer than this go through the rare-word path so one junk token
# can't inflate the dense pack matrix to (num_tokens, 299) bytes.
_PACK_WIDTH_CAP = 32


def _pack_dense(letters: np.ndarray, word_of_letter: np.ndarray, num_words: int,
                starts: np.ndarray, width: int) -> np.ndarray:
    """Scatter each word's first ``width`` letters into a (num_words, width)
    matrix and reinterpret rows as NUL-padded byte strings — lexicographic
    compare == strcmp for letter-only strings."""
    mat = np.zeros((num_words, width), dtype=np.uint8)
    cols = np.arange(letters.shape[0], dtype=np.int64) - starts[word_of_letter]
    in_width = cols < width
    mat[word_of_letter[in_width], cols[in_width]] = letters[in_width]
    return np.ascontiguousarray(mat).view(f"S{width}").ravel()


def _vocab_and_ids(letters: np.ndarray, word_of_letter: np.ndarray,
                   starts: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted vocab + per-token term ids.

    Common case: every word fits ``_PACK_WIDTH_CAP`` and one dense pack +
    ``np.unique`` does it.  Rare long words (up to the 299-letter cap)
    are materialized individually and merged at vocab scale.
    """
    num_words = starts.shape[0]
    max_len = max(int(lengths.max()), 1)
    if max_len <= _PACK_WIDTH_CAP:
        packed = _pack_dense(letters, word_of_letter, num_words, starts, max_len)
        vocab, inverse = np.unique(packed, return_inverse=True)
        return vocab, inverse.astype(np.int32)

    prefix = _pack_dense(letters, word_of_letter, num_words, starts, _PACK_WIDTH_CAP)
    is_long = lengths > _PACK_WIDTH_CAP
    short_idx = np.flatnonzero(~is_long)
    long_idx = np.flatnonzero(is_long)
    letter_bytes = letters.tobytes()
    long_full = np.array(
        [letter_bytes[int(starts[w]) : int(starts[w]) + int(lengths[w])]
         for w in long_idx.tolist()],
        dtype=f"S{max_len}",
    )
    uniq_short, inv_short = np.unique(prefix[short_idx], return_inverse=True)
    vocab = np.unique(np.concatenate([uniq_short.astype(f"S{max_len}"), np.unique(long_full)]))
    term_ids = np.empty(num_words, dtype=np.int32)
    term_ids[short_idx] = np.searchsorted(vocab, uniq_short.astype(f"S{max_len}"))[inv_short]
    term_ids[long_idx] = np.searchsorted(vocab, long_full)
    return vocab, term_ids


def _doc_token_id_bounds(buf: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Largest token id a letter inside each document can carry.

    A letter at byte p has token id = number of whitespace bytes strictly
    before p.  Document i ends with its separator byte at ``ends[i]-1``
    (itself whitespace), so the bounds are strictly increasing and
    ``searchsorted(bounds, id, side='left')`` is an exact doc lookup.
    """
    space_cum = np.cumsum(_CLASS[buf] == _SPACE)
    return space_cum[ends - 1] - 1


def tokenize_documents(contents: list[bytes], doc_ids: list[int]) -> TokenizedCorpus:
    """Tokenize documents into sorted-vocab (term_id, doc_id) pairs.

    ``doc_ids[i]`` is the 1-based id of ``contents[i]`` (ids of skipped
    unreadable files simply never appear, main.c:97-100).
    """
    if len(contents) != len(doc_ids):
        raise ValueError("contents and doc_ids length mismatch")
    if contents:
        # one buffer with a separator byte between docs (no token can
        # span files); per-byte doc lookup via offsets
        buf = np.frombuffer(b"\n".join(contents) + b"\n", dtype=np.uint8)
        ends = np.cumsum(np.array([len(c) + 1 for c in contents], dtype=np.int64))
        letters, ltid = _extract_letters(buf)
    else:
        letters = np.empty(0, dtype=np.uint8)
        ltid = np.empty(0, dtype=np.int64)

    if letters.size == 0:
        return TokenizedCorpus(
            term_ids=np.empty(0, np.int32),
            doc_ids=np.empty(0, np.int32),
            vocab=np.empty(0, "S1"),
            letter_of_term=np.empty(0, np.int32),
        )

    # word boundaries: consecutive letters with the same token id
    new_word = np.empty(letters.shape[0], dtype=bool)
    new_word[0] = True
    np.not_equal(ltid[1:], ltid[:-1], out=new_word[1:])
    word_of_letter = np.cumsum(new_word) - 1
    starts = np.flatnonzero(new_word).astype(np.int64)
    lengths = np.diff(np.append(starts, letters.shape[0]))

    # reference cap: at most 299 letters per cleaned token (main.c:105);
    # dropping tail letters never drops a word's first letter
    if int(lengths.max()) > MAX_WORD_LETTERS:
        pos_in_word = np.arange(letters.shape[0], dtype=np.int64) - starts[word_of_letter]
        keep = pos_in_word < MAX_WORD_LETTERS
        letters, word_of_letter, ltid = letters[keep], word_of_letter[keep], ltid[keep]
        starts = np.flatnonzero(np.r_[True, word_of_letter[1:] != word_of_letter[:-1]])
        lengths = np.minimum(lengths, MAX_WORD_LETTERS)

    doc_tid_bounds = _doc_token_id_bounds(buf, ends)
    word_doc_idx = np.searchsorted(doc_tid_bounds, ltid[starts], side="left")
    word_docs = np.asarray(doc_ids, dtype=np.int32)[word_doc_idx]

    vocab, term_ids = _vocab_and_ids(letters, word_of_letter, starts, lengths)
    width = vocab.dtype.itemsize
    first_bytes = vocab.view(np.uint8).reshape(vocab.shape[0], width)[:, 0]
    letter_of_term = first_bytes.astype(np.int32) - ord("a")

    return TokenizedCorpus(
        term_ids=term_ids,
        doc_ids=word_docs.astype(np.int32),
        vocab=vocab,
        letter_of_term=letter_of_term,
    )


def tokenize(contents: list[bytes], doc_ids: list[int],
             use_native: bool = True, dedup_pairs: bool = False,
             num_threads: int = 1) -> TokenizedCorpus:
    """Dispatch to the native scan when it builds, else the numpy path.

    Both implement the identical contract.  ``dedup_pairs`` applies the
    map-side combiner (native path only; the numpy path leaves
    duplicates for the device engine to fold, which is output-invariant).
    ``num_threads`` parallelizes the native scan over contiguous doc
    ranges (the reference's mapper threads, main.c:348-365); output is
    identical for every thread count.
    """
    if use_native:
        from .. import native

        if native.available():
            return native.tokenize_native(
                contents, doc_ids, dedup_pairs=dedup_pairs, num_threads=num_threads)
    return tokenize_documents(contents, doc_ids)
