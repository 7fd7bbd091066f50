"""Numpy assembly for the out-of-core build's reduce side.

Three pure stages over :mod:`.spill` containers, all vectorized (no
per-term Python loops):

* :func:`merge_shard` — k-way merge of every run's slice of one
  term-hash shard into lex-sorted terms with doc-ascending postings
  (peak memory O(corpus / shards)).
* :func:`letter_slice` / :func:`emit_order` — pull one letter's terms
  out of every merged shard file and produce the (df desc, word asc)
  emit permutation the letter writers need.
* :func:`lex_concat` + :func:`doc_lengths` — whole-index assembly for
  the artifact packer.

All term comparisons use numpy ``S``-dtype rows NUL-padded to a common
width, which orders identically to the native radix lex sort (both are
bytewise with NUL below every letter).
"""

from __future__ import annotations

import numpy as np

ALPHABET_SIZE = 26


def as_terms(u8rows: np.ndarray, width: int) -> np.ndarray:
    """View a ``(t, w)`` uint8 matrix as ``S{width}`` rows, NUL-padding
    on the right when ``w < width``."""
    width = max(int(width), 1)
    t, w = u8rows.shape
    if w < width:
        padded = np.zeros((t, width), dtype=np.uint8)
        padded[:, :w] = u8rows
        u8rows = padded
    elif w > width:
        raise ValueError(f"term rows wider ({w}) than target ({width})")
    return np.ascontiguousarray(u8rows).reshape(-1).view(f"S{width}")


def terms_to_u8(terms: np.ndarray) -> np.ndarray:
    """Inverse of :func:`as_terms`: ``(t, width)`` uint8 rows."""
    width = terms.dtype.itemsize
    return terms.view(np.uint8).reshape(terms.shape[0], width)


def gather_pairs(order: np.ndarray, src_off: np.ndarray):
    """Pair-gather index for a term permutation.

    Given per-term pair offsets ``src_off`` (``T + 1`` entries) and a
    term permutation ``order``, returns ``(idx, new_off)`` where
    ``pairs[idx]`` lists the pairs in permuted-term order and
    ``new_off`` is the permuted cumulative offset table.
    """
    counts = (src_off[1:] - src_off[:-1])[order]
    new_off = np.zeros(order.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=new_off[1:])
    total = int(new_off[-1])
    if total == 0:
        return np.empty(0, dtype=np.int64), new_off
    idx = (np.arange(total, dtype=np.int64)
           - np.repeat(new_off[:-1], counts)
           + np.repeat(src_off[:-1][order], counts))
    return idx, new_off


def run_shard_slice(reader, shard: int, width: int) -> dict | None:
    """One run's slice of one term-hash shard (terms already lex-sorted
    by the native run pack); ``None`` when the run has no terms there."""
    term_off = reader.meta["shard_term_off"]
    pair_off = reader.meta["shard_pair_off"]
    t0, t1 = int(term_off[shard]), int(term_off[shard + 1])
    if t1 == t0:
        return None
    p0, p1 = int(pair_off[shard]), int(pair_off[shard + 1])
    return {
        "terms": as_terms(reader.read_rows("vocab", t0, t1), width),
        "df": reader.read_rows("df", t0, t1).astype(np.int64, copy=False),
        "postings": reader.read_rows("postings", p0, p1),
        "tf": reader.read_rows("tf", p0, p1),
    }


def merge_shard(readers, shard: int, width: int) -> dict:
    """Merge every run's slice of ``shard`` into one sorted shard.

    Output terms are lex-ascending; each term's postings run is
    doc-ascending with its tf column.  Raises ``ValueError`` on a
    duplicate (term, doc) pair — runs cover disjoint document sets, so
    a collision means a window was double-counted or a run is corrupt.
    """
    width = max(int(width), 1)
    parts = [p for p in (run_shard_slice(r, shard, width) for r in readers)
             if p is not None]
    if not parts:
        return _empty_shard(width)
    terms_cat = np.concatenate([p["terms"] for p in parts])
    df_cat = np.concatenate([p["df"] for p in parts])
    uniq, inv = np.unique(terms_cat, return_inverse=True)
    pair_term = np.repeat(inv, df_cat)
    pair_doc = np.concatenate([p["postings"] for p in parts])
    pair_tf = np.concatenate([p["tf"] for p in parts])
    order = np.lexsort((pair_doc, pair_term))
    pair_term = pair_term[order]
    pair_doc = pair_doc[order]
    pair_tf = pair_tf[order]
    if pair_term.shape[0] > 1:
        dup = (pair_term[1:] == pair_term[:-1]) \
            & (pair_doc[1:] == pair_doc[:-1])
        if dup.any():
            at = int(np.flatnonzero(dup)[0])
            raise ValueError(
                f"duplicate (term, doc) pair in shard {shard}: "
                f"term {bytes(uniq[pair_term[at]])!r} doc "
                f"{int(pair_doc[at])}")
    df = np.bincount(pair_term, minlength=uniq.shape[0]).astype(np.int64)
    offsets = np.zeros(uniq.shape[0] + 1, dtype=np.int64)
    np.cumsum(df, out=offsets[1:])
    u8 = terms_to_u8(uniq)
    return {
        "vocab": u8,
        "word_lens": np.count_nonzero(u8, axis=1).astype(np.int32),
        "df": df,
        "offsets": offsets,
        "postings": pair_doc.astype(np.int32, copy=False),
        "tf": pair_tf.astype(np.int32, copy=False),
        "letter_off": letter_offsets(u8),
        "width": width,
    }


def _empty_shard(width: int) -> dict:
    return {
        "vocab": np.zeros((0, width), dtype=np.uint8),
        "word_lens": np.zeros(0, dtype=np.int32),
        "df": np.zeros(0, dtype=np.int64),
        "offsets": np.zeros(1, dtype=np.int64),
        "postings": np.zeros(0, dtype=np.int32),
        "tf": np.zeros(0, dtype=np.int32),
        "letter_off": np.zeros(ALPHABET_SIZE + 1, dtype=np.int64),
        "width": width,
    }


def letter_offsets(u8rows: np.ndarray) -> np.ndarray:
    """27-entry first-letter offset table over lex-sorted term rows."""
    firsts = u8rows[:, 0] if u8rows.shape[0] else \
        np.zeros(0, dtype=np.uint8)
    off = np.zeros(ALPHABET_SIZE + 1, dtype=np.int64)
    for letter in range(ALPHABET_SIZE):
        off[letter] = np.searchsorted(firsts, ord("a") + letter)
    off[ALPHABET_SIZE] = u8rows.shape[0]
    return off


def letter_slice(shard_file, letter: int, width: int) -> dict | None:
    """One merged shard file's slice of one letter; ``None`` if empty."""
    letter_off = shard_file.section("letter_off")
    t0, t1 = int(letter_off[letter]), int(letter_off[letter + 1])
    if t1 == t0:
        return None
    offs = shard_file.read_rows("offsets", t0, t1 + 1)
    p0, p1 = int(offs[0]), int(offs[-1])
    return {
        "terms": as_terms(shard_file.read_rows("vocab", t0, t1), width),
        "df": shard_file.read_rows("df", t0, t1),
        "offsets": (offs - p0).astype(np.int64, copy=False),
        "postings": shard_file.read_rows("postings", p0, p1),
    }


def concat_letter(parts: list) -> dict:
    """Concatenate per-shard letter slices into lex-sorted letter arrays.

    Shards partition terms by hash, so across shards the slices are
    disjoint; one argsort restores the global lex order.
    """
    terms_cat = np.concatenate([p["terms"] for p in parts])
    df_cat = np.concatenate([p["df"] for p in parts])
    src_off = np.zeros(terms_cat.shape[0] + 1, dtype=np.int64)
    np.cumsum(df_cat, out=src_off[1:])
    postings_cat = np.concatenate([p["postings"] for p in parts])
    lex = np.argsort(terms_cat, kind="stable")
    idx, offsets = gather_pairs(lex, src_off)
    return {
        "terms": terms_cat[lex],
        "df": df_cat[lex],
        "offsets": offsets,
        "postings": postings_cat[idx],
    }


def emit_order(df: np.ndarray) -> np.ndarray:
    """Emit permutation for one letter's lex-sorted terms: df
    descending, ties word-ascending (the reference's line order)."""
    return np.argsort(-df, kind="stable").astype(np.int64)


def doc_lengths(readers, max_doc_id: int) -> np.ndarray:
    """Per-document cleaned token counts from every run's doc section
    (float64, ``max_doc_id + 1`` entries — the artifact's dtype)."""
    lens = np.zeros(int(max_doc_id) + 1, dtype=np.float64)
    for reader in readers:
        ids = reader.section("doc_ids")
        toks = reader.section("doc_tokens")
        if ids.shape[0]:
            np.add.at(lens, ids, toks.astype(np.float64))
    return lens
