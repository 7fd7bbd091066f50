"""Seeded inputs: a configuration's corpus.

Everything is vectorised numpy and depends only on ``--seed`` and the
parameters in the configuration file.  Sizes that should not change the
amount of work from seed to seed (the words and the length of the word
at each Zipf rank) are one fixed set, drawn once from a seed of their
own; the run's seed deals the words among the ranks and draws the
tokens.
"""

from __future__ import annotations

import numpy as np

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
#: seed of the fixed sets of sizes that every run's seed only reorders
SIZES_SEED = 20_261_017


class Corpus:
    """Documents as one byte buffer: document ``i`` (doc id ``i + 1``) is
    ``buf[starts[i]:stops[i]]``; ``tokens`` holds each document's word
    ranks in order (``doc_tokens`` of them per document), and
    :meth:`word` gives the word of a rank."""

    def __init__(self, buf, starts, stops, tokens, doc_tokens, word_rows, word_lens):
        self.buf = buf
        self.starts = starts
        self.stops = stops
        self.tokens = tokens
        self.doc_tokens = doc_tokens
        self.word_rows = word_rows
        self.word_lens = word_lens

    def __len__(self) -> int:
        return len(self.starts)

    @property
    def total_bytes(self) -> int:
        return int((self.stops - self.starts).sum())

    def doc(self, i: int) -> bytes:
        return self.buf[self.starts[i]:self.stops[i]].tobytes()

    def word(self, rank: int) -> str:
        return self.word_rows[rank, :self.word_lens[rank]].tobytes().decode("ascii")


def make_vocab(size: int, min_len: int, max_len: int, rng):
    """``size`` distinct lowercase words: ``(rows (size, max_len) uint8
    zero-padded, lengths int64)``.  The words and the length of the word
    at each rank are one fixed set (lengths uniform in ``[min_len,
    max_len]`` before duplicates are dropped); ``rng`` only deals the
    words of one length among the ranks of that length, so every seed's
    corpus has the same number of bytes to the token."""
    r0 = np.random.default_rng(SIZES_SEED)
    powers = 27 ** np.arange(max_len - 1, -1, -1, dtype=np.int64)
    n = size + size // 4 + 1024
    while True:
        lens = r0.integers(min_len, max_len + 1, n)
        rows = LETTERS[r0.integers(0, 26, (n, max_len))]
        rows[np.arange(max_len)[None, :] >= lens[:, None]] = 0
        keys = (np.maximum(rows.astype(np.int64) - 96, 0) * powers).sum(axis=1)
        _, first = np.unique(keys, return_index=True)
        if len(first) >= size:
            keep = np.sort(first)[:size]
            rows, lens = rows[keep], lens[keep].astype(np.int64)
            break
        n *= 2
    order = np.arange(size)
    for length in range(min_len, max_len + 1):
        at = np.nonzero(lens == length)[0]
        order[at] = at[rng.permutation(len(at))]
    return rows[order], lens


class ZipfTable:
    """Inverse CDF of a Zipf law over ``size`` ranks, with a guide table
    of ``2**22`` equal slices of ``[0, 1)``: a draw starts at the first
    rank of its slice and steps up, which is what a binary search over
    the whole CDF gives, at a fraction of its cost."""

    SLICES = 1 << 22

    def __init__(self, size: int, alpha: float):
        p = np.arange(1, size + 1, dtype=np.float64) ** (-alpha)
        self.cdf = np.cumsum(p / p.sum())
        self.cdf[-1] = np.inf
        edges = np.arange(self.SLICES, dtype=np.float64) / self.SLICES
        self.guide = np.searchsorted(self.cdf, edges, side="right").astype(np.int32)

    def __len__(self) -> int:
        return len(self.cdf)

    def ranks(self, u: np.ndarray) -> np.ndarray:
        """0-based ranks of uniform draws ``u``: the first rank whose
        cumulative share exceeds the draw."""
        idx = self.guide[(u * self.SLICES).astype(np.int64)]
        todo = np.nonzero(self.cdf[idx] <= u)[0]
        while len(todo):
            idx[todo] += 1
            todo = todo[self.cdf[idx[todo]] <= u[todo]]
        return idx


def assemble(word_rows, word_lens, tokens, doc_tokens) -> Corpus:
    """Space-joined documents from word ranks, in one buffer (each word
    and its space gathered as a zero-padded row, the zeros then
    dropped)."""
    width = word_rows.shape[1] + 1
    spaced = np.zeros((len(word_rows), width), dtype=np.uint8)
    spaced[:, :-1] = word_rows
    spaced[np.arange(len(word_rows)), word_lens] = ord(" ")
    parts = [np.empty(0, dtype=np.uint8)]
    step = 1 << 23
    for lo in range(0, len(tokens), step):
        rows = spaced[tokens[lo:lo + step]]
        parts.append(rows[rows != 0])
    buf = np.concatenate(parts)
    end = np.cumsum(word_lens[tokens] + 1)
    last = np.cumsum(doc_tokens) - 1
    first = last - doc_tokens + 1
    return Corpus(buf, end[first] - word_lens[tokens[first]] - 1, end[last] - 1, tokens,
                  doc_tokens, word_rows, word_lens)


def corpus(params: dict, seed: int) -> Corpus:
    """The corpus a configuration file's ``generator`` block describes."""
    g = params["generator"]
    rng = np.random.default_rng([seed, 1])
    rows, lens = make_vocab(g["vocab"], g["min_word"], g["max_word"], rng)
    doc_tokens = np.full(params[g["documents_key"]], g["tokens_per_doc"], dtype=np.int64)
    zipf = ZipfTable(g["vocab"], g["alpha"])
    tokens = np.empty(int(doc_tokens.sum()), dtype=np.int32)
    step = 1 << 24
    for lo in range(0, len(tokens), step):
        hi = min(lo + step, len(tokens))
        tokens[lo:hi] = zipf.ranks(rng.random(hi - lo))
    return assemble(rows, lens, tokens, doc_tokens)


def write_files(c: Corpus, directory) -> list[str]:
    """Every document as its own file; returns the paths in doc id order."""
    from pathlib import Path

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    width = len(str(len(c)))
    paths = []
    view = memoryview(c.buf)
    for i, (a, b) in enumerate(zip(c.starts.tolist(), c.stops.tolist())):
        p = str(directory / f"doc_{i:0{width}d}.txt")
        with open(p, "wb") as f:
            f.write(view[a:b])
        paths.append(p)
    return paths

