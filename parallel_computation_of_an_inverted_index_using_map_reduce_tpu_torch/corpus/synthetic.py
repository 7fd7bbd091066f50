"""Deterministic synthetic corpora (Zipfian), for tests and the chip
smoke run when no real corpus is at hand.

Same generator, seed for seed and byte for byte, as the JAX package's
``corpus/synthetic.py``; BASELINE.json config 4 ("Synthetic Zipfian
1M-doc / 100K-vocab corpus") is its largest use.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


def make_vocab(vocab_size: int, seed: int = 0, min_len: int = 2, max_len: int = 10) -> list[bytes]:
    """Distinct pseudo-words with first letters drawn uniformly."""
    rng = np.random.default_rng(seed)
    words: set[bytes] = set()
    out: list[bytes] = []
    while len(out) < vocab_size:
        length = int(rng.integers(min_len, max_len + 1))
        w = bytes(_LETTERS[rng.integers(0, 26, size=length)])
        if w not in words:
            words.add(w)
            out.append(w)
    return out


def zipf_corpus(num_docs: int, vocab_size: int, tokens_per_doc: int,
                alpha: float = 1.2, seed: int = 0) -> list[bytes]:
    """``num_docs`` documents of space-joined Zipf-sampled words."""
    rng = np.random.default_rng(seed)
    vocab = np.array(make_vocab(vocab_size, seed=seed), dtype=object)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    cdf = np.cumsum(probs / probs.sum())
    docs = []
    # one inverse-CDF draw per chunk of documents (rng.choice with p=
    # rebuilds its sampling structure per call)
    chunk = max(1, (1 << 23) // max(tokens_per_doc, 1))
    for start in range(0, num_docs, chunk):
        count = min(chunk, num_docs - start)
        u = rng.random((count, tokens_per_doc))
        ids = np.searchsorted(cdf, u, side="right").clip(0, vocab_size - 1)
        docs.extend(b" ".join(row) for row in vocab[ids])
    return docs


def write_corpus(directory, docs: list[bytes]) -> list[str]:
    """Materialize docs as files; returns paths (for a manifest)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    width = len(str(len(docs)))
    for i, d in enumerate(docs):
        p = directory / f"doc_{i:0{width}d}.txt"
        p.write_bytes(d)
        paths.append(str(p))
    return paths
