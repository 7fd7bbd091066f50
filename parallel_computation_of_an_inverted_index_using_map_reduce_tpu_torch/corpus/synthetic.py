"""Deterministic synthetic corpora (Zipfian), for tests and the chip
smoke run when no real corpus is at hand.

Same generators, seed for seed and byte for byte, as the JAX package's
``corpus/synthetic.py``: :func:`zipf_corpus` materializes documents,
:class:`SyntheticManifest` generates them on demand behind the manifest
surface.  BASELINE.json config 4 ("Synthetic Zipfian 1M-doc /
100K-vocab corpus") is their largest use.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np

from .virtualseq import VirtualSeq

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


class SyntheticManifest:
    """Manifest-shaped Zipfian corpus generated on the fly — no files.

    Duck-types the ``Manifest`` surface the loaders use (``__len__``,
    ``doc_id``, ``read_doc``, ``paths`` for error messages, ``sizes`` /
    ``total_bytes`` for the scheduler) while generating documents
    lazily in fixed-size chunks, deterministically per chunk — random
    access costs one chunk generation, sequential streaming costs one
    per chunk total.  This is what makes BASELINE.json config 4
    (1M docs / 100K vocab) runnable without materializing a million
    files.  The same parameters give the JAX package's documents, byte
    for byte, and its ``fingerprint_extra``.
    """

    def __init__(self, num_docs: int, vocab_size: int, tokens_per_doc: int,
                 alpha: float = 1.05, seed: int = 0, gen_chunk: int = 65536):
        self.num_docs = num_docs
        self.tokens_per_doc = tokens_per_doc
        self.seed = seed
        self.gen_chunk = gen_chunk
        # corpus identity for checkpoint fingerprints: the virtual
        # paths are just '<synthetic doc i>', so without this, two
        # synthetic corpora with equal num_docs would fingerprint
        # identically and a resume could silently mix windows from
        # different generator parameters
        self.fingerprint_extra = (
            f"zipf:v{vocab_size}:t{tokens_per_doc}:a{alpha}"
            f":s{seed}:g{gen_chunk}")
        self._vocab = np.array(make_vocab(vocab_size, seed=seed), dtype=object)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-alpha)
        self._cdf = np.cumsum(probs / probs.sum())
        # the two most recent chunks, generated under the lock: the host
        # backend's K reader threads call read_doc at once, and at a chunk
        # boundary its workers straddle two chunks
        self._lock = threading.Lock()
        self._cache: dict[int, list[bytes]] = {}  # guarded by: self._lock
        # mean word length + separators, for byte-balance planning
        mean_len = float(np.mean([len(w) for w in self._vocab[:1024]])) + 1.0
        self._avg_doc_bytes = int(mean_len * tokens_per_doc)

    def __len__(self) -> int:
        return self.num_docs

    def doc_id(self, index: int) -> int:
        return index + 1

    @property
    def paths(self):
        return _VirtualPaths(self.num_docs)

    @property
    def sizes(self):
        return _ConstSeq(self._avg_doc_bytes, self.num_docs)

    @property
    def total_bytes(self) -> int:
        return self._avg_doc_bytes * self.num_docs

    def _generate(self, chunk_idx: int) -> list[bytes]:
        rng = np.random.default_rng((self.seed, chunk_idx))
        lo = chunk_idx * self.gen_chunk
        count = min(self.gen_chunk, self.num_docs - lo)
        u = rng.random((count, self.tokens_per_doc))
        ids = np.searchsorted(self._cdf, u, side="right").clip(
            0, len(self._vocab) - 1)
        return [b" ".join(row) for row in self._vocab[ids]]

    def read_doc(self, index: int) -> bytes:
        chunk_idx = index // self.gen_chunk
        with self._lock:
            docs = self._cache.get(chunk_idx)
            if docs is None:
                docs = self._generate(chunk_idx)
                if len(self._cache) >= 2:
                    del self._cache[next(iter(self._cache))]  # the older one
                self._cache[chunk_idx] = docs
        return docs[index - chunk_idx * self.gen_chunk]


def _VirtualPaths(n: int):
    """Lazy path labels for SyntheticManifest error messages
    (iteration-terminating sequence semantics live in VirtualSeq)."""
    return VirtualSeq(n, lambda i: f"<synthetic doc {i}>")


def _ConstSeq(value: int, n: int):
    """Constant-valued virtual size list (no 1M-element tuple)."""
    return VirtualSeq(n, lambda i: value)


def synthetic_manifest(num_docs: int, vocab_size: int, tokens_per_doc: int,
                       alpha: float = 1.05, seed: int = 0,
                       gen_chunk: int = 65536) -> SyntheticManifest:
    """BASELINE.json config 4 generator as a streamable manifest."""
    return SyntheticManifest(num_docs, vocab_size, tokens_per_doc,
                             alpha=alpha, seed=seed, gen_chunk=gen_chunk)


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
