"""Query helpers shared by the serve engines (the JAX package's
``serve/engine.py``): query-term normalization into the engines' batch
array, the letter argument of ``top_k``, the BM25 constants and the
scoring-mode knob."""

from __future__ import annotations

import numpy as np

from ..utils import envknobs

#: BM25 parameters (the JAX package's, so scores agree).
BM25_K1 = 1.2
BM25_B = 0.75

SCORE_ENV = "MRI_SERVE_SCORE"
SCORE_CHOICES = ("df", "bm25")


def _normalize(term) -> bytes:
    """Query-side mirror of the tokenizer's cleaning: lowercase, alpha
    only.  A term that cleans to something else can't be in the index."""
    if isinstance(term, bytes):
        term = term.decode("latin-1")
    term = term.lower()
    return term.encode("ascii") if term.isascii() and term.isalpha() else b""


def encode_terms(terms, width: int) -> np.ndarray:
    """Normalize str/bytes queries into the engines' S-dtype batch
    array; terms that normalize away or exceed the vocabulary width
    become b'' (never found)."""
    cleaned = [_normalize(t) for t in terms]
    return np.array([t if len(t) <= width else b"" for t in cleaned], dtype=f"S{width}")


def letter_index(letter) -> int:
    """'a'..'z' (str/bytes) or 0..25 -> letter_dir slot, or ValueError."""
    if isinstance(letter, (str, bytes)):
        letter = (letter.encode() if isinstance(letter, str) else letter)
        letter = letter[0] - ord("a")
    if not 0 <= letter < 26:
        raise ValueError(f"letter index out of range: {letter}")
    return letter


def resolve_score(score: str | None = None) -> str:
    """``df``/``bm25`` (+ ``$MRI_SERVE_SCORE`` default) -> the mode."""
    score = score or envknobs.get(SCORE_ENV)
    if score not in SCORE_CHOICES:
        raise ValueError(f"unknown score mode {score!r} (choices: {SCORE_CHOICES})")
    return score
