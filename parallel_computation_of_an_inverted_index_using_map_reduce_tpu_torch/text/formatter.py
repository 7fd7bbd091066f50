"""Byte-exact output emit: 26 ``<letter>.txt`` postings files.

Reference format (main.c:227-234): one line per word,
``word:[id1 id2 ... idN]\\n`` — ids space-separated, no trailing space,
doc ids ascending (main.c:217-226), words ordered by document frequency
descending then lexicographically ascending (main.c:55-64).  All 26
files are always created, even when empty (main.c:149-150).
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

from ..config import ALPHABET_SIZE


def letter_filename(letter_index: int) -> str:
    return f"{chr(ord('a') + letter_index)}.txt"


def _doc_id_str_table(max_doc_id: int) -> np.ndarray:
    """Doc ids repeat constantly across postings; pre-render each once."""
    return np.array([str(i).encode("ascii") for i in range(max_doc_id + 1)], dtype=object)


def _write_letter_atomic(path: Path, payload: bytes) -> None:
    """tmp + rename so a crash mid-emit never leaves a truncated letter
    file that parses as a smaller-but-plausible index."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def emit_index(
    output_dir: str | Path,
    vocab: np.ndarray,            # (V,) numpy 'S' array, sorted
    letter_of_term: np.ndarray,   # (V,) int
    order: np.ndarray,            # (V,) term ids sorted by (letter, -df, term)
    df: np.ndarray,               # (V,) document frequency per term id
    offsets: np.ndarray,          # (V,) exclusive start of term's postings
    postings: np.ndarray,         # (>=num pairs,) compacted ascending doc ids
    max_doc_id: int,
    backend: str = "python",
) -> dict:
    """Write the 26 letter files from the device engine's output arrays.

    ``backend`` selects the writer: ``"native"`` requires the C++ emit
    (native/tokenizer.cc), ``"auto"`` uses it when the library loads,
    and ``"python"`` is this module's pure-Python writer.  All three are
    byte-identical; the Python writer stays authoritative.
    """
    output_dir = Path(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    if backend not in ("python", "auto", "native"):
        raise ValueError(f"unknown emit backend {backend!r}")
    if backend in ("auto", "native"):
        from .. import native

        if native.load() is not None:
            bytes_written = native.emit_native(output_dir, np.asarray(vocab), order, df,
                                               offsets, postings)
            return {"lines_written": int(np.asarray(order).shape[0]),
                    "bytes_written": bytes_written, "emit_backend": "native"}
        if backend == "native":
            raise RuntimeError(
                f"emit_backend='native' but the native library is "
                f"unavailable: {native.load_error()}")
    id_strs = _doc_id_str_table(max_doc_id)
    vocab_py = vocab.tolist()  # list[bytes]; plain indexing beats np scalar access
    df = np.asarray(df)
    offsets = np.asarray(offsets)
    postings = np.asarray(postings)

    letters_in_order = np.asarray(letter_of_term)[order]
    bounds = np.searchsorted(letters_in_order, np.arange(ALPHABET_SIZE + 1))
    for letter in range(ALPHABET_SIZE):
        lo, hi = int(bounds[letter]), int(bounds[letter + 1])
        out = bytearray()
        for t in order[lo:hi].tolist():
            n = int(df[t])
            start = int(offsets[t])
            out += vocab_py[t]
            out += b":["
            out += b" ".join(id_strs[postings[start : start + n]])
            out += b"]\n"
        _write_letter_atomic(output_dir / letter_filename(letter), bytes(out))
    return {"lines_written": int(bounds[-1] - bounds[0]), "emit_backend": "python"}


def emit_grouped(output_dir: str | Path,
                 per_letter: dict[int, list[tuple[bytes, list[int]]]]) -> None:
    """Write letter files from already-ordered (word, ids) groups
    (oracle + empty-corpus paths)."""
    output_dir = Path(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    for letter in range(ALPHABET_SIZE):
        out = bytearray()
        for word, ids in per_letter.get(letter, []):
            out += word + b":[" + " ".join(map(str, ids)).encode("ascii") + b"]\n"
        _write_letter_atomic(output_dir / letter_filename(letter), bytes(out))


def letters_md5(output_dir: str | Path) -> str:
    """md5 over a.txt..z.txt concatenated in letter order — the
    conformance fingerprint shared with the JAX package."""
    output_dir = Path(output_dir)
    h = hashlib.md5()
    for letter in range(ALPHABET_SIZE):
        h.update((output_dir / letter_filename(letter)).read_bytes())
    return h.hexdigest()
