"""Byte-exact output emit: 26 ``<letter>.txt`` postings files.

Reference format (main.c:227-234): one line per word,
``word:[id1 id2 ... idN]\\n`` — ids space-separated, no trailing space,
doc ids ascending (main.c:217-226), words ordered by document frequency
descending then lexicographically ascending (main.c:55-64).  All 26
files are always created, even when empty (main.c:149-150).  With an
``artifact_path`` both writers also pack the serving artifact
(serve/artifact.py) from the same arrays.
"""

from __future__ import annotations

import hashlib
import os
import time
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
    artifact_path: str | Path | None = None,
    letter_range: tuple[int, int] = (0, ALPHABET_SIZE),
) -> dict:
    """Write the 26 letter files from the device engine's output arrays,
    and the serving artifact at ``artifact_path`` when it is set.

    ``letter_range`` restricts the emit to letters ``[lo, hi)`` — the
    per-owner emit of the multi-shard letter ownership (the reference's
    reducer letter ranges, main.c:129-150): each owner writes only its
    own files, so no host assembles the global index.

    ``backend`` selects the writer: ``"native"`` requires the C++ emit
    (native/tokenizer.cc), ``"auto"`` uses it when the library loads,
    and ``"python"`` is this module's pure-Python writer.  All three are
    byte-identical; the Python writer stays authoritative.
    """
    output_dir = Path(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    if backend not in ("python", "auto", "native"):
        raise ValueError(f"unknown emit backend {backend!r}")
    lr = (int(letter_range[0]), int(letter_range[1]))
    if artifact_path is not None and lr != (0, ALPHABET_SIZE):
        raise ValueError(
            "artifact_path requires the full letter range: a partial "
            "emit does not hold the whole index")

    def _pack_artifact() -> dict:
        if artifact_path is None:
            return {}
        from ..serve import artifact as artifact_mod

        t0 = time.perf_counter()
        nbytes = artifact_mod.build_from_emit_arrays(
            artifact_path, vocab=np.asarray(vocab), order=order, df=df,
            offsets=offsets, postings=postings, max_doc_id=max_doc_id)
        return {"artifact_bytes": int(nbytes),
                "artifact_build_ms": round((time.perf_counter() - t0) * 1e3, 3)}

    if backend in ("auto", "native"):
        from .. import native

        if native.load() is not None:
            if lr == (0, ALPHABET_SIZE):
                idx_bounds = None
                lines = int(np.asarray(order).shape[0])
            else:
                # the order is letter-partitioned: the range's slice is
                # bounded by its letters' first and last positions
                letters_in_order = np.asarray(letter_of_term)[order]
                s, e = np.searchsorted(letters_in_order, [lr[0], lr[1]])
                idx_bounds = (int(s), int(e))
                lines = int(e - s)
            bytes_written = native.emit_native(output_dir, np.asarray(vocab), order, df,
                                               offsets, postings, letter_range=lr,
                                               idx_bounds=idx_bounds)
            return {"lines_written": lines, "letters": lr[1] - lr[0],
                    "bytes_written": bytes_written, "emit_backend": "native",
                    **_pack_artifact()}
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
    lines_written = 0
    for letter in range(*lr):
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
        lines_written += hi - lo
    return {"lines_written": lines_written, "letters": lr[1] - lr[0],
            "emit_backend": "python", **_pack_artifact()}


def emit_grouped(output_dir: str | Path,
                 per_letter: dict[int, list[tuple[bytes, list[int]]]],
                 artifact_path: str | Path | None = None) -> dict:
    """Write letter files from already-ordered (word, ids) groups
    (oracle + empty-corpus paths); with ``artifact_path``, pack the
    serving artifact from the same groups and return its stats."""
    output_dir = Path(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    for letter in range(ALPHABET_SIZE):
        out = bytearray()
        for word, ids in per_letter.get(letter, []):
            out += word + b":[" + " ".join(map(str, ids)).encode("ascii") + b"]\n"
        _write_letter_atomic(output_dir / letter_filename(letter), bytes(out))
    if artifact_path is None:
        return {}
    from ..serve import artifact as artifact_mod

    t0 = time.perf_counter()
    nbytes = artifact_mod.build_from_grouped(artifact_path, per_letter)
    return {"artifact_bytes": int(nbytes),
            "artifact_build_ms": round((time.perf_counter() - t0) * 1e3, 3)}


def letters_md5(output_dir: str | Path) -> str:
    """md5 over a.txt..z.txt concatenated in letter order — the
    conformance fingerprint shared with the JAX package."""
    output_dir = Path(output_dir)
    h = hashlib.md5()
    for letter in range(ALPHABET_SIZE):
        h.update((output_dir / letter_filename(letter)).read_bytes())
    return h.hexdigest()
