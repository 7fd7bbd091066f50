"""Pure-Python oracle backend.

An independent, dictionary-based implementation of the reference's
observable contract: same tokenization, dedup, ordering and file format
as the pthread program, written the obvious Python way.  It is the
conformance oracle for the device engine and the ``--backend oracle``
CLI path.
"""

from __future__ import annotations

from pathlib import Path

from ..config import ALPHABET_SIZE
from ..corpus.manifest import DegradationReport, Manifest, load_documents
from ..text.formatter import emit_grouped
from ..text.tokenizer import clean_token


def oracle_postings(contents: list[bytes], doc_ids: list[int]) -> dict[str, list[int]]:
    """word -> ascending unique doc ids, from raw document bytes."""
    index: dict[str, set[int]] = {}
    for raw, doc in zip(contents, doc_ids):
        for token in raw.split():
            word = clean_token(token)
            if word:
                index.setdefault(word, set()).add(doc)
    return {w: sorted(s) for w, s in index.items()}


def group_for_emit(postings: dict[str, list[int]]) -> dict[int, list[tuple[bytes, list[int]]]]:
    """Order words by (df desc, word asc) within their first-letter group
    (reference comparator main.c:55-64; letter files main.c:149-150)."""
    per_letter: dict[int, list[tuple[bytes, list[int]]]] = {i: [] for i in range(ALPHABET_SIZE)}
    for word in sorted(postings, key=lambda w: (-len(postings[w]), w)):
        per_letter[ord(word[0]) - ord("a")].append((word.encode("ascii"), postings[word]))
    return per_letter


def oracle_index(manifest: Manifest, output_dir: str | Path = ".",
                 report: DegradationReport | None = None,
                 artifact_path: str | Path | None = None) -> dict:
    """End-to-end oracle run: manifest -> 26 letter files (and the
    serving artifact when ``artifact_path`` is set)."""
    contents, doc_ids = load_documents(manifest, report)
    postings = oracle_postings(contents, doc_ids)
    art_stats = emit_grouped(output_dir, group_for_emit(postings),
                             artifact_path=artifact_path)
    return {
        "documents": len(contents),
        "unique_terms": len(postings),
        "postings": sum(len(v) for v in postings.values()),
        **art_stats,
    }
