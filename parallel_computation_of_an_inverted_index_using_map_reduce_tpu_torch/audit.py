"""Output integrity audit (``--audit`` / ``--verify``).

Recovery code has a failure mode worse than crashing: producing a
plausible but wrong index — every letter file still parses, and nothing
downstream notices.  ``--audit`` writes ``index.manifest.json`` next to
the letter files after the emit: per-file adler32 and size of
a.txt..z.txt, and of the ``index.mri`` serving artifact when the run
packed one.  ``--verify DIR`` re-hashes the directory against it, so any
consumer can prove an output directory is exactly what the run emitted.
The manifest is the JAX package's (``audit.py``) byte for byte.

The JAX module's per-window feed ledger (``WindowLedger``) and merge
checks (``check_merge``, ``check_spill``) check the host backend's
windows and spill runs; they come with that backend (ROADMAP A14).
Verifying a segment-managed directory comes with the segments layer
(ROADMAP A15).

Integrity failures raise :class:`AuditError` (the CLI maps it to exit
2): an integrity violation must never exit 0 or 3.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from .config import ALPHABET_SIZE
from .serve import artifact as artifact_mod
from .text import formatter
from .utils.checksum import file_checksum

#: Written next to a.txt..z.txt by ``--audit`` runs; read by ``--verify``.
MANIFEST_NAME = "index.manifest.json"


class AuditError(RuntimeError):
    """An integrity invariant failed — the output cannot be trusted."""


def letter_checksums(out_dir) -> dict[str, tuple[str, int]]:
    """``{filename: (adler32_hex, size_bytes)}`` for a.txt..z.txt, plus
    the ``index.mri`` serving artifact when the run packed one — a torn
    artifact must fail ``--verify`` exactly like a torn letter file."""
    out_dir = Path(out_dir)
    out = {formatter.letter_filename(letter):
           file_checksum(out_dir / formatter.letter_filename(letter))
           for letter in range(ALPHABET_SIZE)}
    art = out_dir / artifact_mod.ARTIFACT_NAME
    if art.exists():
        out[artifact_mod.ARTIFACT_NAME] = artifact_mod.checksum(art)
    return out


def write_output_manifest(out_dir, extra: dict | None = None) -> dict:
    """Write ``index.manifest.json`` (atomic tmp + rename) with per-file
    adler32 and size; returns the manifest dict."""
    out_dir = Path(out_dir)
    files = {name: {"adler32": crc, "bytes": size}
             for name, (crc, size) in letter_checksums(out_dir).items()}
    doc = {"version": 1, "files": files}
    if extra:
        doc.update(extra)
    tmp = out_dir / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n", encoding="utf-8")
    os.replace(tmp, out_dir / MANIFEST_NAME)
    return doc


def verify_output_dir(out_dir) -> tuple[bool, list[str]]:
    """Re-hash ``out_dir`` against its ``index.manifest.json``.

    Returns ``(ok, problems)`` — problems is a human-readable list of
    every mismatched or missing file (empty when ok).  Never raises on a
    content mismatch; a missing or corrupt manifest is itself a problem.
    A segment-managed directory is a problem naming ROADMAP A15 (its
    segments cannot be verified yet), as ``create_engine`` refuses it.
    """
    out_dir = Path(out_dir)
    problems: list[str] = []
    mpath = out_dir / MANIFEST_NAME
    seg_managed = artifact_mod.is_segment_managed(out_dir)
    if mpath.exists() or not seg_managed:
        try:
            expected = json.loads(mpath.read_text(encoding="utf-8"))["files"]
        except (OSError, ValueError, KeyError) as e:
            return False, [f"{mpath}: unreadable manifest ({e})"]
        try:
            actual = letter_checksums(out_dir)
        except OSError as e:
            return False, [f"{out_dir}: {e}"]
        for name, (crc, size) in actual.items():
            want = expected.get(name)
            if want is None:
                problems.append(f"{name}: present but not in manifest")
            elif want["adler32"] != crc or want["bytes"] != size:
                problems.append(
                    f"{name}: checksum mismatch (manifest "
                    f"{want['adler32']}/{want['bytes']}B, on disk "
                    f"{crc}/{size}B)")
        for name in expected:
            if name not in actual:
                problems.append(f"{name}: in manifest but missing on disk")
    if seg_managed:
        problems.append(
            f"{out_dir} is segment-managed ({artifact_mod.SEGMENTS_MANIFEST_NAME} "
            "present): verifying its segments is not ported yet (ROADMAP A15)")
    return not problems, problems
