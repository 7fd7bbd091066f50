"""Output integrity audit (``--audit`` / ``--verify``).

Recovery code has a failure mode worse than crashing: producing a
plausible but wrong index — every letter file still parses, and nothing
downstream notices.  ``--audit`` writes ``index.manifest.json`` next to
the letter files after the emit: per-file adler32 and size of
a.txt..z.txt, and of the ``index.mri`` serving artifact when the run
packed one.  ``--verify DIR`` re-hashes the directory against it, so any
consumer can prove an output directory is exactly what the run emitted.
The manifest is the JAX package's (``audit.py``) byte for byte.

The cpu backend's parallel path adds three in-run checks under
``--audit``: :class:`WindowLedger` (which worker fed which global window,
with an adler32 of the exact arrays handed to the native scan; a dead
worker's entries are discarded with its native handle, so at merge time
exactly one live entry per planned window must remain),
:func:`check_merge` (the native merge walk: per-term df sums equal the
worker run lengths and every run ascends, plus the pair and vocab totals)
and :func:`check_spill` (its out-of-core analogue).  On a
segment-managed directory ``--verify`` also re-hashes every live segment
artifact and tombstone bitmap against ``segments.manifest.json``
(:func:`verify_segments`).

Integrity failures raise :class:`AuditError` (the CLI maps it to exit
2): an integrity violation must never exit 0 or 3.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from pathlib import Path

from .config import ALPHABET_SIZE
from .serve import artifact as artifact_mod
from .text import formatter
from .utils.checksum import file_checksum

#: Written next to a.txt..z.txt by ``--audit`` runs; read by ``--verify``.
MANIFEST_NAME = "index.manifest.json"


class AuditError(RuntimeError):
    """An integrity invariant failed — the output cannot be trusted."""


def window_checksum(buf, ends, ids) -> int:
    """adler32 over one window's bytes + doc structure — cheap enough
    to run per window in the scan loop (the <5 %% audit budget), strong
    enough to catch a wrong-window or torn-arena feed."""
    c = zlib.adler32(buf)
    c = zlib.adler32(ends, c)
    return zlib.adler32(ids, c)


class WindowLedger:
    """Thread-safe which-worker-fed-which-window accounting.

    Scan workers :meth:`record` after each successful native feed;
    the recovery layer :meth:`discard_worker` when a worker dies (its
    native handle — and thus its windows' postings — die with it);
    :meth:`check_complete` is the pre-merge gate.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[int, dict] = {}   # window -> live entry
        self._dups: list[int] = []            # double-fed live windows
        self._dead: set = set()               # discarded workers

    def record(self, window_index: int, *, worker, docs: int,
               nbytes: int, checksum: int) -> None:
        with self._lock:
            if worker in self._dead:
                return  # zombie feed after retirement: already requeued
            prev = self._entries.get(window_index)
            if prev is not None:
                self._dups.append(window_index)
            self._entries[window_index] = {
                "worker": worker, "docs": int(docs),
                "bytes": int(nbytes), "checksum": int(checksum),
            }

    def discard_worker(self, worker) -> int:
        """Forget everything ``worker`` fed (called with its native
        handle's discard); returns how many entries were dropped."""
        with self._lock:
            self._dead.add(worker)
            drop = [wi for wi, e in self._entries.items()
                    if e["worker"] == worker]
            for wi in drop:
                del self._entries[wi]
            self._dups = [wi for wi in self._dups if wi in self._entries]
            return len(drop)

    def check_complete(self, num_windows: int,
                       missing_ok=()) -> None:
        """Every planned window 1..num_windows must have exactly one
        live entry, except those in ``missing_ok`` (windows the run
        already reported as skipped — the degraded arm).  Raises
        :class:`AuditError` naming the offending windows."""
        allowed = set(missing_ok)
        with self._lock:
            missing = [wi for wi in range(1, num_windows + 1)
                       if wi not in self._entries and wi not in allowed]
            dups = sorted(set(self._dups))
        if missing:
            raise AuditError(
                f"audit: window {', '.join(map(str, missing))} of "
                f"{num_windows} never reached the native scan — "
                "postings silently dropped")
        if dups:
            raise AuditError(
                f"audit: window {', '.join(map(str, dups))} fed to the "
                "scan more than once — postings double-counted")

    def summary(self) -> dict:
        with self._lock:
            return {
                "windows": len(self._entries),
                "docs": sum(e["docs"] for e in self._entries.values()),
                "bytes": sum(e["bytes"] for e in self._entries.values()),
            }


def check_merge(merge, streams) -> None:
    """Merge invariants before any reducer emits (``--audit``).

    ``merge`` is a native ``HostIndexMerge`` over ``streams`` (the live
    workers' ``HostIndexStream`` handles).  The native walk proves df
    sums and per-run monotonicity; the Python side cross-checks the
    scan totals the merge folded.
    """
    rc, bad_term = merge.audit()
    if rc == 1:
        raise AuditError(
            f"audit: merged df of global term {bad_term} does not equal "
            "the sum of its worker run lengths — a worker's postings "
            "were lost or double-merged")
    if rc == 2:
        raise AuditError(
            f"audit: posting run of global term {bad_term} is not "
            "strictly ascending — window postings interleaved wrongly")
    if rc != 0:
        raise AuditError(f"audit: native merge walk failed (rc={rc})")
    infos = [s.info() for s in streams]
    mstats = merge.stats()
    pairs = sum(i["pairs"] for i in infos)
    if pairs != mstats["unique_pairs"]:
        raise AuditError(
            f"audit: merge folded {mstats['unique_pairs']} (term, doc) "
            f"pairs but the workers scanned {pairs}")
    vocab = mstats["unique_terms"]
    lo = max((i["vocab"] for i in infos), default=0)
    hi = sum(i["vocab"] for i in infos)
    if not lo <= vocab <= hi:
        raise AuditError(
            f"audit: merged vocab {vocab} outside the union bounds "
            f"[{lo}, {hi}] of the worker vocabularies")


def check_spill(run_pairs: int, merged_pairs: int, run_vocab_hi: int,
                merged_vocab: int) -> None:
    """Spill-tier merge invariants (``--audit``, out-of-core path).

    The disk tier's analogue of :func:`check_merge`: every (term, doc)
    pair written to a verified run must come back out of the per-shard
    k-way merge exactly once (per-term ascending order and pair
    uniqueness are enforced inside the merge itself), and the merged
    vocabulary can't exceed the sum of the runs' vocabularies.
    """
    if run_pairs != merged_pairs:
        raise AuditError(
            f"audit: shard merge folded {merged_pairs} (term, doc) "
            f"pairs but the spill runs hold {run_pairs}")
    if merged_vocab > run_vocab_hi:
        raise AuditError(
            f"audit: merged vocab {merged_vocab} exceeds the sum "
            f"{run_vocab_hi} of the spill runs' vocabularies")


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


def verify_segments(out_dir) -> list[str]:
    """Re-hash every live segment artifact and tombstone file against
    ``segments.manifest.json`` (whose own body checksum gates the walk).
    Returns a problem list — empty when clean OR when the directory was
    never segment-managed."""
    from . import segments

    out_dir = Path(out_dir)
    try:
        man = segments.load_manifest(out_dir)
    except segments.SegmentError as e:
        return [str(e)]
    if man is None:
        return []
    problems: list[str] = []
    for entry in man.entries:
        sdir = segments.segment_dir(out_dir, entry.name)
        art = sdir / artifact_mod.ARTIFACT_NAME
        try:
            crc, size = artifact_mod.checksum(art)
        except OSError as e:
            problems.append(f"{art}: {e}")
        else:
            if crc != entry.adler32 or size != entry.bytes:
                problems.append(
                    f"{art}: checksum mismatch (manifest "
                    f"{entry.adler32}/{entry.bytes}B, on disk "
                    f"{crc}/{size}B)")
        if entry.tombstones is None:
            continue
        tpath = sdir / entry.tombstones
        try:
            data = tpath.read_bytes()
        except OSError as e:
            problems.append(f"{tpath}: {e}")
            continue
        crc = f"{zlib.adler32(data):08x}"
        if crc != entry.tomb_adler32 or len(data) != entry.tomb_bytes:
            problems.append(
                f"{tpath}: checksum mismatch (manifest "
                f"{entry.tomb_adler32}/{entry.tomb_bytes}B, on disk "
                f"{crc}/{len(data)}B)")
    return problems


def verify_output_dir(out_dir) -> tuple[bool, list[str]]:
    """Re-hash ``out_dir`` against its ``index.manifest.json`` and — for
    a segment-managed directory — its ``segments.manifest.json``.

    Returns ``(ok, problems)`` — problems is a human-readable list of
    every mismatched or missing file (empty when ok).  Never raises on a
    content mismatch; a missing or corrupt manifest is itself a problem.
    A directory that is only segment-managed (appends into a directory
    that never had an ``--audit`` build) skips the letter-file check.
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
        problems.extend(verify_segments(out_dir))
    return not problems, problems
