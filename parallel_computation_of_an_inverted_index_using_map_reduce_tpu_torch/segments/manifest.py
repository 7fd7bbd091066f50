"""``segments.manifest.json`` — the generation-numbered segment set.

The manifest is the single source of truth for a live (incrementally
updated) index directory: which immutable segment artifacts are
serving, at which document-id bases, and which tombstone files mask
deleted documents.  Every mutation (append / delete / compact) writes a
NEW manifest under ``generation + 1`` and publishes it with the same
stage-then-rename discipline the artifact writer and the daemon's hot
reload already use — readers either see the complete old set or the
complete new set, never a torn mix.

Integrity is checked at three layers:

* the manifest body carries its own adler32 (``checksum`` field over
  the canonical JSON payload), so a torn/bit-rotted manifest file is
  rejected at load;
* every entry records the adler32 + byte size of its ``index.mri`` and
  tombstone file, so ``--verify DIR`` can re-hash the whole
  generation without opening an engine;
* each ``index.mri`` keeps its own header/payload checksums, verified
  again when an engine maps it.

Document-id model: segment-local ids are 1-based; the global id of a
segment document is ``doc_base + local_id``.  ``docs`` is the local id
span (max local id), so segments own the disjoint global ranges
``(doc_base, doc_base + docs]``.  Compaction preserves global ids (the
merged segment keeps the first input's ``doc_base`` and re-bases
locals without renumbering survivors), so ids handed to clients stay
valid for the lifetime of the directory — the id space just becomes
sparse where deletes landed.

Cross-process mutators serialize on ``segments.lock`` (flock), so a
CLI append racing a daemon compaction cannot lose an update; in-daemon
mutations additionally serialize under the reload lock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from pathlib import Path

from .. import faults
from ..utils.checksum import adler32_hex

MANIFEST_NAME = "segments.manifest.json"
SEGMENTS_DIR = "segments"
LOCK_NAME = "segments.lock"
MAGIC = "MRISEGMENTS1"


class SegmentError(RuntimeError):
    """The segment set is missing, torn, or internally inconsistent."""


@dataclasses.dataclass(frozen=True)
class SegmentEntry:
    """One immutable segment of the live index."""

    name: str                 # directory name under segments/
    doc_base: int             # global id = doc_base + local id
    docs: int                 # local id span (max local id)
    adler32: str              # of the segment's index.mri
    bytes: int                # size of the segment's index.mri
    tombstones: str | None = None      # file name inside the segment dir
    tomb_adler32: str | None = None
    tomb_bytes: int | None = None
    tomb_count: int = 0       # set bits (deleted docs) in the bitmap

    def to_json(self) -> dict:
        d = {"name": self.name, "doc_base": self.doc_base,
             "docs": self.docs, "adler32": self.adler32,
             "bytes": self.bytes}
        if self.tombstones is not None:
            d["tombstones"] = {
                "name": self.tombstones, "adler32": self.tomb_adler32,
                "bytes": self.tomb_bytes, "count": self.tomb_count}
        return d

    @classmethod
    def from_json(cls, d: dict) -> "SegmentEntry":
        try:
            t = d.get("tombstones")
            return cls(
                name=str(d["name"]), doc_base=int(d["doc_base"]),
                docs=int(d["docs"]), adler32=str(d["adler32"]),
                bytes=int(d["bytes"]),
                tombstones=str(t["name"]) if t else None,
                tomb_adler32=str(t["adler32"]) if t else None,
                tomb_bytes=int(t["bytes"]) if t else None,
                tomb_count=int(t["count"]) if t else 0)
        except (KeyError, TypeError, ValueError) as e:
            raise SegmentError(f"malformed segment entry {d!r}: {e}") \
                from e


@dataclasses.dataclass(frozen=True)
class SegmentManifest:
    """One generation of the segment set (immutable once published)."""

    generation: int
    next_seg: int             # monotonic segment ordinal allocator
    entries: tuple[SegmentEntry, ...]
    wal_seq: int = 0          # highest WAL record seq this set covers

    @property
    def doc_span(self) -> int:
        """One past the highest global doc id any entry can hold."""
        return max((e.doc_base + e.docs for e in self.entries),
                   default=0)

    @property
    def live_docs_max(self) -> int:
        """Upper bound on live documents (span minus tombstones)."""
        return sum(e.docs - e.tomb_count for e in self.entries)

    def to_json(self) -> dict:
        return {"magic": MAGIC, "generation": self.generation,
                "next_seg": self.next_seg, "wal_seq": self.wal_seq,
                "entries": [e.to_json() for e in self.entries]}


def _body_checksum(body: dict) -> str:
    blob = json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return adler32_hex(blob)


def manifest_path(root) -> Path:
    return Path(root) / MANIFEST_NAME


def segments_root(root) -> Path:
    return Path(root) / SEGMENTS_DIR


def segment_dir(root, name: str) -> Path:
    return segments_root(root) / name


@contextlib.contextmanager
def mutation_lock(root):
    """Cross-process mutation lock for one index directory (flock on
    ``segments.lock``) — append/delete/compact hold it across their
    whole read-modify-publish cycle, so concurrent mutators serialize
    instead of losing generations."""
    import fcntl
    Path(root).mkdir(parents=True, exist_ok=True)
    path = Path(root) / LOCK_NAME
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def load_manifest(root) -> SegmentManifest | None:
    """Parse + checksum-verify the current manifest; None when the
    directory has never been segment-managed.  Every structural or
    checksum violation raises :class:`SegmentError` — a torn set is
    rejected whole, never half-served."""
    path = manifest_path(root)
    try:
        text = path.read_text(encoding="utf-8")
    except FileNotFoundError:
        return None
    except OSError as e:
        raise SegmentError(f"{path}: cannot read manifest ({e})") from e
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise SegmentError(f"{path}: torn manifest (bad JSON: {e})") \
            from e
    if not isinstance(doc, dict) or doc.get("magic") != MAGIC:
        raise SegmentError(f"{path}: not a segment manifest")
    want = doc.pop("checksum", None)
    got = _body_checksum(doc)
    if want != got:
        raise SegmentError(
            f"{path}: manifest checksum mismatch "
            f"(stored {want!r}, computed {got!r})")
    try:
        man = SegmentManifest(
            generation=int(doc["generation"]),
            next_seg=int(doc["next_seg"]),
            entries=tuple(SegmentEntry.from_json(e)
                          for e in doc["entries"]),
            # pre-WAL manifests carry no wal_seq: they cover seq 0
            wal_seq=int(doc.get("wal_seq", 0)))
    except (KeyError, TypeError, ValueError) as e:
        raise SegmentError(f"{path}: malformed manifest: {e}") from e
    bases = [(e.doc_base, e.doc_base + e.docs) for e in man.entries]
    if bases != sorted(bases) or any(
            bases[i][1] > bases[i + 1][0] for i in range(len(bases) - 1)):
        raise SegmentError(
            f"{path}: segment doc ranges overlap or are unsorted")
    return man


def save_manifest(root, man: SegmentManifest, *, op: str) -> Path:
    """Publish a new generation atomically (stage + rename).

    ``op`` names the mutation (append/delete/compact/seed) for the
    fault-injection hook: ``append-torn-manifest`` tears the STAGED
    file and aborts before the rename, so the previous generation keeps
    serving — the crash-mid-publish the discipline exists to survive.
    """
    path = manifest_path(root)
    body = man.to_json()
    body["checksum"] = _body_checksum(body)
    blob = json.dumps(body, indent=1, sort_keys=True) + "\n"
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    inj = faults.active()
    if inj is not None:
        try:
            inj.on_segment_publish(op, str(tmp))
        except faults.InjectedPublishTear as e:
            # a crash mid-publish: the torn staged file never replaces
            # the live manifest, so the old generation keeps serving
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise SegmentError(f"{path}: publish failed ({e})") from e
    os.replace(tmp, path)
    return path


def is_segmented(root) -> bool:
    return manifest_path(root).exists()
