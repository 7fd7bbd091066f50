"""Mutation write-ahead log: acked means durable, crash means replay.

The manifest swap makes each *published* generation atomic, but two
windows could still lose an **acknowledged** mutation before this
module existed: the daemon's buffered deletes (acked on the wire,
flushed to a manifest only every ``MRI_SEGMENT_TOMBSTONE_FLUSH`` ops)
and any crash between a mutation's side effects and its publish.  The
WAL closes both: every append / delete / compact is recorded here —
fsync'd — *before* the ``segments.manifest.json`` swap, and a mutation
is only acknowledged on the wire after its record is durable.  On
daemon start (and via ``recover DIR``), :func:`replay` rolls the
directory forward to the exact last-acknowledged state.

Container discipline follows ``build/spill.py``'s ``MRISPILL`` rule —
magic, length-framed sections, per-section adler32, quarantine on
damage — adapted to an append-only record stream::

    header   8s    b"MRIWAL01"
    record   4s    b"WREC"
             u32   payload length (little-endian)
             ...   canonical-JSON payload
             8s    adler32 hex of the payload (utils.checksum spelling)

Unlike spill files the WAL **fsyncs every append**: its whole point is
surviving SIGKILL, so durability is the product, not overhead.

Sequencing model: every record carries a monotonic ``seq``; every
manifest publish stamps ``wal_seq`` with the seq it covers.  Replay
applies records with ``seq > manifest.wal_seq`` in order;
:func:`truncate_published` drops records at or below the stamp.  The
invariant mutators must keep: a record is only logged when every
lower-seq record has already been applied (the daemon flushes buffered
deletes before appends/compacts for exactly this reason).  Mixing CLI
mutations with a live daemon holding *buffered* deletes remains
unsupported — the same pre-existing hazard the flush knob documents.

A torn tail (crash or the ``wal-torn-record`` fault mid-append) is
quarantined to ``segments.wal.corrupt`` and the log truncated back to
the last whole record — a torn record was by definition never acked,
so dropping it loses nothing.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import struct
from pathlib import Path

from .manifest import (SegmentError, SegmentManifest, load_manifest,
                       mutation_lock, save_manifest, segments_root)
from .. import faults
from ..obs import metrics as obs_metrics
from ..utils import envknobs
from ..utils.checksum import adler32_hex

log = logging.getLogger("mri_torch.segments")

WAL_NAME = "segments.wal"
WAL_MAGIC = b"MRIWAL01"
REC_MAGIC = b"WREC"
_REC_FIXED = len(REC_MAGIC) + 4   # record magic + u32 payload length
_CRC_BYTES = 8                    # adler32 hex digits

WAL_ENV = "MRI_SEGMENT_WAL"


class WalError(SegmentError):
    """The WAL itself is unusable (distinct from a quarantined tail,
    which is repaired in place and only reported)."""


def wal_path(root) -> Path:
    return Path(root) / WAL_NAME


def corrupt_path(root) -> Path:
    return Path(root) / (WAL_NAME + ".corrupt")


def wal_enabled() -> bool:
    """``MRI_SEGMENT_WAL`` (default on).  Off restores the pre-WAL
    publish-only durability."""
    return bool(envknobs.get(WAL_ENV))


def _encode_record(rec: dict) -> bytes:
    payload = json.dumps(rec, sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    return (REC_MAGIC + struct.pack("<I", len(payload)) + payload
            + adler32_hex(payload).encode("ascii"))


def _parse(data: bytes) -> tuple[list[dict], int, str | None]:
    """``(records, clean_offset, damage)``: parse until the first torn
    or corrupt record; ``clean_offset`` is where the undamaged prefix
    ends (0 when even the header is wrong)."""
    if not data:
        return [], 0, None
    if len(data) < len(WAL_MAGIC) or data[:len(WAL_MAGIC)] != WAL_MAGIC:
        return [], 0, "bad wal magic"
    off = len(WAL_MAGIC)
    records: list[dict] = []
    damage = None
    while off < len(data):
        if len(data) - off < _REC_FIXED:
            damage = "torn record frame"
            break
        if data[off:off + len(REC_MAGIC)] != REC_MAGIC:
            damage = "bad record magic"
            break
        (n,) = struct.unpack_from("<I", data, off + len(REC_MAGIC))
        end = off + _REC_FIXED + n + _CRC_BYTES
        if end > len(data):
            damage = "torn record payload"
            break
        payload = data[off + _REC_FIXED:off + _REC_FIXED + n]
        want = data[end - _CRC_BYTES:end].decode("ascii", "replace")
        if adler32_hex(payload) != want:
            damage = "record checksum mismatch"
            break
        try:
            rec = json.loads(payload)
            seq = int(rec["seq"])
            op = str(rec["op"])
        except (ValueError, KeyError, TypeError):
            damage = "malformed record payload"
            break
        if op not in ("append", "delete", "compact"):
            damage = f"unknown record op {op!r}"
            break
        if records and seq <= int(records[-1]["seq"]):
            damage = "non-monotonic record seq"
            break
        records.append(rec)
        off = end
    return records, off, damage


def _rewrite(root, records: list[dict]) -> None:
    """Atomically rewrite the log to exactly ``records`` (fsync'd); an
    empty record set removes the file entirely."""
    path = wal_path(root)
    if not records:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        return
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(WAL_MAGIC)
        for rec in records:
            f.write(_encode_record(rec))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_records(root) -> tuple[list[dict], dict]:
    """Parse the log, repairing damage in place: the torn tail is
    quarantined to ``segments.wal.corrupt`` and the log truncated back
    to its last whole record.  Returns ``(records, info)`` where
    ``info`` reports any quarantine.  Caller holds the mutation lock
    (or is single-owner, e.g. recovery)."""
    path = wal_path(root)
    try:
        data = path.read_bytes()
    except FileNotFoundError:
        return [], {}
    except OSError as e:
        raise WalError(f"{path}: cannot read wal ({e})") from e
    records, clean, damage = _parse(data)
    if damage is None:
        return records, {}
    tail = data[clean:]
    cpath = corrupt_path(root)
    with open(cpath, "ab") as f:
        f.write(tail)
    _rewrite(root, records)
    log.warning("wal %s: %s at offset %d — %d byte(s) quarantined to %s",
                path, damage, clean, len(tail), cpath.name)
    return records, {"damage": damage, "quarantined_bytes": len(tail),
                     "quarantine": str(cpath)}


def log_mutation(root, op: str, payload: dict, *, base_seq: int | None = None,
                 registry=None) -> int:
    """Durably record one mutation BEFORE its manifest swap; returns
    the record's seq.  Caller holds the mutation lock.  The record is
    fsync'd before this returns — the ack-ordering contract ("acked
    means durable") rests on exactly that fsync.

    The ``wal-torn-record`` fault tears the just-written record and
    raises before the fsync: the mutation then fails un-acked, and the
    next :func:`read_records` quarantines the torn tail.
    """
    records, _info = read_records(root)
    if base_seq is None:
        man = load_manifest(root)
        base_seq = 0 if man is None else man.wal_seq
    last = int(records[-1]["seq"]) if records else 0
    seq = max(int(base_seq), last) + 1
    rec = {"seq": seq, "op": op, **payload}
    path = wal_path(root)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        if os.fstat(fd).st_size == 0:
            os.write(fd, WAL_MAGIC)
        os.write(fd, _encode_record(rec))
        inj = faults.active()
        if inj is not None:
            inj.on_wal_append(str(path))
        os.fsync(fd)
    except faults.InjectedWalTorn as e:
        # surface as the usual SegmentError family: the mutation fails
        # un-acked and the torn tail is quarantined on the next read
        raise WalError(str(e)) from e
    finally:
        os.close(fd)
    reg = registry if registry is not None \
        else obs_metrics.default_registry()
    reg.counter("mri_wal_records_total").inc()
    return seq


def tail(root, after_seq: int) -> list[dict]:
    """Records with ``seq > after_seq`` — the replica catch-up feed
    (acked-but-unpublished mutations the manifest swap hasn't covered)."""
    records, _info = read_records(root)
    return [r for r in records if int(r["seq"]) > int(after_seq)]


def append_tail(root, records: list[dict]) -> int:
    """Adopt a primary's WAL tail on a replica: append every record
    with a seq above both the local stamp and the local log's last
    record.  Returns the number adopted.  Caller holds no lock (the
    replica is single-owner during catch-up)."""
    local, _info = read_records(root)
    man = load_manifest(root)
    floor = max(0 if man is None else man.wal_seq,
                int(local[-1]["seq"]) if local else 0)
    fresh = [r for r in sorted(records, key=lambda r: int(r["seq"]))
             if int(r["seq"]) > floor]
    if fresh:
        _rewrite(root, local + fresh)
    return len(fresh)


def discard(root, seq: int) -> None:
    """Drop one record after its mutation was *explicitly rejected*
    (e.g. a torn publish): the caller reports failure to the client,
    so replaying the record later would resurrect a mutation the
    client was told did not happen.  A genuine crash (no rejection
    reported, no ack either) keeps its record — at-least-once replay
    of an un-acked mutation is the standard WAL trade."""
    records, _info = read_records(root)
    keep = [r for r in records if int(r["seq"]) != int(seq)]
    if len(keep) != len(records):
        _rewrite(root, keep)


def truncate_published(root) -> int:
    """Drop records the current manifest already covers (``seq <=
    wal_seq``); returns how many were dropped.  Runs after every
    publish so the log only ever holds the unpublished suffix."""
    man = load_manifest(root)
    if man is None:
        return 0
    records, _info = read_records(root)
    keep = [r for r in records if int(r["seq"]) > man.wal_seq]
    if len(keep) != len(records):
        _rewrite(root, keep)
    return len(records) - len(keep)


def _sweep_scratch(root, man: SegmentManifest | None) -> list[str]:
    """Remove build/fetch staging and unreferenced segment dirs —
    recovery runs with no live readers, so a crashed mutation's
    orphans (including a replayed append's half-built twin) go."""
    removed: list[str] = []
    base = segments_root(root)
    if not base.is_dir():
        return removed
    keep = set() if man is None else {e.name for e in man.entries}
    for child in sorted(base.iterdir()):
        if not child.is_dir():
            continue
        if child.name.startswith((".build_", ".fetch_")) \
                or child.name not in keep:
            shutil.rmtree(child, ignore_errors=True)
            removed.append(child.name)
    return removed


def _stamp(root, seq: int) -> None:
    """Advance ``wal_seq`` on the live manifest without any other
    change — covers replayed records whose re-application was a no-op
    (an idempotent delete, a compact that found nothing to merge)."""
    with mutation_lock(root):
        man = load_manifest(root)
        if man is None:
            man = SegmentManifest(generation=0, next_seg=0, entries=())
        if man.wal_seq >= seq:
            return
        save_manifest(root, dataclasses.replace(man, wal_seq=seq),
                      op="recover")


def replay(root, *, registry=None) -> dict:
    """Roll the directory forward to the last acked mutation.

    Quarantines any torn tail, sweeps crashed-mutation scratch, then
    re-applies every record above the manifest's ``wal_seq`` stamp in
    seq order: appends re-run the segment build from the recorded
    source paths, deletes re-set tombstone bits (idempotent), compacts
    re-merge.  Each replayed record's publish stamps the manifest, and
    the log is truncated back to the unpublished suffix at the end —
    replay of an already-consistent directory is a no-op.
    """
    from . import compactor as compactor_mod
    from . import writer as writer_mod

    records, info = read_records(root)
    man = load_manifest(root)
    swept = _sweep_scratch(root, man)
    covered = 0 if man is None else man.wal_seq
    replayed = skipped = 0
    reg = registry if registry is not None \
        else obs_metrics.default_registry()
    for rec in sorted(records, key=lambda r: int(r["seq"])):
        seq = int(rec["seq"])
        if seq <= covered:
            skipped += 1
            continue
        op = rec["op"]
        if op == "append":
            writer_mod.append_files(root, rec["files"],
                                    registry=registry, wal_seq=seq)
        elif op == "delete":
            writer_mod.delete_docs(root, rec["docs"],
                                   registry=registry, wal_seq=seq)
        else:
            compactor_mod.compact(root, force=bool(rec.get("force", True)),
                                  registry=registry, wal_seq=seq)
        man = load_manifest(root)
        if man is None or man.wal_seq < seq:
            _stamp(root, seq)
        covered = seq
        replayed += 1
        reg.counter("mri_wal_replayed_total").inc()
    dropped = truncate_published(root)
    man = load_manifest(root)
    out = {
        "generation": 0 if man is None else man.generation,
        "wal_seq": 0 if man is None else man.wal_seq,
        "replayed": replayed,
        "skipped": skipped,
        "truncated": dropped,
        "swept": swept,
    }
    if info:
        out["quarantined_bytes"] = info.get("quarantined_bytes", 0)
        out["damage"] = info.get("damage")
    if replayed or swept or info:
        log.info("wal recovery: %s", out)
    return out


def recover(root, *, registry=None) -> dict:
    """``recover DIR`` / daemon-start entry point: :func:`replay`
    when the directory is (or may become) segment-managed; a directory
    with neither manifest nor WAL is reported untouched."""
    if load_manifest(root) is None and not wal_path(root).exists():
        return {"generation": 0, "wal_seq": 0, "replayed": 0,
                "skipped": 0, "truncated": 0, "swept": [],
                "segmented": False}
    out = replay(root, registry=registry)
    out["segmented"] = True
    return out
