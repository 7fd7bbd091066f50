"""Segment building: live append and delete for an index directory.

``append_files`` turns one batch of corpus files into a small immutable
segment — built by the host backend's ``--artifact`` export
(``IndexConfig(backend="cpu", artifact=True)``, as the JAX package
builds it) (real term frequencies and document lengths, so BM25 over
segments stays bit-identical to a from-scratch build) — and publishes
it under a new manifest generation.  ``delete_docs`` flips tombstone
bits in generation-tagged sidecar bitmaps and publishes the result the
same way.  Neither ever modifies a published file in place; the
manifest rename is the only visible state change, and a crash at any
point leaves the previous generation fully intact (at worst plus an
orphan staging directory no manifest references).
"""

from __future__ import annotations

import logging
import os
import shutil

import numpy as np

from . import tombstones as tomb_mod
from . import wal as wal_mod
from .manifest import (SegmentEntry, SegmentError, SegmentManifest,
                       load_manifest, manifest_path, mutation_lock,
                       save_manifest, segment_dir, segments_root)
from ..obs import metrics as obs_metrics
from ..serve import artifact as artifact_mod

log = logging.getLogger("mri_torch.segments")


def _load_or_seed(root) -> SegmentManifest:
    """The current manifest; first mutation of a directory seeds one.

    A directory holding a batch-built ``index.mri`` becomes generation
    1 with that artifact copied in as segment 0 (``doc_base`` 0, so
    every existing doc id is unchanged); a fresh directory starts
    empty at generation 0.  Caller holds the mutation lock.
    """
    man = load_manifest(root)
    if man is not None:
        return man
    src = artifact_mod.artifact_path(root)
    if not src.exists():
        return SegmentManifest(generation=0, next_seg=0, entries=())
    with artifact_mod.load_artifact(src) as art:
        docs = int(art.max_doc_id)
    name = "seg_1_0"
    seg = segment_dir(root, name)
    seg.mkdir(parents=True, exist_ok=True)
    dst = seg / artifact_mod.ARTIFACT_NAME
    tmp = dst.with_name(dst.name + ".tmp")
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)
    crc, size = artifact_mod.checksum(dst)
    man = SegmentManifest(
        generation=1, next_seg=1,
        entries=(SegmentEntry(name=name, doc_base=0, docs=docs,
                              adler32=crc, bytes=size),))
    save_manifest(root, man, op="seed")
    log.info("seeded segment manifest from existing artifact "
             "(%d docs, generation 1)", docs)
    return man


def _build_segment_artifact(root, files: list[str], *, name: str) -> tuple:
    """Run the existing ``--artifact`` batch build over ``files`` into
    a staging dir and move the packed ``index.mri`` into the segment
    directory.  Returns ``(adler32, bytes, docs)``."""
    from ..config import IndexConfig
    from ..corpus.manifest import Manifest, _stat_sizes
    from ..models.inverted_index import InvertedIndexModel

    paths = tuple(str(p) for p in files)
    corpus = Manifest(paths=paths, sizes=_stat_sizes(paths))
    stage = segments_root(root) / f".build_{name}"
    if stage.exists():
        shutil.rmtree(stage)
    stage.mkdir(parents=True)
    try:
        cfg = IndexConfig(backend="cpu", output_dir=str(stage),
                          artifact=True)
        InvertedIndexModel(cfg).run(corpus)
        built = artifact_mod.artifact_path(stage)
        seg = segment_dir(root, name)
        seg.mkdir(parents=True, exist_ok=True)
        dst = seg / artifact_mod.ARTIFACT_NAME
        os.replace(built, dst)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    crc, size = artifact_mod.checksum(dst)
    return crc, size, len(paths)


def append_files(root, files, *, registry=None, wal_seq=None) -> dict:
    """Append a batch of corpus files as one new immutable segment and
    publish the next manifest generation.  Global doc ids continue
    densely from the current span; returns the assignment.

    ``wal_seq`` is the recovery path only: replay re-runs an already
    logged record, so no new record is written and the manifest is
    stamped with the replayed seq.
    """
    files = [str(f) for f in files]
    if not files:
        raise SegmentError("append needs at least one file")
    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        raise SegmentError(f"append: no such file(s): {missing}")
    with mutation_lock(root):
        man = _load_or_seed(root)
        seq = wal_seq
        if seq is None and wal_mod.wal_enabled():
            # the durability point: the record is fsync'd before any
            # segment bytes exist, so a crash anywhere past here
            # replays instead of losing the acked mutation
            seq = wal_mod.log_mutation(root, "append", {"files": files},
                                       base_seq=man.wal_seq,
                                       registry=registry)
        gen = man.generation + 1
        name = f"seg_{gen}_{man.next_seg}"
        doc_base = man.doc_span
        crc, size, docs = _build_segment_artifact(root, files, name=name)
        entry = SegmentEntry(name=name, doc_base=doc_base, docs=docs,
                             adler32=crc, bytes=size)
        new = SegmentManifest(generation=gen, next_seg=man.next_seg + 1,
                              entries=man.entries + (entry,),
                              wal_seq=man.wal_seq if seq is None else seq)
        try:
            save_manifest(root, new, op="append")
        except SegmentError:
            # injected/real publish failure: retire the orphan segment
            # so --verify of the surviving generation stays clean, and
            # drop the WAL record — this mutation is REJECTED to the
            # caller, so replay must never resurrect it
            shutil.rmtree(segment_dir(root, name), ignore_errors=True)
            if seq is not None and wal_seq is None:
                wal_mod.discard(root, seq)
            raise
        if seq is not None:
            wal_mod.truncate_published(root)
    reg = registry if registry is not None \
        else obs_metrics.default_registry()
    reg.gauge("mri_generation").set(new.generation)
    reg.gauge("mri_segments_active").set(len(new.entries))
    return {"generation": new.generation, "segment": name,
            "doc_base": doc_base, "docs": docs,
            "doc_ids": [doc_base + i for i in range(1, docs + 1)],
            "segments": len(new.entries)}


def _entry_for(man: SegmentManifest, gid: int) -> SegmentEntry:
    for e in man.entries:
        if e.doc_base < gid <= e.doc_base + e.docs:
            return e
    raise SegmentError(
        f"doc id {gid} is outside every segment "
        f"(live span is 1..{man.doc_span})")


def delete_docs(root, doc_ids, *, registry=None, wal_seq=None) -> dict:
    """Tombstone global doc ids and publish the next generation.

    Idempotent per id (re-deleting is a no-op bit set); an id outside
    every segment's range is an error.  The artifact files are never
    touched — only new generation-tagged bitmap sidecars appear.
    ``wal_seq`` marks the recovery re-application of an already logged
    record (no new record, manifest stamped with the replayed seq).
    """
    ids = sorted({int(d) for d in doc_ids})
    if not ids:
        raise SegmentError("delete needs at least one doc id")
    with mutation_lock(root):
        man = _load_or_seed(root)
        if not man.entries:
            raise SegmentError(
                f"{manifest_path(root)}: nothing indexed yet")
        seq = wal_seq
        if seq is None and wal_mod.wal_enabled():
            seq = wal_mod.log_mutation(root, "delete", {"docs": ids},
                                       base_seq=man.wal_seq,
                                       registry=registry)
        gen = man.generation + 1
        try:
            per: dict[str, list[int]] = {}
            by_name = {e.name: e for e in man.entries}
            for gid in ids:
                e = _entry_for(man, gid)
                per.setdefault(e.name, []).append(gid - e.doc_base)
            entries = []
            newly = 0
            for e in man.entries:
                locals_ = per.get(e.name)
                if not locals_:
                    entries.append(e)
                    continue
                seg = segment_dir(root, e.name)
                if e.tombstones is not None:
                    bits = tomb_mod.load(seg / e.tombstones, ndocs=e.docs)
                else:
                    bits = tomb_mod.empty_bitmap(e.docs)
                before = int(bits.sum())
                bits[np.asarray(locals_, dtype=np.int64) - 1] = True
                count = int(bits.sum())
                newly += count - before
                tname = tomb_mod.tombstone_name(gen)
                crc, size = tomb_mod.save(seg / tname, bits)
                entries.append(SegmentEntry(
                    name=e.name, doc_base=e.doc_base, docs=e.docs,
                    adler32=e.adler32, bytes=e.bytes, tombstones=tname,
                    tomb_adler32=crc, tomb_bytes=size, tomb_count=count))
            new = SegmentManifest(generation=gen, next_seg=man.next_seg,
                                  entries=tuple(entries),
                                  wal_seq=man.wal_seq if seq is None
                                  else seq)
            save_manifest(root, new, op="delete")
        except SegmentError:
            # rejected to the caller (bad id, torn bitmap, torn
            # publish): replay must never resurrect this record
            if seq is not None and wal_seq is None:
                wal_mod.discard(root, seq)
            raise
        if seq is not None:
            wal_mod.truncate_published(root)
    total = sum(e.tomb_count for e in new.entries)
    reg = registry if registry is not None \
        else obs_metrics.default_registry()
    reg.gauge("mri_generation").set(new.generation)
    reg.gauge("mri_tombstoned_docs").set(total)
    return {"generation": new.generation, "deleted": ids,
            "newly_tombstoned": newly, "tombstoned_total": total,
            "segments": len(new.entries)}
