"""Background compaction: k-way merge of the smallest adjacent segments.

Compaction bounds segment fan-out (every query costs one probe per
segment) and is the point where tombstoned documents finally leave the
index.  It picks the ADJACENT run of segments with the smallest total
artifact bytes — adjacency keeps the global doc-id order equal to the
manifest's concatenation order, the invariant the multi-segment merge
relies on — decodes their postings, drops tombstoned docs, and packs
ONE replacement segment via the same ``serve.artifact`` packer every
build uses.  Global doc ids are preserved: the merged segment keeps
the first input's ``doc_base`` and re-bases locals without renumbering,
so compaction is invisible to queries (byte-identical answers before
and after, minus nothing — deletes were already filtered).

Each round folds a bounded number of sorted runs, and repeated rounds
converge the segment count under ``MRI_SEGMENT_MAX_SEGMENTS``.  The
merge is the JAX package's per-term loop over decoded postings, on the
host.

Crash safety is the manifest discipline: the replacement segment is
fully built and checksummed before the generation swap; a crash at any
earlier point (including the injected ``compact-crash`` fault) leaves
the old generation serving and at worst an orphan directory no
manifest references.  Inputs are retired from the manifest but their
directories are kept on disk — concurrent readers of an older
generation may still be mapping them; ``prune_retired`` removes
anything the current generation no longer names.
"""

from __future__ import annotations

import logging
import shutil
import time

import numpy as np

from . import tombstones as tomb_mod
from . import wal as wal_mod
from .manifest import (SegmentEntry, SegmentError, SegmentManifest,
                       load_manifest, mutation_lock, save_manifest,
                       segment_dir, segments_root)
from .. import faults
from ..obs import metrics as obs_metrics
from ..serve import artifact as artifact_mod
from ..utils import envknobs

log = logging.getLogger("mri_torch.segments")

TRIGGER_ENV = "MRI_SEGMENT_COMPACT_TRIGGER"
MAX_SEGMENTS_ENV = "MRI_SEGMENT_MAX_SEGMENTS"


def should_compact(man: SegmentManifest) -> bool:
    """The auto-compaction trigger: at or past the knob's segment
    count (``MRI_SEGMENT_COMPACT_TRIGGER``)."""
    return len(man.entries) >= envknobs.get(TRIGGER_ENV)


def _pick_run(entries: tuple[SegmentEntry, ...]) -> tuple[int, int]:
    """``(start, stop)`` of the adjacent run to merge: the cheapest
    window of ``min(trigger, len)`` consecutive segments by total
    artifact bytes (the "smallest segments" rule, kept adjacent)."""
    k = min(max(envknobs.get(TRIGGER_ENV), 2), len(entries))
    sizes = [e.bytes for e in entries]
    best, best_at = None, 0
    for i in range(len(entries) - k + 1):
        w = sum(sizes[i:i + k])
        if best is None or w < best:
            best, best_at = w, i
    return best_at, best_at + k


def _merge_segments(root, picked: list[SegmentEntry], *, name: str
                    ) -> tuple[str, int, int, int]:
    """Decode the picked segments, drop tombstones, pack the merged
    replacement.  Returns ``(adler32, bytes, docs_span, dropped)``."""
    new_base = picked[0].doc_base
    span = picked[-1].doc_base + picked[-1].docs - new_base
    doc_lens = np.zeros(span + 1, dtype=np.int64)
    terms: dict[bytes, list] = {}
    dropped = 0
    for e in picked:
        seg = segment_dir(root, e.name)
        off = e.doc_base - new_base
        bits = None
        if e.tombstones is not None and e.tomb_count:
            bits = tomb_mod.load(seg / e.tombstones, ndocs=e.docs)
            dropped += int(bits.sum())
        with artifact_mod.load_artifact(seg) as art:
            dl = artifact_mod.bm25_corpus(art)[0].astype(np.int64)
            # skip the local pad slot dl[0]: global index ``off`` is the
            # previous segment's last doc, not this segment's
            n = min(len(dl), e.docs + 1)
            doc_lens[off + 1:off + n] = dl[1:n]
            if bits is not None:
                doc_lens[off + np.nonzero(bits)[0] + 1] = 0
            for t in range(art.vocab):
                docs = art.decode_postings(t).astype(np.int64)
                if bits is not None:
                    live = ~bits[docs - 1]
                    if not live.all():
                        tf = art.decode_tf(t).astype(np.int64)[live]
                        docs = docs[live]
                    else:
                        tf = art.decode_tf(t).astype(np.int64)
                else:
                    tf = art.decode_tf(t).astype(np.int64)
                if len(docs):
                    terms.setdefault(art.term(t), []).append(
                        (docs + off, tf))
    words = sorted(terms)
    blob = b"".join(words)
    term_offsets = np.zeros(len(words) + 1, dtype=np.int64)
    np.cumsum([len(w) for w in words], out=term_offsets[1:])
    df = np.zeros(len(words), dtype=np.int64)
    doc_parts: list[np.ndarray] = []
    tf_parts: list[np.ndarray] = []
    for i, w in enumerate(words):
        runs = terms[w]
        # inputs are doc_base-ordered and locally ascending, so plain
        # concatenation is already globally sorted per term
        doc_parts.extend(r[0] for r in runs)
        tf_parts.extend(r[1] for r in runs)
        df[i] = sum(len(r[0]) for r in runs)
    post_offsets = np.zeros(len(words) + 1, dtype=np.int64)
    np.cumsum(df, out=post_offsets[1:])
    postings = (np.concatenate(doc_parts) if doc_parts
                else np.zeros(0, dtype=np.int64))
    tf = (np.concatenate(tf_parts) if tf_parts
          else np.zeros(0, dtype=np.int64))
    letters = (np.frombuffer(blob, dtype=np.uint8)[term_offsets[:-1]]
               if words else np.zeros(0, dtype=np.uint8))
    # emit order: letter asc, df desc, word asc (lexsort is stable, so
    # equal (letter, df) keys keep ascending lex-index == word order)
    df_order = np.lexsort((-df, letters)).astype(np.int32)
    seg = segment_dir(root, name)
    seg.mkdir(parents=True, exist_ok=True)
    dst = seg / artifact_mod.ARTIFACT_NAME
    artifact_mod.pack(
        dst, term_blob=np.frombuffer(blob, dtype=np.uint8),
        term_offsets=term_offsets, df=df, post_offsets=post_offsets,
        postings=postings, df_order=df_order, max_doc_id=span,
        tf=tf, doc_lens=doc_lens)
    crc, size = artifact_mod.checksum(dst)
    return crc, size, span, dropped


def compact(root, *, force: bool = False, registry=None,
            wal_seq=None) -> dict:
    """One compaction round; publishes the next generation.

    Below the ``MRI_SEGMENT_COMPACT_TRIGGER`` segment count this is a
    counted no-op unless ``force`` — background callers can invoke it
    unconditionally and let the trigger decide.  ``wal_seq`` marks the
    recovery re-application of an already logged record.
    """
    t0 = time.perf_counter()
    with mutation_lock(root):
        man = load_manifest(root)
        if man is None or len(man.entries) < 2:
            return {"compacted": False,
                    "reason": "fewer than two segments",
                    "generation": 0 if man is None else man.generation,
                    "segments": 0 if man is None else len(man.entries)}
        if not force and not should_compact(man):
            return {"compacted": False,
                    "reason": f"below trigger "
                              f"({envknobs.get(TRIGGER_ENV)} segments)",
                    "generation": man.generation,
                    "segments": len(man.entries)}
        seq = wal_seq
        if seq is None and wal_mod.wal_enabled():
            # logged before the merge: a SIGKILL anywhere inside the
            # merge window replays the whole round on recovery
            seq = wal_mod.log_mutation(root, "compact",
                                       {"force": bool(force)},
                                       base_seq=man.wal_seq,
                                       registry=registry)
        start, stop = _pick_run(man.entries)
        picked = list(man.entries[start:stop])
        gen = man.generation + 1
        name = f"seg_{gen}_{man.next_seg}"
        try:
            crc, size, span, dropped = _merge_segments(
                root, picked, name=name)
            inj = faults.active()
            if inj is not None:
                # the injected mid-compaction crash: replacement built
                # but never published — old generation keeps serving,
                # the orphan directory is exactly what a real crash
                # leaves
                inj.on_compact()
            merged = SegmentEntry(name=name, doc_base=picked[0].doc_base,
                                  docs=span, adler32=crc, bytes=size)
            new = SegmentManifest(
                generation=gen, next_seg=man.next_seg + 1,
                entries=man.entries[:start] + (merged,)
                + man.entries[stop:],
                wal_seq=man.wal_seq if seq is None else seq)
            save_manifest(root, new, op="compact")
        except (SegmentError, faults.InjectedCompactCrash):
            # rejected to the caller: replay must not redo this round
            if seq is not None and wal_seq is None:
                wal_mod.discard(root, seq)
            raise
        if seq is not None:
            wal_mod.truncate_published(root)
    dt = time.perf_counter() - t0
    reg = registry if registry is not None \
        else obs_metrics.default_registry()
    reg.counter("mri_compactions_total").inc()
    reg.gauge("mri_generation").set(new.generation)
    reg.gauge("mri_segments_active").set(len(new.entries))
    reg.gauge("mri_tombstoned_docs").set(
        sum(e.tomb_count for e in new.entries))
    log.info("compacted %d segments into %s (%d tombstones dropped, "
             "%.1f ms)", len(picked), name, dropped, dt * 1e3)
    return {"compacted": True, "generation": new.generation,
            "segment": name, "inputs": [e.name for e in picked],
            "tombstones_dropped": dropped,
            "segments": len(new.entries), "bytes": size,
            "compact_ms": round(dt * 1e3, 3)}


def compact_to_limit(root, *, registry=None) -> list[dict]:
    """Repeat single rounds until the segment count is at or under
    ``MRI_SEGMENT_MAX_SEGMENTS`` (the append path's backstop)."""
    limit = envknobs.get(MAX_SEGMENTS_ENV)
    out: list[dict] = []
    while True:
        man = load_manifest(root)
        if man is None or len(man.entries) <= max(limit, 1):
            return out
        res = compact(root, force=True, registry=registry)
        out.append(res)
        if not res.get("compacted"):
            return out


def prune_retired(root) -> list[str]:
    """Remove segment directories the CURRENT manifest no longer
    references (retired compaction inputs, orphaned staging).  Safe
    only when no reader is still serving an older generation — an
    explicit operator action, never automatic."""
    with mutation_lock(root):
        man = load_manifest(root)
        if man is None:
            return []
        keep = {e.name for e in man.entries}
        removed = []
        base = segments_root(root)
        if base.is_dir():
            for child in sorted(base.iterdir()):
                if child.is_dir() and child.name not in keep:
                    shutil.rmtree(child, ignore_errors=True)
                    removed.append(child.name)
    return removed
