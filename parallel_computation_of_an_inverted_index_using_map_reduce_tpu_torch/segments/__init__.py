"""Incremental indexing: segment manifests, tombstones, the mutation
WAL, compaction and replication (the JAX package's ``segments/``, with
the same directory formats: a directory either package writes, the
other reads, and one mutation sequence gives byte-equal files in both).

The host backend's batch build makes each segment; this package
adds the live layer on top — generation-numbered manifests of immutable
segments (:mod:`.manifest`), append/delete mutations (:mod:`.writer`),
per-segment tombstone bitmaps (:mod:`.tombstones`), and background
compaction (:mod:`.compactor`), the write-ahead log (:mod:`.wal`) and
primary-to-replica segment shipping with its lease (:mod:`.replica`).  The query-side merge lives in
``serve.multi_engine`` so serving has no hard dependency on the build
stack.
"""

from .compactor import (compact, compact_to_limit, prune_retired,
                        should_compact)
from .manifest import (LOCK_NAME, MANIFEST_NAME, SEGMENTS_DIR,
                       SegmentEntry, SegmentError, SegmentManifest,
                       is_segmented, load_manifest, manifest_path,
                       mutation_lock, save_manifest, segment_dir,
                       segments_root)
from .replica import (LeaseError, ReplicaError, read_lease,
                      release_lease, renew_lease, replicate)
from .tombstones import empty_bitmap, tombstone_name
from .wal import WAL_NAME, WalError, recover, replay, wal_path
from .writer import append_files, delete_docs

__all__ = [
    "LOCK_NAME", "MANIFEST_NAME", "SEGMENTS_DIR", "WAL_NAME",
    "LeaseError", "ReplicaError", "SegmentEntry", "SegmentError",
    "SegmentManifest", "WalError",
    "append_files", "compact", "compact_to_limit", "delete_docs",
    "empty_bitmap", "is_segmented", "load_manifest", "manifest_path",
    "mutation_lock", "prune_retired", "read_lease", "recover",
    "release_lease", "renew_lease", "replay", "replicate",
    "save_manifest", "segment_dir", "segments_root", "should_compact",
    "tombstone_name", "wal_path",
]
