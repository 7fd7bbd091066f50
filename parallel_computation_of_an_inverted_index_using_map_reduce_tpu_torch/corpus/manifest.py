"""Corpus manifest: the input-list format and doc-id assignment.

Reference behavior being reproduced (main.c:257-298):

- list file format: first line = file count, then one path per line,
  resolved relative to the current working directory
- doc ids are the **1-based position in the list** (assigned in read order
  at main.c:275, emitted as ``id + 1`` at main.c:116)
- each file is ``stat``-ed for its size (main.c:289-296); a missing file
  gets a warning and size 0 but stays in the manifest
- an unreadable file at map time is warned about and skipped
  (main.c:97-100) — here each read first retries under the build's
  :class:`faults.RetryPolicy` (honouring an armed fault injector), a
  document that stays unreadable is recorded in the run's
  :class:`faults.DegradationReport`, and the CLI exits 3 when any was
  skipped
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path

from .. import faults
from ..faults import DegradationReport

log = logging.getLogger("mri_torch.corpus")


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Ordered corpus file list.  ``doc_id`` of ``paths[i]`` is ``i + 1``."""

    paths: tuple[str, ...]
    sizes: tuple[int, ...]

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def total_bytes(self) -> int:
        return sum(self.sizes)

    def doc_id(self, index: int) -> int:
        return index + 1

    def read_doc(self, index: int) -> bytes:
        """Document bytes; raises OSError for an unreadable file."""
        with open(self.paths[index], "rb") as f:
            return f.read()

    def read_doc_into(self, index: int, dest) -> int:
        """``readinto`` fast path: document bytes straight into a
        caller-owned buffer (an io.arena.WindowArena view) — no bytes
        object, no copy.  Returns the byte count actually read; a file
        shorter than ``dest`` (shrunk since the manifest was written)
        gives a short count, a longer one is truncated to ``dest``
        (manifest sizes are authoritative for window planning).  Raises
        OSError like :meth:`read_doc`."""
        mv = memoryview(dest)
        total = 0
        with open(self.paths[index], "rb") as f:
            while total < len(mv):
                n = f.readinto(mv[total:])
                if not n:
                    break
                total += n
        return total


def _stat_sizes(paths) -> tuple[int, ...]:
    """Sizes for a path list; unstat-able files keep size 0 (reference
    main.c:289-296 keeps them in the manifest), reported in one line."""
    sizes = []
    missing: list[str] = []
    for p in paths:
        try:
            sizes.append(os.stat(p).st_size)
        except OSError:
            missing.append(p)
            sizes.append(0)
    if missing:
        shown = ", ".join(repr(p) for p in missing[:3])
        more = f" (+{len(missing) - 3} more)" if len(missing) > 3 else ""
        log.warning("cannot stat %d file(s); keeping them with size 0: "
                    "%s%s", len(missing), shown, more)
    return tuple(sizes)


def read_manifest(list_path: str | Path, base_dir: str | Path | None = None) -> Manifest:
    """Read a count-header file list.

    ``base_dir`` defaults to the CWD, matching the reference, which opens
    manifest paths relative to wherever it was launched.
    """
    base = Path(base_dir) if base_dir is not None else Path.cwd()
    with open(list_path, "r", encoding="utf-8") as f:
        tokens = f.read().split()
    if not tokens:
        raise ValueError(f"empty manifest {list_path!r}")
    try:
        count = int(tokens[0])
    except ValueError as e:
        raise ValueError(f"manifest {list_path!r} must start with a file count") from e
    names = tokens[1 : 1 + count]
    if len(names) < count:
        raise ValueError(
            f"manifest {list_path!r} declares {count} files but lists {len(names)}"
        )
    paths = tuple(str(p) if os.path.isabs(p) else str(base / p) for p in names)
    return Manifest(paths=paths, sizes=_stat_sizes(paths))


def write_manifest(manifest_path: str | Path, paths: list[str]) -> None:
    """Write a file list in the reference's count-header format."""
    with open(manifest_path, "w", encoding="utf-8") as f:
        f.write(f"{len(paths)}\n")
        for p in paths:
            f.write(f"{p}\n")


def manifest_from_dir(corpus_dir: str | Path, pattern: str = "**/*.txt") -> Manifest:
    """Build a manifest by sorted recursive glob (the doc-id assignment
    of the reference baseline run: a sorted file list)."""
    root = Path(corpus_dir)
    paths = sorted(str(p) for p in root.glob(pattern) if p.is_file())
    if not paths:
        raise ValueError(f"no files matching {pattern!r} under {corpus_dir!r}")
    return Manifest(paths=tuple(paths), sizes=_stat_sizes(paths))


def _read_doc_resilient(manifest: Manifest, i: int, policy, report):
    """One document read under the build's retry policy, honouring any
    armed fault injector (faults.py).  Returns bytes, or None when the
    document stays unreadable (recorded as a skip in ``report``)."""

    def attempt() -> bytes:
        inj = faults.active()
        cap = None
        if inj is not None:
            cap = inj.on_read(i, manifest.paths[i])
        data = manifest.read_doc(i)
        return data if cap is None else data[:cap]

    try:
        return policy.run(attempt, doc_id=manifest.doc_id(i),
                          path=manifest.paths[i], report=report)
    except OSError as e:
        report.record_skip(doc_id=manifest.doc_id(i),
                           path=manifest.paths[i], reason=str(e))
        return None


def iter_document_ranges(manifest: Manifest, ranges,
                         report: DegradationReport | None = None, *, policy=None):
    """Yield ``(contents, doc_ids)`` for each ``[lo, hi)`` doc range.

    Each read retries per ``policy`` (default: the env-tuned build
    policy, faults.RetryPolicy); a persistently unreadable file is
    skipped inside its range (reference main.c:97-100) — its doc id
    never appears in any postings list — recorded in ``report``
    (default: the run's, faults.current_report), and summarized in one
    warning line per range.
    """
    if policy is None:
        policy = faults.default_policy()
    if report is None:
        report = faults.current_report()
    for lo, hi in ranges:
        contents: list[bytes] = []
        doc_ids: list[int] = []
        skipped = 0
        for i in range(lo, hi):
            data = _read_doc_resilient(manifest, i, policy, report)
            if data is None:
                skipped += 1
                continue
            contents.append(data)
            doc_ids.append(manifest.doc_id(i))
        if skipped:
            log.warning("skipped %d unreadable document(s) in window "
                        "[%d, %d) after retries", skipped, lo, hi)
        yield contents, doc_ids


def iter_document_chunks(manifest: Manifest, chunk_docs: int,
                         report: DegradationReport | None = None):
    """Yield ``(contents, doc_ids)`` windows of at most ``chunk_docs``
    whole documents, in manifest order — the streaming loader (host
    memory stays O(chunk)).  Skips are recorded in ``report`` as in
    :func:`iter_document_ranges`."""
    if chunk_docs < 1:
        raise ValueError(f"chunk_docs must be >= 1, got {chunk_docs}")
    n = len(manifest)
    yield from iter_document_ranges(
        manifest,
        ((s, min(s + chunk_docs, n)) for s in range(0, n, chunk_docs)),
        report)


def prefetch_document_ranges(manifest: Manifest, ranges,
                             report: DegradationReport | None = None, depth: int = 1,
                             read_ms: list | None = None):
    """:func:`iter_document_ranges` with a reader thread ``depth``
    ranges ahead.

    The native scan releases the GIL, so the next window's file reads
    overlap the current window's scan — the reference reads and scans
    serially per mapper (main.c:97-116).  Reader exceptions re-raise in
    the consumer.  ``read_ms``, when given, receives each range's read
    time on the reader thread."""
    import queue
    import threading
    import time

    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that gives up when the consumer is gone, so an
        # abandoned generator (a feed error mid-loop) cannot leave the
        # reader blocked forever holding window buffers
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            items = iter_document_ranges(manifest, ranges, report)
            while True:
                t0 = time.perf_counter()
                item = next(items, done)
                if read_ms is not None and item is not done:
                    read_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
                if not _put(item) or item is done:
                    return
        except BaseException as e:  # surfaced on the consumer side
            _put(e)

    threading.Thread(target=reader, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def load_documents(manifest: Manifest, report: DegradationReport | None = None
                   ) -> tuple[list[bytes], list[int]]:
    """Read every manifest file, preserving doc ids for readable files
    (unreadable ones are skipped and recorded, as in
    :func:`iter_document_ranges`)."""
    (contents, doc_ids), = iter_document_ranges(manifest, [(0, len(manifest))], report)
    return contents, doc_ids


def load_documents_arena(manifest: Manifest, arena=None,
                         report: DegradationReport | None = None):
    """Zero-copy :func:`load_documents`: every readable document lands in
    one reusable io.arena.WindowArena (``readinto``, no per-doc bytes
    objects) sized upfront from the manifest.  Returns the filled arena;
    unreadable files are skipped and recorded, same contract as
    :func:`load_documents`."""
    from ..io.arena import WindowArena
    from ..io.reader import read_window_into

    if arena is None:
        arena = WindowArena(byte_capacity=max(manifest.total_bytes, 1),
                            doc_capacity=max(len(manifest), 1))
    return read_window_into(manifest, 0, len(manifest), arena, report=report)
