"""Zero-copy manifest readers.

``read_doc_into`` is the single dispatch point between real-file
manifests (which gain a ``readinto`` fast path writing straight into an
arena) and the virtual corpus manifests (`corpus.synthetic`), which
are duck types whose ``read_doc`` generates bytes — those fall back to
one copy into the arena, still skipping the join/marshal copies
downstream.  A virtual manifest's ``sizes`` are estimates (the mean
document size), so :func:`read_window_into` sizes its arena view from
the generated bytes: a document is never cut to the estimate.  (The
JAX package's reader cuts it, so its host backend indexes truncated
documents of a virtual corpus; ROADMAP §C.)

Failure semantics (faults.py): every document read runs under the
pipeline :class:`~..faults.RetryPolicy` — transient OSErrors are
retried with backoff inside a per-document deadline, and only a
*persistent* failure degrades the run by skipping the document, which
is recorded (doc id, path, reason) in the active
:class:`~..faults.DegradationReport` instead of being a lone stderr
line the caller can't act on.
"""

from __future__ import annotations

import logging

from .. import faults
from .arena import WindowArena

log = logging.getLogger("mri_torch.io")


def read_doc_into(manifest, index: int, dest: memoryview) -> int:
    """Read document ``index`` into ``dest``; bytes actually written.

    Dispatches to ``manifest.read_doc_into`` when the manifest offers
    one (real files, ``readinto``), else copies ``read_doc()`` output.
    ``dest`` is sized from the manifest's recorded document size; a
    document that shrank since the manifest was written yields a short
    count, one that grew is truncated to the recorded size (manifest
    sizes are authoritative for window planning).
    """
    inj = faults.active()
    cap = None
    if inj is not None:
        cap = inj.on_read(index, manifest.paths[index])
    fast = getattr(manifest, "read_doc_into", None)
    if fast is not None:
        n = fast(index, dest)
    else:
        data = manifest.read_doc(index)
        n = min(len(data), len(dest))
        dest[:n] = data[:n]
    if cap is not None:
        n = min(n, cap)
    return n


def _read_generated(manifest, index: int) -> bytes:
    """A virtual manifest's document bytes, cut as an armed injector's
    ``truncate`` rule says (the :func:`read_doc_into` contract)."""
    inj = faults.active()
    cap = inj.on_read(index, manifest.paths[index]) if inj is not None else None
    data = manifest.read_doc(index)
    return data if cap is None else data[:cap]


def plan_byte_windows(manifest, target_bytes: int) -> list[tuple[int, int]]:
    """Contiguous ``[lo, hi)`` document ranges of ~``target_bytes`` each.

    Mirrors the byte-balanced window planning of the device paths: every
    window holds whole documents, at least one per window, split when
    the running size reaches the target.
    """
    n = len(manifest)
    windows: list[tuple[int, int]] = []
    lo = 0
    acc = 0
    for i in range(n):
        acc += int(manifest.sizes[i])
        if acc >= target_bytes:
            windows.append((lo, i + 1))
            lo = i + 1
            acc = 0
    if lo < n:
        windows.append((lo, n))
    return windows


def read_window_into(manifest, lo: int, hi: int, arena: WindowArena,
                     policy: "faults.RetryPolicy | None" = None,
                     report: "faults.DegradationReport | None" = None,
                     ) -> WindowArena:
    """Fill ``arena`` with documents ``[lo, hi)`` (arena is reset first).

    Each document read is retried per ``policy`` (default: the
    env-tuned pipeline policy); a document that stays unreadable is
    skipped and recorded in ``report`` (default: the run's active
    report) — the same degrade-don't-die contract as
    corpus.manifest.iter_document_ranges, now with the outcome
    *reported* instead of merely printed.  One counted warning line per
    window covers every skip in it.
    """
    if policy is None:
        policy = faults.default_policy()
    if report is None:
        report = faults.current_report()
    arena.reset()
    window_skips = 0
    virtual = getattr(manifest, "read_doc_into", None) is None
    for i in range(lo, hi):
        try:
            if virtual:
                data = policy.run(
                    lambda: _read_generated(manifest, i),
                    doc_id=manifest.doc_id(i), path=manifest.paths[i],
                    report=report)
                n = len(data)
                arena.view(n)[:] = data
            else:
                dest = arena.view(int(manifest.sizes[i]))
                n = policy.run(
                    lambda: read_doc_into(manifest, i, dest),
                    doc_id=manifest.doc_id(i), path=manifest.paths[i],
                    report=report)
        except OSError as e:
            report.record_skip(doc_id=manifest.doc_id(i),
                               path=manifest.paths[i], reason=str(e))
            window_skips += 1
            continue
        arena.commit(manifest.doc_id(i), n)
    if window_skips:
        log.warning("skipped %d unreadable document(s) in window "
                    "[%d, %d) after retries", window_skips, lo, hi)
    return arena
