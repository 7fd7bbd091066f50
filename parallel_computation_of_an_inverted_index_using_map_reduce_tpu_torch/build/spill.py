"""Checksummed spill files for the out-of-core build.

One container format serves both tiers of the disk pipeline:

* **run files** (``run-wKKK-NNNN.bin``) — one scan worker's term-hash-
  sharded postings runs, flushed whenever the worker's estimated
  postings footprint crosses ``MRI_BUILD_SPILL_BYTES`` (and once more
  at scan end).  Terms are (shard asc, lex asc); every term's postings
  run is doc-ascending with a parallel tf column.
* **shard files** (``shard-NNNN.bin``) — one merged term-hash shard,
  produced by the reduce phase's k-way merge over every run's slice of
  that shard.  Terms are lex-ascending with a 27-entry letter offset
  table so letter emitters can slice without searching.

Layout: ``b"MRISPILL"`` magic, u32 version, u32 header length, a JSON
header (``{"meta": {...}, "sections": {name: {offset, nbytes, dtype,
shape, adler32}}}``), then the raw little-endian array sections.  Every
section carries its own adler32 so a torn or bit-flipped file is caught
up front (:func:`verify_file`) and quarantined (:func:`quarantine`)
instead of corrupting output.  Writes are atomic (tmp + rename) and all
spill state lives under a per-process ``.spill-<pid>`` directory inside
the output dir, so a SIGKILLed build leaves only stale directories that
:func:`clean_stale_dirs` removes on the next run.
"""

from __future__ import annotations

import json
import logging
import os
import signal
from pathlib import Path

import numpy as np

from .. import faults
from ..utils import envknobs
from ..utils.checksum import adler32_hex

log = logging.getLogger("mri_torch.build.spill")

MAGIC = b"MRISPILL"
VERSION = 1
_HEADER_FIXED = len(MAGIC) + 8  # magic + u32 version + u32 header length

RUN_SECTIONS = ("vocab", "word_lens", "df", "offsets", "postings", "tf",
                "doc_ids", "doc_tokens")
SHARD_SECTIONS = ("vocab", "word_lens", "df", "offsets", "postings", "tf",
                  "letter_off")

# module-global run-write counter feeding the MRI_SPILL_KILL_AFTER
# crash hook (mirrors the native MRI_EMIT_KILL_AFTER_LETTERS hook)
_runs_written = 0


class SpillError(RuntimeError):
    """A spill file failed validation (bad magic/header/checksum)."""


def spill_dir(out_dir) -> Path:
    """This process's private spill directory under the output dir."""
    return Path(out_dir) / f".spill-{os.getpid()}"


def clean_stale_dirs(out_dir) -> int:
    """Remove leftover ``.spill-*`` directories from crashed builds.

    Returns the number of directories removed.  Safe to call on every
    run start: live builds only ever touch their own pid-suffixed dir.
    """
    removed = 0
    root = Path(out_dir)
    if not root.is_dir():
        return 0
    for entry in sorted(root.glob(".spill-*")):
        if not entry.is_dir():
            continue
        if entry == spill_dir(out_dir):
            continue
        for child in sorted(entry.iterdir()):
            child.unlink()
        entry.rmdir()
        removed += 1
        log.warning("removed stale spill dir %s", entry)
    return removed


def remove_dir(path) -> None:
    """Best-effort removal of this run's own spill directory."""
    root = Path(path)
    if not root.is_dir():
        return
    for child in sorted(root.iterdir()):
        try:
            child.unlink()
        except OSError:
            pass
    try:
        root.rmdir()
    except OSError:
        pass


def write_file(path, meta: dict, sections: dict[str, np.ndarray]) -> int:
    """Atomically write one spill container; returns bytes written."""
    path = Path(path)
    table = {}
    payloads = []
    for name, arr in sections.items():
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        table[name] = {
            "nbytes": len(raw),
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "adler32": adler32_hex(raw),
        }
        payloads.append(raw)
    # section offsets depend on the header's own encoded length, which
    # in turn depends on the offsets' digit counts — iterate to the
    # fixed point (header length is monotone in the offsets, so this
    # converges in a couple of rounds)
    for name in table:
        table[name]["offset"] = 0
    base = _HEADER_FIXED + len(_encode_header(meta, table))
    for _ in range(8):
        off = base
        for name, raw in zip(table, payloads):
            table[name]["offset"] = off
            off += len(raw)
        header = _encode_header(meta, table)
        if _HEADER_FIXED + len(header) == base:
            break
        base = _HEADER_FIXED + len(header)
    else:  # pragma: no cover - defensive
        raise SpillError(f"unstable spill header encoding for {path}")
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(MAGIC)
        fh.write(int(VERSION).to_bytes(4, "little"))
        fh.write(len(header).to_bytes(4, "little"))
        fh.write(header)
        for raw in payloads:
            fh.write(raw)
        fh.flush()
    # no fsync: spill files are consumed by this same process and a
    # crashed build's stale dir is deleted (never replayed) on rerun,
    # so durability buys nothing — the per-section checksums already
    # catch torn bytes, and fsync-per-run dominated small-budget builds
    os.replace(tmp, path)
    return off


def _encode_header(meta: dict, table: dict) -> bytes:
    return json.dumps({"meta": meta, "sections": table},
                      sort_keys=True).encode()


class SpillFile:
    """Seekable reader over one spill container.

    Parses the header eagerly; section payloads are read on demand so a
    reducer can pull one shard's row range without touching the rest of
    the file (the point of the exercise: reduce memory stays
    O(corpus / shards), not O(corpus)).
    """

    def __init__(self, path):
        self.path = Path(path)
        self._fh = open(self.path, "rb")
        try:
            head = self._fh.read(_HEADER_FIXED)
            if len(head) != _HEADER_FIXED or head[:len(MAGIC)] != MAGIC:
                raise SpillError(f"bad spill magic in {self.path}")
            version = int.from_bytes(head[8:12], "little")
            if version != VERSION:
                raise SpillError(
                    f"unsupported spill version {version} in {self.path}")
            hlen = int.from_bytes(head[12:16], "little")
            try:
                header = json.loads(self._fh.read(hlen))
                self.meta = dict(header["meta"])
                self.sections = dict(header["sections"])
            except (ValueError, KeyError, TypeError) as exc:
                raise SpillError(
                    f"bad spill header in {self.path}: {exc}") from None
        except BaseException:
            self._fh.close()
            raise

    def section(self, name: str) -> np.ndarray:
        """Read one full section."""
        info = self.sections[name]
        self._fh.seek(info["offset"])
        raw = self._fh.read(info["nbytes"])
        if len(raw) != info["nbytes"]:
            raise SpillError(f"truncated section {name!r} in {self.path}")
        return np.frombuffer(raw, dtype=np.dtype(info["dtype"])) \
                 .reshape(info["shape"])

    def read_rows(self, name: str, lo: int, hi: int) -> np.ndarray:
        """Read rows ``[lo, hi)`` of a section without reading the rest."""
        info = self.sections[name]
        shape = list(info["shape"])
        row_items = 1
        for dim in shape[1:]:
            row_items *= dim
        itemsize = np.dtype(info["dtype"]).itemsize
        nbytes = (hi - lo) * row_items * itemsize
        self._fh.seek(info["offset"] + lo * row_items * itemsize)
        raw = self._fh.read(nbytes)
        if len(raw) != nbytes:
            raise SpillError(f"truncated section {name!r} in {self.path}")
        return np.frombuffer(raw, dtype=np.dtype(info["dtype"])) \
                 .reshape([hi - lo] + shape[1:])

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def verify_file(path) -> None:
    """Full checksum walk; raises :class:`SpillError` on any damage.

    Reducers call this on every run up front, so a torn spill (crash or
    ``spill-corrupt`` injection) is caught before its bytes can reach a
    letter file or the artifact.
    """
    with SpillFile(path) as sf:
        for name, info in sf.sections.items():
            sf._fh.seek(info["offset"])
            raw = sf._fh.read(info["nbytes"])
            if len(raw) != info["nbytes"]:
                raise SpillError(f"truncated section {name!r} in {path}")
            got = adler32_hex(raw)
            if got != info["adler32"]:
                raise SpillError(
                    f"checksum mismatch in section {name!r} of {path}: "
                    f"{got} != {info['adler32']}")


def quarantine(path) -> Path:
    """Sideline a damaged spill file as ``<name>.corrupt`` (same move
    the checkpoint layer makes) so a rerun can't trip over it."""
    path = Path(path)
    target = path.with_name(path.name + ".corrupt")
    os.replace(path, target)
    log.warning("quarantined corrupt spill file %s -> %s",
                path, target.name)
    return target


def run_path(dir_path, worker: int, run_index: int) -> Path:
    return Path(dir_path) / f"run-w{worker:03d}-{run_index:04d}.bin"


def shard_path(dir_path, shard: int) -> Path:
    return Path(dir_path) / f"shard-{shard:04d}.bin"


def write_run(dir_path, worker: int, run_index: int, pack: dict,
              windows: list) -> tuple[Path, int]:
    """Write one worker's run file from a ``HostIndexStream.runpack``
    dict; returns ``(path, bytes_written)``.

    ``windows`` lists the ``(window_index, doc_lo, doc_hi)`` manifest
    ranges whose documents this run covers — recorded in the header for
    debugging, authoritative in the caller's in-memory slot state (so a
    run whose *header* is torn can still be attributed for skips).
    """
    global _runs_written
    meta = {
        "kind": "run",
        "worker": int(worker),
        "run": int(run_index),
        "shards": int(pack["shard_term_off"].shape[0] - 1),
        "vocab": int(pack["vocab"]),
        "width": int(pack["width"]),
        "pairs": int(pack["pairs"]),
        "docs": int(pack["doc_ids"].shape[0]),
        "max_doc_id": int(pack["max_doc_id"]),
        "raw_tokens": int(pack["raw_tokens"]),
        "windows": [[int(a), int(b), int(c)] for a, b, c in windows],
        "shard_term_off": [int(x) for x in pack["shard_term_off"]],
        "shard_pair_off": [int(x) for x in pack["shard_pair_off"]],
    }
    sections = {
        "vocab": pack["vocab_packed"],
        "word_lens": pack["word_lens"],
        "df": pack["df"],
        "offsets": pack["offsets"],
        "postings": pack["postings"],
        "tf": pack["tf"],
        "doc_ids": pack["doc_ids"],
        "doc_tokens": pack["doc_tokens"],
    }
    path = run_path(dir_path, worker, run_index)
    nbytes = write_file(path, meta, sections)
    inj = faults.active()
    if inj is not None:
        inj.on_spill_written(str(path))
    _runs_written += 1
    kill_after = envknobs.get("MRI_SPILL_KILL_AFTER")
    if kill_after is not None and _runs_written >= kill_after:
        log.warning("MRI_SPILL_KILL_AFTER=%d tripped after %s",
                    kill_after, path.name)
        os.kill(os.getpid(), signal.SIGKILL)
    return path, nbytes


def write_shard(dir_path, shard: int, merged: dict) -> tuple[Path, int]:
    """Write one merged shard file from an ``ooc.merge_shard`` dict."""
    meta = {
        "kind": "shard",
        "shard": int(shard),
        "vocab": int(merged["df"].shape[0]),
        "width": int(merged["width"]),
        "pairs": int(merged["postings"].shape[0]),
    }
    sections = {
        "vocab": merged["vocab"],
        "word_lens": merged["word_lens"],
        "df": merged["df"],
        "offsets": merged["offsets"],
        "postings": merged["postings"],
        "tf": merged["tf"],
        "letter_off": merged["letter_off"],
    }
    path = shard_path(dir_path, shard)
    return path, write_file(path, meta, sections)
