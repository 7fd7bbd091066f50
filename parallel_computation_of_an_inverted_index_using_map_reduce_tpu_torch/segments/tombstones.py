"""Per-segment tombstone bitmaps — delete without rewrite.

A delete never touches the immutable segment artifact: it flips a bit
in a tiny sidecar bitmap that the multi-segment engine filters at
query time and compaction finally drops.  Files are generation-tagged
(``tombstones_<gen>.bin``) and referenced from the manifest entry, so
the manifest swap stays the single atomicity point: the OLD generation
keeps pointing at the OLD bitmap, and a crash mid-delete leaves at
worst an orphan file no manifest references.

Wire format, little-endian::

    magic    8s   b"MRITOMB1"
    ndocs    u32  local id span (bit i covers local id i + 1)
    bitmap   u8[ceil(ndocs / 8)]  LSB-first (numpy packbits order)
    adler32  u32  over everything above

Loads verify magic, size, and checksum — a corrupted bitmap raises
:class:`~.manifest.SegmentError` instead of silently resurrecting or
deleting documents.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

from .manifest import SegmentError
from .. import faults
from ..utils.checksum import adler32_hex

TOMB_MAGIC = b"MRITOMB1"


def tombstone_name(gen: int) -> str:
    return f"tombstones_{gen}.bin"


def empty_bitmap(ndocs: int) -> np.ndarray:
    """All-live bitmap: bool[ndocs], index ``local_id - 1``."""
    return np.zeros(int(ndocs), dtype=bool)


def encode(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, dtype=bool)
    packed = np.packbits(bits, bitorder="little").tobytes()
    body = TOMB_MAGIC + struct.pack("<I", len(bits)) + packed
    return body + struct.pack("<I", zlib.adler32(body))


def decode(data: bytes, *, ndocs: int, path: str = "") -> np.ndarray:
    """Parse + verify one bitmap file's bytes; ``ndocs`` is the span
    the manifest entry promises (a mismatch is corruption too)."""
    where = path or "<tombstones>"
    if len(data) < 16 or data[:8] != TOMB_MAGIC:
        raise SegmentError(f"{where}: not a tombstone bitmap")
    (n,) = struct.unpack_from("<I", data, 8)
    want = 12 + ((n + 7) // 8) + 4
    if len(data) != want:
        raise SegmentError(
            f"{where}: truncated tombstone bitmap "
            f"({len(data)} bytes, expected {want})")
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    if zlib.adler32(data[:-4]) != crc:
        raise SegmentError(f"{where}: tombstone checksum mismatch")
    if n != int(ndocs):
        raise SegmentError(
            f"{where}: bitmap covers {n} docs, manifest entry "
            f"promises {ndocs}")
    bits = np.unpackbits(
        np.frombuffer(data, dtype=np.uint8, count=(n + 7) // 8,
                      offset=12), bitorder="little")[:n]
    return bits.astype(bool)


def load(path, *, ndocs: int) -> np.ndarray:
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise SegmentError(f"{path}: cannot read tombstones ({e})") \
            from e
    return decode(data, ndocs=ndocs, path=str(path))


def save(path, bits: np.ndarray) -> tuple[str, int]:
    """Stage, fault-check, re-verify, then rename — returns the
    published file's ``(adler32_hex, size)`` for the manifest entry.

    The ``tombstone-corrupt`` fault kind flips bytes in the STAGED
    file; the re-verify then rejects the write before anything is
    published, proving the old generation keeps serving.
    """
    path = Path(path)
    data = encode(bits)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    inj = faults.active()
    if inj is not None:
        inj.on_tombstone_write(str(tmp))
    try:
        staged = tmp.read_bytes()
        decode(staged, ndocs=len(bits), path=str(tmp))
    except SegmentError:
        os.unlink(tmp)
        raise
    os.replace(tmp, path)
    return adler32_hex(staged), len(staged)
