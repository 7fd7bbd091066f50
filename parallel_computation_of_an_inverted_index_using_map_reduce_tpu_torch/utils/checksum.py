"""Adler-32 checksums in the JAX package's spelling: 8 lowercase hex
digits, the format of the artifact's audit fingerprint."""

from __future__ import annotations

import zlib
from pathlib import Path


def adler32_hex(data: bytes) -> str:
    """Adler-32 of ``data`` as 8 lowercase hex digits."""
    return f"{zlib.adler32(data) & 0xFFFFFFFF:08x}"


def file_checksum(path) -> tuple[str, int]:
    """``(adler32 hex, byte length)`` of a whole file's contents."""
    data = Path(path).read_bytes()
    return adler32_hex(data), len(data)
