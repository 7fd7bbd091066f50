"""Bounds-checked lazy sequences for virtual manifests.

The file-backed :class:`.manifest.Manifest` exposes ``paths`` and
``sizes`` as real lists; a virtual manifest (:mod:`.synthetic`) must
duck-type the same surface without materializing millions of entries.  Every consumer contract lives
here once: real sequence semantics (iteration terminates — Python's
sequence protocol probes ``__getitem__`` until ``IndexError``),
negative indices, and slices (the byte-balance planners do
``sizes[lo:hi]``).
"""

from __future__ import annotations


class VirtualSeq:
    """Length-``n`` read-only sequence computing item ``i`` as ``fn(i)``."""

    def __init__(self, n: int, fn):
        self._n = n
        self._fn = fn

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._fn(j) for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._fn(i)
