"""Reusable document-window buffers.

A :class:`WindowArena` owns one uint8 byte buffer plus the int64
cumulative-end and int32 doc-id arrays the native entry points consume
(`mri_hidx_feed`, `mri_host_index`, `mri_stream_feed*` all share the
``(data, ends, ids)`` window ABI).  Filling an arena in place and
handing the native scan raw pointers removes both per-window copies the
old path paid — the ``b"".join`` of per-doc bytes objects and the
``np.frombuffer``/``np.full`` marshalling — and lets a ring of arenas
recycle the same pages window after window.
"""

from __future__ import annotations

import numpy as np


class WindowArena:
    """One reusable window: concatenated doc bytes + ends + doc ids.

    Grows geometrically when a window outsizes it and never shrinks, so
    a steady-state ring settles at the largest window seen and stops
    allocating.  Not thread-safe; a ring hands each arena to exactly one
    thread at a time (see executor.PipelinedWindowReader).
    """

    def __init__(self, byte_capacity: int = 1 << 21, doc_capacity: int = 256):
        self._buf = np.empty(max(int(byte_capacity), 1), dtype=np.uint8)
        self._ends = np.empty(max(int(doc_capacity), 1), dtype=np.int64)
        self._ids = np.empty(max(int(doc_capacity), 1), dtype=np.int32)
        self.used_bytes = 0
        self.num_docs = 0
        # global plan index of the window currently held (stamped by
        # the executor's reader thread; 0 = not window-tagged)
        self.window_index = 0

    def reset(self) -> "WindowArena":
        self.used_bytes = 0
        self.num_docs = 0
        return self

    def _grow_bytes(self, need: int) -> None:
        cap = self._buf.shape[0]
        while cap < need:
            cap *= 2
        buf = np.empty(cap, dtype=np.uint8)
        buf[: self.used_bytes] = self._buf[: self.used_bytes]
        self._buf = buf

    def _grow_docs(self) -> None:
        cap = self._ends.shape[0] * 2
        ends = np.empty(cap, dtype=np.int64)
        ids = np.empty(cap, dtype=np.int32)
        ends[: self.num_docs] = self._ends[: self.num_docs]
        ids[: self.num_docs] = self._ids[: self.num_docs]
        self._ends = ends
        self._ids = ids

    def view(self, nbytes: int) -> memoryview:
        """A writable view of the next ``nbytes`` (not yet committed)."""
        need = self.used_bytes + int(nbytes)
        if need > self._buf.shape[0]:
            self._grow_bytes(need)
        return memoryview(self._buf.data)[self.used_bytes:need]

    def commit(self, doc_id: int, nbytes: int) -> None:
        """Record one document occupying the next ``nbytes`` as written.

        ``nbytes`` may be smaller than the :meth:`view` request (short
        read); the arena advances by what was actually written.
        """
        if self.num_docs >= self._ends.shape[0]:
            self._grow_docs()
        self.used_bytes += int(nbytes)
        self._ends[self.num_docs] = self.used_bytes
        self._ids[self.num_docs] = doc_id
        self.num_docs += 1

    def append_bytes(self, doc_id: int, data: bytes) -> None:
        """Copy-in fallback for sources that only yield bytes objects."""
        n = len(data)
        self.view(n)[:] = data
        self.commit(doc_id, n)

    def feed_views(self):
        """``(buf, ends, ids)`` prefix views sized to the committed docs —
        zero-copy slices of the backing arrays, valid until the next
        :meth:`reset`/:meth:`view` growth."""
        return (
            self._buf[: self.used_bytes],
            self._ends[: self.num_docs],
            self._ids[: self.num_docs],
        )

    def contents(self) -> list[bytes]:
        """Per-doc bytes copies (compat path for list-of-bytes callers)."""
        out = []
        start = 0
        for i in range(self.num_docs):
            end = int(self._ends[i])
            out.append(self._buf[start:end].tobytes())
            start = end
        return out
