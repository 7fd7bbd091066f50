"""Host I/O subsystem: zero-copy ingest for the native host pipeline.

The reference reads each input file into a fresh heap block per mapper
(main.c:90-101); our previous host path did the Python equivalent —
``read_doc()`` bytes objects joined with ``b"".join`` and re-copied into
numpy — which put two token-scale copies and an allocator storm in
front of every scan.  This package replaces that with reusable window
arenas (`arena`), ``readinto``-based manifest readers (`reader`), and a
prefetching window executor (`executor`) that overlaps file reads with
the GIL-releasing native scan.
"""

from .arena import WindowArena
from .executor import PipelinedWindowReader, ReaderDied, ReaderHang
from .reader import plan_byte_windows, read_doc_into, read_window_into

__all__ = [
    "WindowArena",
    "PipelinedWindowReader",
    "ReaderDied",
    "ReaderHang",
    "plan_byte_windows",
    "read_doc_into",
    "read_window_into",
]
