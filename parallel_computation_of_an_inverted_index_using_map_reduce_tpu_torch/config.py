"""Framework configuration.

The reference exposes exactly three positional CLI args — num_mappers,
num_reducers, input list (main.c:248-255) — plus compile-time caps
(main.c:7-11).  Here those become an explicit, validated config object.
The config holds the fields of the plans this package implements: the
pipelined plan (native scan, provisional-key windows, one device sort)
and the one-shot plan.
"""

from __future__ import annotations

import dataclasses

# Reference compile-time caps (main.c:7-11).  MAX_WORD bounds the *cleaned*
# token: the reference keeps at most MAX_WORD-1 = 299 letters per token
# (main.c:105 loop guard `j < MAX_WORD - 1`).
MAX_WORD_LETTERS = 299
ALPHABET_SIZE = 26


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """End-to-end pipeline configuration.

    ``num_mappers`` / ``num_reducers`` keep the reference CLI's meaning;
    the output is invariant to both (the device engine balances the
    reduce by sort, not by letter partition).
    """

    num_mappers: int = 1
    num_reducers: int = 1
    # "cuda"   — the device engine (torch sort + hand-written CUDA kernels)
    # "oracle" — pure-Python dict oracle, the conformance seam
    backend: str = "cuda"
    output_dir: str = "."         # where a.txt .. z.txt are written
    # Pad the token count up to a multiple of this, so feed buffers keep
    # a few stable sizes across similarly-sized corpora.
    pad_multiple: int = 1 << 16
    # Measure letter vs hash-bucket partition skew on the device
    # (utils/stats.py).  Off the hot path, so opt-in.
    collect_skew_stats: bool = False
    # torch device of the engine.  "cuda" (default) needs a card and
    # raises without one; "cpu" runs the kernels' plain versions.
    device: str = "cuda"
    # Host scan: C++ (native/tokenizer.cc, built with g++ on first use)
    # with automatic fallback to the vectorized numpy tokenizer.
    use_native: bool = True
    # Pipelined plan (native scan + provisional-key device sort):
    # documents per upload window.  None = auto (two byte-balanced
    # windows: window 1's upload overlaps window 2's scan); 0 disables
    # the pipelined plan (forces the one-shot engine).
    pipeline_chunk_docs: int | None = None
    # Host map-phase threads of the native scan (fork-join over
    # contiguous byte-balanced doc ranges, output-identical at any
    # count).  None = ``num_mappers`` if > 1, else min(cores, 8).
    host_threads: int | None = None
    # Letter-file writer: "auto" = the native emit when the library
    # loads (and use_native is on), else Python; "native" requires it;
    # "python" forces the pure-Python writer.  Byte-identical all three.
    emit_backend: str = "auto"

    def resolved_host_threads(self) -> int:
        """The map-phase thread count this run will actually use."""
        if self.host_threads is not None:
            return self.host_threads
        if self.num_mappers > 1:
            return self.num_mappers
        from .native import default_threads

        return default_threads()

    def __post_init__(self) -> None:
        if self.num_mappers < 1:
            raise ValueError(f"num_mappers must be >= 1, got {self.num_mappers}")
        if self.num_reducers < 1:
            raise ValueError(f"num_reducers must be >= 1, got {self.num_reducers}")
        if self.backend not in ("cuda", "oracle"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.pad_multiple < 1:
            raise ValueError("pad_multiple must be >= 1")
        if self.backend != "cuda" and self.collect_skew_stats:
            raise ValueError(
                "collect_skew_stats requires backend='cuda', "
                f"got backend={self.backend!r}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if self.pipeline_chunk_docs is not None and self.pipeline_chunk_docs < 0:
            raise ValueError(
                "pipeline_chunk_docs must be >= 1, 0 (disabled) or None (auto), "
                f"got {self.pipeline_chunk_docs}")
        if self.backend != "cuda" and self.pipeline_chunk_docs is not None:
            raise ValueError(
                f"pipeline_chunk_docs requires backend='cuda', got backend={self.backend!r}")
        if self.host_threads is not None and self.host_threads < 1:
            raise ValueError(
                f"host_threads must be >= 1 or None (auto), got {self.host_threads}")
        if self.emit_backend not in ("auto", "native", "python"):
            raise ValueError(
                f"emit_backend must be 'auto', 'native' or 'python', "
                f"got {self.emit_backend!r}")
