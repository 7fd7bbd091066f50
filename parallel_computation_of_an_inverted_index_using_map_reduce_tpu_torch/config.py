"""Framework configuration.

The reference exposes exactly three positional CLI args — num_mappers,
num_reducers, input list (main.c:248-255) — plus compile-time caps
(main.c:7-11).  Here those become an explicit, validated config object.
The config holds the fields of the plans this package implements: the
pipelined plan (native scan, provisional-key windows, one device sort)
and its overlap variant (``overlap_tail_fraction``), the one-shot plan,
the streaming plan (``stream_chunk_docs``), the all-device plan
(``device_tokenize``) and the two together, the streaming all-device
plan with its resumable stream checkpoints, the serving artifact
(``artifact``) every plan but the overlap plan packs, and the
multi-shard builds (``device_shards``, ``emit_ownership``).
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
    # Logical shards of the multi-shard engines (parallel/): None = one
    # per visible card of ``device`` (1 on the CPU, so the single-device
    # plans); 1 forces the single-device plans; N > 1 runs the mesh
    # plans with shard i on card i % cards (N shards may share a card).
    device_shards: int | None = None
    # Host scan: C++ (native/tokenizer.cc, built with g++ on first use)
    # with automatic fallback to the vectorized numpy tokenizer.
    use_native: bool = True
    # Pipelined plan (native scan + provisional-key device sort):
    # documents per upload window.  None = auto (two byte-balanced
    # windows: window 1's upload overlaps window 2's scan); 0 disables
    # the pipelined plan (forces the one-shot engine).
    pipeline_chunk_docs: int | None = None
    # Streaming plan: process the corpus in windows of this many whole
    # documents with a bounded device accumulator (ops/streaming.py, or
    # ops/device_streaming.py with device_tokenize) instead of one-shot
    # arrays.  None = off.  Takes precedence over the pipelined plan.
    # Output is byte-identical either way.
    stream_chunk_docs: int | None = None
    # All-device plan (ops/device_tokenizer.py): raw corpus bytes go up,
    # the finished index comes down — byte classify, token segmentation,
    # cleaning, dedup, df and postings as one device program.  Exact
    # (words are fixed-width byte rows, no hashing); a cleaned token
    # longer than ``device_tokenize_width`` aborts to the host-scan
    # plans (WidthOverflow).  Single device.
    device_tokenize: bool = False
    # Word-row width in bytes (multiple of 4; >= the longest cleaned
    # token or the run falls back).
    device_tokenize_width: int = 48
    # Host map-phase threads of the native scan (fork-join over
    # contiguous byte-balanced doc ranges, output-identical at any
    # count).  None = ``num_mappers`` if > 1, else min(cores, 8).
    host_threads: int | None = None
    # Letter-file writer: "auto" = the native emit when the library
    # loads (and use_native is on), else Python; "native" requires it;
    # "python" forces the pure-Python writer.  Byte-identical all three.
    emit_backend: str = "auto"
    # Windowed overlap plan (a single-device variant of the pipelined
    # plan): this fraction of the corpus bytes — the LAST contiguous doc
    # range — is indexed on the host (a numpy sort of its packed keys)
    # while the earlier windows' device sorts and fetches are in flight;
    # the emit concatenates the per-window runs in doc order.  None =
    # off (the plain pipelined plan); must be in (0, 1).
    overlap_tail_fraction: float | None = None
    # Device windows of the overlap plan: 2 issues the first fetch
    # earlier; 1 halves the launches and copies.
    overlap_device_windows: int = 2
    # The first device window's share of the overlap plan's device bytes.
    overlap_window_split: float = 0.55
    # Crash-resumable streaming all-device plan (device_tokenize with
    # stream_chunk_docs): save the verified accumulator prefix and the
    # stream position here every ``stream_checkpoint_every`` windows
    # (utils/checkpoint.py, atomic); a rerun with the same manifest and
    # stream config resumes at the last saved window.
    stream_checkpoint: str | None = None
    stream_checkpoint_every: int = 2
    # What a corrupt checkpoint does at resume: "strict" raises
    # (utils/checkpoint.CheckpointCorrupt); "auto" moves it aside to
    # ``<path>.corrupt`` and starts fresh.  A version or fingerprint
    # mismatch raises under both.
    resume: str = "strict"
    # Serving artifact (serve/artifact.py): pack a compact mmap-able
    # ``index.mri`` next to the letter files at emit time, so the query
    # engine (``query DIR``, serve.DeviceEngine) never re-parses text.
    # Needs the merged postings on one host: incompatible with the
    # letter-ownership emit and the overlap plan's split emit.
    artifact: bool = False
    # Emit-side ownership of the multi-shard builds:
    #   "merged" — one host assembles and writes all 26 files (default)
    #   "letter" — pairs are exchanged by *letter owner*
    #              (corpus/scheduler.plan_letter_ranges — the reference's
    #              reducer ownership, main.c:129-150) and each owner
    #              emits only its own letter files; no global merge.
    emit_ownership: str = "merged"

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
        if self.overlap_tail_fraction is not None:
            if not 0.0 < self.overlap_tail_fraction < 1.0:
                raise ValueError(
                    "overlap_tail_fraction must be in (0, 1) or None, "
                    f"got {self.overlap_tail_fraction}")
            if self.backend != "cuda":
                raise ValueError(
                    "overlap_tail_fraction requires backend='cuda', "
                    f"got backend={self.backend!r}")
            if self.pipeline_chunk_docs == 0:
                raise ValueError(
                    "overlap_tail_fraction requires the pipelined path "
                    "(pipeline_chunk_docs=0 disables it)")
            if self.stream_chunk_docs is not None:
                raise ValueError(
                    "overlap_tail_fraction is incompatible with "
                    "stream_chunk_docs (the streaming engine has its own "
                    "window pipeline)")
        if self.device_shards is not None and self.device_shards < 1:
            raise ValueError(
                f"device_shards must be >= 1 or None (auto), got {self.device_shards}")
        if self.overlap_tail_fraction is not None and self.emit_ownership == "letter":
            raise ValueError(
                "overlap_tail_fraction is single-device; "
                "emit_ownership='letter' is the multi-shard emit path")
        if self.artifact:
            if self.emit_ownership == "letter":
                raise ValueError(
                    "artifact requires the merged emit (one host holds "
                    "the global postings); emit_ownership='letter' "
                    "splits them across owners")
            if self.overlap_tail_fraction is not None:
                raise ValueError(
                    "artifact is incompatible with overlap_tail_fraction "
                    "(the overlap plan emits from two disjoint partial "
                    "indexes, never materializing merged postings)")
        if self.overlap_device_windows not in (1, 2):
            raise ValueError(
                f"overlap_device_windows must be 1 or 2, "
                f"got {self.overlap_device_windows}")
        if not (0.0 < self.overlap_window_split < 1.0):
            raise ValueError(
                f"overlap_window_split must be in (0, 1), "
                f"got {self.overlap_window_split}")
        # upper bound 296 (< MAX_WORD_LETTERS): a width that could hold
        # a 299+-letter token would silently skip the reference's 299
        # cap (main.c:105) instead of falling back to the host path
        if not (4 <= self.device_tokenize_width <= 296
                and self.device_tokenize_width % 4 == 0):
            raise ValueError(
                "device_tokenize_width must be a multiple of 4 in [4, 296], "
                f"got {self.device_tokenize_width}")
        if self.device_tokenize:
            if self.backend != "cuda":
                raise ValueError(
                    "device_tokenize requires backend='cuda', "
                    f"got backend={self.backend!r}")
            for flag in ("pipeline_chunk_docs", "overlap_tail_fraction"):
                if getattr(self, flag) is not None:
                    raise ValueError(
                        f"device_tokenize is a complete engine; {flag} "
                        "belongs to the host-scan plans")
            if self.collect_skew_stats:
                raise ValueError(
                    "device_tokenize is incompatible with collect_skew_stats "
                    "(no host-side pair ids exist)")
        if self.resume not in ("strict", "auto"):
            raise ValueError(
                f"resume must be 'strict' or 'auto', got {self.resume!r}")
        if self.stream_checkpoint_every < 1:
            raise ValueError(
                f"stream_checkpoint_every must be >= 1, "
                f"got {self.stream_checkpoint_every}")
        if self.stream_checkpoint is not None:
            if not (self.device_tokenize and self.stream_chunk_docs is not None):
                raise ValueError(
                    "stream_checkpoint requires the streaming all-device "
                    "engine (device_tokenize=True with stream_chunk_docs)")
            # None is allowed here and refused at run time if it resolves
            # to several shards (the mesh streaming engine has no
            # checkpoint); the JAX config asks for an explicit 1
            if self.device_shards is not None and self.device_shards > 1:
                raise ValueError(
                    "stream_checkpoint is single-device only: the mesh "
                    "streaming engine has no checkpoint; got "
                    f"device_shards={self.device_shards}")
        if self.stream_chunk_docs is not None:
            if self.stream_chunk_docs < 1:
                raise ValueError(
                    f"stream_chunk_docs must be >= 1 or None, got {self.stream_chunk_docs}")
            if self.backend != "cuda":
                raise ValueError(
                    "stream_chunk_docs requires backend='cuda', "
                    f"got backend={self.backend!r}")
            if self.collect_skew_stats:
                raise ValueError(
                    "stream_chunk_docs is incompatible with collect_skew_stats "
                    "(per-window pair ids are discarded after each merge)")
        if self.host_threads is not None and self.host_threads < 1:
            raise ValueError(
                f"host_threads must be >= 1 or None (auto), got {self.host_threads}")
        if self.emit_backend not in ("auto", "native", "python"):
            raise ValueError(
                f"emit_backend must be 'auto', 'native' or 'python', "
                f"got {self.emit_backend!r}")
        if self.emit_ownership not in ("merged", "letter"):
            raise ValueError(
                f"emit_ownership must be 'merged' or 'letter', got {self.emit_ownership!r}")
        if self.emit_ownership == "letter":
            if self.backend != "cuda":
                raise ValueError(
                    f"emit_ownership='letter' requires backend='cuda', "
                    f"got backend={self.backend!r}")
            if self.stream_chunk_docs is not None:
                raise ValueError(
                    "emit_ownership='letter' requires the pipelined multi-shard "
                    "path (incompatible with stream_chunk_docs)")
            if self.pipeline_chunk_docs == 0:
                raise ValueError(
                    "emit_ownership='letter' requires the pipelined multi-shard "
                    "path (pipeline_chunk_docs=0 disables it)")
