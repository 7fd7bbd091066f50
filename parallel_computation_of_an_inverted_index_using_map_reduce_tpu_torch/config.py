"""Framework configuration.

The reference exposes exactly three positional CLI args — num_mappers,
num_reducers, input list (main.c:248-255) — plus compile-time caps
(main.c:7-11).  Here those become an explicit, validated config object.
This package implements the one-shot device plan, so the config holds
only the fields that plan reads.
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
