"""Packed-key helpers for the sort-based engine.

The reference shuffles ``"word doc_id"`` text lines through 26 spill
files (main.c:116) and re-parses them in the reducer (main.c:170).  Here
the pair and its ordering live in one int32 sort key whenever
``vocab_size * (max_doc_id + 2)`` fits in int32; the engine's pairs path
(an int64 key) is the general fallback.

Padding uses a sentinel that sorts after every real key, so fixed-size
feeds keep a few stable sizes.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def can_pack(vocab_size: int, max_doc_id: int) -> bool:
    """True if (term, doc) pairs fit one int32 key with room for a sentinel."""
    return (vocab_size + 1) * (max_doc_id + 2) < INT32_MAX


def pack_pairs(term_ids: torch.Tensor, doc_ids: torch.Tensor, max_doc_id: int) -> torch.Tensor:
    """key = term * (max_doc+2) + doc; key order == (term, doc) lex order."""
    stride = max_doc_id + 2
    return term_ids.to(torch.int32) * stride + doc_ids.to(torch.int32)


def unpack_pairs(keys: torch.Tensor, max_doc_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    stride = max_doc_id + 2
    return keys // stride, keys % stride
