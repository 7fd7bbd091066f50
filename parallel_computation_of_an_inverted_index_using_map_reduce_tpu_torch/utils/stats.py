"""Partition-skew statistics (device-computed).

The reference partitions the shuffle by first letter, which is heavily
skewed on real text; the device engine's hash buckets are near-uniform.
This module measures both on the card through the ``bucket_histogram``
kernel, so the imbalance is observable per run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ALPHABET_SIZE
from ..ops.kernels import bucket_histogram


def partition_skew(term_ids, letter_of_term, num_buckets: int, device="cpu") -> dict:
    """Compare letter-partition vs hash-bucket-partition balance.

    ``term_ids`` are the emitted pair term ids (any length);
    ``letter_of_term`` maps term id -> 0..25.  Returns per-partition
    counts and the max/mean imbalance ratio for both policies.
    """
    terms = torch.from_numpy(np.ascontiguousarray(term_ids, dtype=np.int32)).to(device)
    letters = torch.from_numpy(
        np.ascontiguousarray(letter_of_term, dtype=np.int32)).to(device)
    letter_counts = bucket_histogram(letters[terms.long()], ALPHABET_SIZE).cpu().numpy()
    bucket_counts = bucket_histogram(terms % num_buckets, num_buckets).cpu().numpy()

    def imbalance(counts: np.ndarray) -> float:
        mean = counts.mean()
        return float(counts.max() / mean) if mean > 0 else 0.0

    return {
        "letter_counts": letter_counts,
        "bucket_counts": bucket_counts,
        "letter_imbalance": imbalance(letter_counts),
        "bucket_imbalance": imbalance(bucket_counts),
        "num_buckets": num_buckets,
    }
