"""The device program's share of its roofline, in %: the least time the
build's device work can take (the corpus's bytes read once and its unique
(term, doc) pairs written once at 8 bytes, over the card's peak memory
bandwidth from ``peaks.json``) over the profiler's device-busy time per
build.  The count depends on the corpus alone, whatever implements it."""

import json
from pathlib import Path

PAIR_BYTES = 8


def least_bytes(corpus_bytes: int, unique_pairs: int) -> int:
    return corpus_bytes + PAIR_BYTES * unique_pairs


def read(record: dict):
    peaks = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())
    peak = peaks.get(record.get("device_kind") or "", {}).get("hbm_bytes_per_s")
    if not peak or not record.get("busy_s") or not record["builds"]:
        return None
    least_s = least_bytes(record["corpus_bytes"], record["unique_pairs"]) / peak
    return 100.0 * least_s / (record["busy_s"] / len(record["builds"]))
