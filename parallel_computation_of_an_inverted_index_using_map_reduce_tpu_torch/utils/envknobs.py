"""The ``MRI_*`` environment knobs this package reads.

Each is declared once with its name, type, default and bounds, the same
as the JAX package's declaration of it, so one setting drives both
packages.  :func:`get` reads one; a malformed value raises a
``ValueError`` naming the variable, which the CLI turns into exit 2.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple


class _Knob(NamedTuple):
    cast: Callable[[str], Any]
    default: Any
    choices: tuple | None = None
    minimum: Any = None
    exclusive: bool = False  # the minimum itself is refused


_KNOBS: dict[str, _Knob] = {
    # snapshot-tax budget: a projected stream-checkpoint save slower
    # than this many seconds is skipped (recorded, not paid)
    "MRI_TPU_CKPT_BUDGET_S": _Knob(float, 120.0),
    # assumed device->host rate (MB/s) seeding the checkpoint cost
    # projection; re-calibrated from each measured save
    "MRI_TPU_CKPT_LINK_MBPS": _Knob(float, 8.0),
    # most consecutive over-budget checkpoint skips before one save is
    # forced
    "MRI_TPU_CKPT_STRETCH": _Knob(int, 4),
    # test hook: raise after this device-stream window (0: disabled)
    "MRI_TPU_STREAM_CRASH_AFTER_WINDOWS": _Knob(int, 0),
    # -- fault injection and read retries --
    # fault spec armed at the first faults.active() call (subprocess
    # arming); the grammar of --fault-spec
    "MRI_FAULTS": _Knob(str, None),
    # read attempts per document (counts the first try)
    "MRI_READ_RETRIES": _Knob(int, 3, minimum=1),
    # initial retry backoff in ms (doubles per retry)
    "MRI_READ_BACKOFF_MS": _Knob(float, 5.0, minimum=0),
    # total per-document retry deadline in seconds
    "MRI_READ_DEADLINE_S": _Knob(float, 1.0, minimum=0, exclusive=True),
    # crash hook: SIGKILL the process after N complete letter files
    "MRI_EMIT_KILL_AFTER_LETTERS": _Knob(int, None),
    # -- query serving --
    # engine when 'query' gets no --engine flag: host, device or auto
    # (validated by serve.engine.resolve_engine; unset: device)
    "MRI_SERVE_ENGINE": _Knob(str, None),
    # native (C++) serve kernels for v2 decode/AND/BM25: auto (on when
    # the library loads), 1 (required: engine creation fails without
    # it) or 0 (numpy only); answers are byte-identical either way
    "MRI_SERVE_NATIVE": _Knob(str, "auto", choices=("auto", "0", "1")),
    # --engine auto host->device batch-size crossover: unset probes it,
    # 0 pins the host, N > 0 routes batches >= N to the device engine
    "MRI_SERVE_CROSSOVER": _Knob(int, None, minimum=0),
    # artifact format the builders write: 1 (delta postings), 2 (block
    # bitpacked) or 3 (v2.1: v2 plus per-block max-score columns)
    "MRI_SERVE_FORMAT": _Knob(int, 3, choices=(1, 2, 3)),
    # v2 postings block size in doc ids (power of two)
    "MRI_SERVE_BLOCK_SIZE": _Knob(int, 128, minimum=2),
    # v2.1 max-score column width in bits
    "MRI_SERVE_SCORE_BITS": _Knob(int, 8, choices=(8, 16)),
    # top_k scoring mode when the query names none
    "MRI_SERVE_SCORE": _Knob(str, "df", choices=("df", "bm25")),
    # ranked-query planner
    "MRI_SERVE_PLANNER": _Knob(str, "auto", choices=("auto", "exhaustive", "bmw", "maxscore")),
    # device-engine shard count (unset: one device)
    "MRI_SERVE_SHARDS": _Knob(int, None),
    # most decode-window elements (rows x width) per device call
    "MRI_SERVE_DEVICE_DECODE_BUDGET": _Knob(int, 1 << 24),
}


def get(name: str) -> Any:
    """The knob's parsed value from the environment, or its default."""
    knob = _KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    try:
        val = knob.cast(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a valid {knob.cast.__name__}") from None
    if knob.choices is not None and val not in knob.choices:
        raise ValueError(f"{name}={raw!r} not in {knob.choices}")
    if knob.minimum is not None and (
            val < knob.minimum or (knob.exclusive and val == knob.minimum)):
        bound = f"> {knob.minimum}" if knob.exclusive else f">= {knob.minimum}"
        raise ValueError(f"{name} must be {bound}, got {raw!r}")
    return val
