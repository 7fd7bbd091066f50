"""The ``MRI_*`` environment knobs this package reads.

Each is declared once with its name, type and default, the same as the
JAX package's declaration of it, so one setting drives both packages.
:func:`get` reads one; a malformed value raises a ``ValueError`` naming
the variable, which the CLI turns into exit 2.
"""

from __future__ import annotations

import os
from typing import Any, Callable


_KNOBS: dict[str, tuple[Callable[[str], Any], Any]] = {
    # snapshot-tax budget: a projected stream-checkpoint save slower
    # than this many seconds is skipped (recorded, not paid)
    "MRI_TPU_CKPT_BUDGET_S": (float, 120.0),
    # assumed device->host rate (MB/s) seeding the checkpoint cost
    # projection; re-calibrated from each measured save
    "MRI_TPU_CKPT_LINK_MBPS": (float, 8.0),
    # most consecutive over-budget checkpoint skips before one save is
    # forced
    "MRI_TPU_CKPT_STRETCH": (int, 4),
    # test hook: raise after this device-stream window (0: disabled)
    "MRI_TPU_STREAM_CRASH_AFTER_WINDOWS": (int, 0),
}


def get(name: str) -> Any:
    """The knob's parsed value from the environment, or its default."""
    cast, default = _KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a valid {cast.__name__}") from None
