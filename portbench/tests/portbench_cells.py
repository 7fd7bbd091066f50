"""Cells shrunk to a size the CPU runs in seconds, for the benchmark's tests."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import bench  # noqa: E402

#: the tiny sizes the CPU tests run each configuration at
TINY = {"zipf100k-docs20k": {"documents": 120, "vocab": 3000}}


def tiny(name: str, **extra) -> dict:
    """A cell as ``bench.cell`` gives it, cut to the tests' size."""
    c = bench.cell(name)
    cfg = c["config_params"]
    for key, value in TINY[cfg["name"]].items():
        if key == "vocab":
            cfg["generator"]["vocab"] = value
        else:
            cfg[key] = value
    c["mix"]["argv"] = ["40" if a == "2500" else a for a in c["mix"]["argv"]]
    c.update(extra)
    return c
