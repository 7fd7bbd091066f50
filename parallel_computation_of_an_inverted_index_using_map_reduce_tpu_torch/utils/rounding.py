"""Shared shape-rounding helper (single definition for the package)."""

from __future__ import annotations


def round_up(n: int, multiple: int) -> int:
    """Smallest positive multiple of ``multiple`` that is >= ``n``.

    Always at least one multiple (n <= 0 rounds to ``multiple``), so
    padded device shapes are never empty.
    """
    return ((max(n, 1) + multiple - 1) // multiple) * multiple
