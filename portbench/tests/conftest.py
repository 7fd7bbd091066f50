"""Fixtures of the benchmark's own tests: a scratch temp root per test,
and the look for a CUDA card."""

from __future__ import annotations

import pytest


@pytest.fixture
def tmp_root(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path


@pytest.fixture
def cuda():
    """Skip without a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch
