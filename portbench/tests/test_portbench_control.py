"""The control of ``correct`` fails each cell's limits: the reference put
in the program's place with the guarantee the configuration states
broken (letter files and artifact without the per-document dedup),
judged by the cell's own comparison.  The chip reads the same at each
cell's own size (``control.py``)."""

import subprocess
import sys

import pytest
from portbench_cells import ROOT, tiny

from portbench import bench

CELLS = ["build.zipf100k.stream-device", "build.zipf100k.default"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 3, 2 ** 34 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name, seed):
    c = tiny(name)
    numbers = bench.entry(c["entry"]["kind"]).control(c, seed=seed, seconds=4.0, device="cpu")
    ok, comp = bench.compared(numbers, c["limits"])
    assert not ok, comp


def test_control_reads_on_letters_and_artifact():
    c = tiny(CELLS[0])
    numbers = bench.entry("build").control(c, seed=11, seconds=4.0, device="cpu")
    assert numbers["wrong_letter_files"] == 26
    assert numbers["wrong_artifact_terms"] > 0 and numbers["wrong_artifact_doc_lens"] > 0


def test_no_card_no_control(tmp_path):
    """Without a CUDA card ``control.py`` exits 2 and reads nothing."""
    out = tmp_path / "control.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "control.py"), "--cells", CELLS[0],
         "--seeds", "1", "--out", str(out)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and not out.exists()
    assert "CUDA card" in proc.stderr
