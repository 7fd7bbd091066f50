"""The result line: its keys and their shapes, from whole runs of each
build plan on the CPU (the harness's look for a card skipped)."""

import json
import subprocess
import sys
import time

import pytest
from portbench_cells import ROOT, tiny

from portbench import bench, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _check(line: dict, c: dict, trace: bool) -> None:
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "compared"
    assert set(keys) <= set(KEYS) | {"breakdown", "compared"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = [m["name"] for m in (c["per_layer"] if trace else c["end_to_end"])]
    assert set(line["metrics"]) <= set(want)
    if not trace:
        # a CPU run has no device trace to read
        assert list(line["metrics"]) == [m["name"] for m in c["end_to_end"]
                                         if m["source"] != "device_trace"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for k, v in line["compared"].items():
        assert set(v) == {"value", "limit"} and v["limit"] == c["limits"][k]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    json.dumps(line)


@pytest.mark.parametrize("name", ["build.zipf100k.default", "build.zipf100k.stream-device"])
@pytest.mark.parametrize("trace", [0, 1])
def test_line_shape(tmp_root, name, trace):
    c = tiny(name)
    line = run.run_cell(name, 2 ** 31 + 9, 1.0, bool(trace), device="cpu",
                        t0=time.monotonic(), cell=c)
    _check(line, c, bool(trace))
    assert line["metrics"] or trace


def test_no_card_no_result(tmp_root):
    """Without a CUDA card the command exits 2 and prints no result."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "build.zipf100k.default", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_root), "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_unknown_cell_exits_nonzero():
    with pytest.raises(SystemExit):
        bench.cell("no.such.cell")

