"""On the card: tiny runs of the build cells through the whole harness,
traced, with the card's name and busy time in the line.
Skipped without a CUDA card; on the chip:
``python -m pytest -q -m cuda portbench/tests/test_portbench_cuda.py``."""

import time

import pytest
from portbench_cells import tiny

from portbench import run

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["build.zipf100k.stream-device", "build.zipf100k.default"])
def test_traced_run_on_the_card(cuda, tmp_root, name):
    line = run.run_cell(name, 2 ** 31 + 5, 2.0, True, device="cuda", t0=time.monotonic(),
                        cell=tiny(name))
    assert line["correct"] is True, line["compared"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["busy_s"] > 0
    assert dev["kind"] == cuda.cuda.get_device_name(0)
    assert line["breakdown"]["device_ops"]
