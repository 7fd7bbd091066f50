"""The four-card cell ``build.zipf100k.mesh4`` cut to a size the CPU runs
in seconds (120 documents, windows of 40, four mesh positions on the
CPU): a sound traced run is correct and reads the mesh's own metrics,
a broken one is not, and each of the mesh's readers reads a record of
the shape the build entry writes, or nothing where its counter is
absent (as in the one-card plan's builds)."""

import time

import pytest
from portbench_cells import ROOT  # noqa: F401  (puts the checkout on sys.path)
from test_portbench_faults import _flip_a_byte, _half_the_documents

from portbench import bench, run

CELL = "build.zipf100k.mesh4"
MESH_METRICS = ("exchange_mb.build", "exchange_fill.build", "owner_skew.build")


def _tiny() -> dict:
    c = bench.cell(CELL)
    c["config_params"]["documents"] = 120
    c["config_params"]["generator"]["vocab"] = 3000
    c["mix"]["argv"] = ["40" if a == "10000" else a for a in c["mix"]["argv"]]
    return c


def _run(trace: bool) -> dict:
    return run.run_cell(CELL, 2 ** 31 + 45, 1.0, trace, device="cpu", t0=time.monotonic(),
                        cell=_tiny())


def test_cell_runs_the_mesh_and_reads_its_metrics(tmp_root):
    line = _run(True)
    assert line["correct"] is True, line["compared"]
    got = line["metrics"]
    for name in MESH_METRICS + ("read_ms.build", "scan_ms.build", "card_wait_ms.build"):
        assert got[name]["value"] is not None, name
    assert 0 < got["exchange_fill.build"]["value"] < 100
    assert got["owner_skew.build"]["value"] >= 1
    # a CPU run reads no card's peak
    assert "peak_card_bytes.build" not in got and "peak_device_bytes.build" not in got


@pytest.mark.parametrize("fault", [_flip_a_byte, _half_the_documents],
                         ids=lambda f: f.__name__)
def test_broken_mesh_build_is_not_correct(tmp_root, monkeypatch, fault):
    fault(monkeypatch)
    line = _run(False)
    assert line["correct"] is False, line["compared"]


MESH_BUILD = {"phases_ms": {"stream_feed": 9000.0}, "exchange_bytes": 1_444_000_000,
              "exchange_valid_rows": 60_000_000, "exchange_valid_bytes": 720_000_000,
              "owner_rows": [7_000_000, 7_100_000, 6_900_000, 7_000_000],
              "card_peak_bytes": [3_000_000_000, 3_100_000_000, 2_900_000_000, 3_000_000_000]}
RECORD = {"builds": [MESH_BUILD, dict(MESH_BUILD, exchange_bytes=1_440_000_000,
                                      card_peak_bytes=[3_200_000_000] * 4)]}
WANT = {
    "exchange_mb.build": (1444.0 + 1440.0) / 2,
    "exchange_fill.build": 100 * 720_000_000 * (1 / 1_444_000_000 + 1 / 1_440_000_000) / 2,
    "owner_skew.build": 7_100_000 / 7_000_000,
    "peak_card_bytes.build": 3_200_000_000.0,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_mesh_reader_reads(name):
    assert bench.read_metric(name, RECORD) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_mesh_reader_reads_nothing_without_its_counter(name):
    one_card = {"builds": [{"phases_ms": {"stream_feed": 3000.0}, "window_read_ms": [1.0]}]}
    assert bench.read_metric(name, one_card) is None
    assert bench.read_metric(name, {"builds": []}) is None
