"""Each per-layer reader on a record of the shape its entry writes: a
number where there is something to read, None where there is not (never
0 for a share of a roofline)."""

import pytest

from portbench import bench

BUILD = {"builds": [{"phases_ms": {"stream_feed": 3000.0, "device_index": 15.0, "emit": 1200.0}},
                    {"phases_ms": {"stream_feed": 3200.0, "device_index": 17.0, "emit": 1000.0}}],
         "window_s": 20.0, "corpus_bytes": 159_400_000, "unique_pairs": 7_000_000,
         "peak_window_bytes": 2_477_242_880, "device_kind": "NVIDIA H100 80GB HBM3",
         "busy_s": 0.25}
WANT = {
    "feed_ms.build": (BUILD, 3100.0), "device_index_ms.build": (BUILD, 16.0),
    "emit_ms.build": (BUILD, 1100.0), "index_mb_s.build": (BUILD, 2 * 159.4 / 20.0), "device_idle_share.build": (BUILD, 98.75),
    "peak_device_bytes.build": (BUILD, 2_477_242_880.0),
    "device_roofline.build": (BUILD, 100 * (159_400_000 + 8 * 7_000_000) / 3.35e12 / 0.125),
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads(name):
    record, want = WANT[name]
    assert bench.read_metric(name, record) == pytest.approx(want)


def test_read_ms_only_where_a_reader_thread_reports():
    assert bench.read_metric("read_ms.build", BUILD) is None
    rec = dict(BUILD, builds=[{"phases_ms": {}, "window_read_ms": [1.0, 2.0]},
                              {"phases_ms": {}, "window_read_ms": [3.0]}])
    assert bench.read_metric("read_ms.build", rec) == pytest.approx(3.0)


@pytest.mark.parametrize("name", ["device_roofline.build", "device_idle_share.build"])
def test_no_device_trace_reads_nothing(name):
    assert bench.read_metric(name, {**BUILD, "busy_s": None}) is None


def test_rate_reads_nothing_without_a_build():
    assert bench.read_metric("index_mb_s.build", dict(BUILD, builds=[])) is None


def test_roofline_reads_nothing_on_an_unknown_card():
    assert bench.read_metric("device_roofline.build", dict(BUILD, device_kind="cpu")) is None
