"""The readers of the build's spans and counters on records of the shape
the build entry writes (a number where the port reports the key, None
where it does not, as the parent commit's port does not), and the idle-gap
labeller that names a gap after the innermost program span, falling back
to the entry's phase labels where no span covers it."""

import json
import subprocess
import sys
import time

import pytest
from portbench_cells import ROOT, tiny

from portbench import bench, spans

STREAM = {"phases_ms": {"stream_feed": 3000.0, "device_index": 15.0, "emit": 1200.0},
          "total_ms": 4215.0}
BUILDS = {"builds": [
    dict(STREAM, window_read_ms=[100.0, 200.0], window_scan_ms=[50.0, 70.0],
         card_wait_ms=12.0, manifest_ms=900.0, build_ms=4515.0),
    dict(STREAM, window_read_ms=[300.0, 400.0], window_scan_ms=[30.0, 10.0],
         card_wait_ms=8.0, manifest_ms=1100.0, build_ms=4415.0),
]}
WANT = {"read_ms.build": 500.0, "scan_ms.build": 80.0, "card_wait_ms.build": 10.0,
        "manifest_ms.build": 1000.0, "unphased_ms.build": 250.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_stream_plan(name):
    assert bench.read_metric(name, BUILDS) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_its_key(name):
    assert bench.read_metric(name, {"builds": [dict(STREAM), dict(STREAM)]}) is None


def _span(name, parent, start, end, cpu_ms=None):
    return {"name": name, "parent": parent, "start": start, "end": end, "cpu_ms": cpu_ms}


SPANS = [_span("manifest", None, 0.0, 1.0), _span("build", None, 1.5, 10.0),
         _span("stream_feed", "build", 2.0, 8.0),
         _span("read", "stream_feed", 2.0, 3.0, cpu_ms=400.0),
         _span("feed", "stream_feed", 4.0, 6.0), _span("card_wait", "feed", 5.0, 5.5),
         _span("emit", "build", 8.5, 9.5)]


@pytest.mark.parametrize("t, want", [
    (0.5, "manifest"), (2.5, "stream_feed/read"), (4.5, "stream_feed/feed"),
    (5.2, "feed/card_wait"), (3.5, "build/stream_feed"), (8.2, "build/unphased"),
    (9.0, "build/emit"), (1.2, "cli: fallback"), (11.0, "cli: fallback")])
def test_labeller_names_the_innermost_span(t, want):
    fell_back: set = set()
    label = spans.labeller(SPANS, lambda t: "cli: fallback", fell_back)
    assert label(t) == want
    assert fell_back == ({want} if want.startswith("cli") else set())


def test_labelled_share_leaves_out_the_time_between_builds():
    gaps = [["stream_feed/read", 3.0], ["phase emit", 1.0],
            ["harness: checks between builds", 5.0]]
    assert spans.span_labelled_share(gaps, {"phase emit"}) == pytest.approx(75.0)
    assert spans.span_labelled_share([["harness: checks between builds", 1.0]], set()) is None


def test_idle_gaps_split_by_spans_fall_back_where_none_covers():
    fell_back: set = set()
    label = spans.labeller(SPANS, lambda t: "phase stream_feed", fell_back)
    # whole gaps take the label of their midpoint
    gaps = bench.idle_gaps([(1.2, 4.1), (5.4, 8.4)], 0.0, 12.0, label)
    assert dict(gaps) == pytest.approx({"manifest": 1.2, "stream_feed/feed": 1.3,
                                        "phase stream_feed": 3.6})
    # cut at the spans' ends, a gap is shared among the spans it runs through
    gaps = spans.split_idle_gaps([(1.2, 4.1), (5.4, 8.4)], 0.0, 12.0, SPANS, label)
    assert dict(gaps) == pytest.approx({
        "manifest": 1.0, "stream_feed/feed": 0.9, "feed/card_wait": 0.4,
        "build/unphased": 0.6, "build/emit": 1.0, "phase stream_feed": 2.2})
    assert sum(s for _, s in gaps) == pytest.approx(1.2 + 1.3 + 3.6)
    assert fell_back == {"phase stream_feed"}


def test_span_time_per_build_by_parent():
    two = [SPANS, [_span("manifest", None, 20.0, 21.0), _span("build", None, 21.0, 22.0)]]
    got = spans.span_ms_per_build(two)
    assert got["manifest"] == pytest.approx([1000.0, None])
    assert got["build"] == pytest.approx([4750.0, None])
    assert got["stream_feed/read"] == pytest.approx([500.0, 200.0])
    assert got["feed/card_wait"] == pytest.approx([250.0, None])
    assert spans.span_ms_per_build([]) == {}


def test_a_rebased_trace_has_no_spans(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"name": "emit", "ph": "X", "ts": 0.0, "dur": 5.0, "pid": 0, "tid": 0}]}))
    assert spans.read(path) == []
    path.write_text(json.dumps({"baseTimeNanoseconds": 2_000_000_000, "traceEvents": [
        {"name": "emit", "ph": "X", "ts": 1e6, "dur": 5e5, "pid": 0, "tid": 0,
         "args": {"parent": "build", "cpu_ms": 2.5}}]}))
    assert spans.read(path) == [_span("emit", "build", 3.0, 3.5, cpu_ms=2.5)]


def test_traced_run_reads_the_new_metrics_on_the_cpu(tmp_root, capsys):
    c = tiny("build.zipf100k.stream-device")
    mod = bench.entry("build")
    got = spans.traced(mod)
    out = mod.run(c, seed=2**31 + 29, seconds=0.2, trace=True, device="cpu",
                  t0=time.monotonic())
    assert bench.compared(out["numbers"], c["limits"])[0]
    names = {s["name"] for s in got["spans"]}
    assert {"manifest", "build", "stream_feed", "read", "pack", "scan", "feed"} <= names
    assert len(got["builds"]) == len(out["record"]["builds"]) + 1  # and the warm-up
    for name in ("read_ms.build", "scan_ms.build", "manifest_ms.build", "unphased_ms.build"):
        assert bench.read_metric(name, out["record"]) is not None
    assert bench.read_metric("card_wait_ms.build", out["record"]) is None  # no card
    assert "wall - build_ms - manifest_ms" in capsys.readouterr().err
    assert not list(tmp_root.rglob("spans.*.json"))


def test_no_card_no_span_run(tmp_root):
    """Without a CUDA card the span run exits 2 and prints no result."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "spans.py"), "--workload",
         "build.zipf100k.stream-device", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_root), "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "needs a CUDA card" in proc.stderr
