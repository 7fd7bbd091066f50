"""The port's build spans and counters on the CPU: the streaming
all-device plan's per-window ``read``/``pack``/``scan``/``feed`` steps as
``--stats`` counters and ``--trace-out`` spans under ``stream_feed``, every
phase as a span of its ``--stats`` length, the CLI's ``manifest`` and
``build`` spans and times on the Unix clock, and the host's waits on the
card (``card_wait``) counted into the running build's timer."""

import json
import threading
import time

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import build_index
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import IndexConfig
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.obs import (
    chrometrace,
    timing,
)

pytestmark = pytest.mark.obs

STREAM = ["--device-tokenize", "--stream-chunk-docs", "9", "--artifact"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    docs = tsyn.zipf_corpus(num_docs=31, vocab_size=300, tokens_per_doc=40, seed=4)
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    return root / "list.txt"


def _cli(corpus, out, capsys, *extra):
    capsys.readouterr()
    t0 = time.time()
    rc = main(["4", "26", str(corpus), "--output-dir", str(out), "--device", "cpu",
               "--stats", *extra])
    t1 = time.time()
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    return json.loads(cap.out.strip().splitlines()[-1]), (t0, t1)


def _spans(path):
    doc = json.loads(path.read_text())
    return doc, [e for e in doc["traceEvents"] if e["ph"] == "X"]


def test_stream_plan_counts_a_read_and_a_scan_per_window(corpus, tmp_path, capsys):
    st, _ = _cli(corpus, tmp_path / "out", capsys, *STREAM)
    assert st["stream_windows"] == 4  # 31 documents, 9 a window
    assert len(st["window_read_ms"]) == len(st["window_scan_ms"]) == st["stream_windows"]
    assert all(v >= 0 for v in st["window_read_ms"] + st["window_scan_ms"])
    # the CLI's own times; on the CPU no event is waited on
    assert st["build_ms"] >= st["total_ms"] > 0 and st["manifest_ms"] > 0
    assert "card_wait_ms" not in st


def test_stream_plan_trace_holds_each_window_step(corpus, tmp_path, capsys):
    st, (t0, t1) = _cli(corpus, tmp_path / "out", capsys, *STREAM,
                        "--trace-out", str(tmp_path / "t.json"))
    doc, spans = _spans(tmp_path / "t.json")
    windows = st["stream_windows"]
    for step in ("read", "pack", "scan", "feed"):
        got = [e for e in spans if e["name"] == step]
        assert len(got) == windows
        assert {e["args"]["parent"] for e in got} == {"stream_feed"}
        assert all(e["args"]["cpu_ms"] >= 0 for e in got)
    assert len({e["args"]["build"] for e in spans}) == 1
    # read and pack + scan are the counters, span for span
    reads = [e["dur"] / 1e3 for e in spans if e["name"] == "read"]
    assert reads == pytest.approx(st["window_read_ms"], abs=2e-3)
    # every phase is a span of its --stats length, under the build span
    for phase, ms in st["phases_ms"].items():
        got = [e for e in spans if e["name"] == phase]
        assert sum(e["dur"] for e in got) / 1e3 == pytest.approx(ms, abs=1.0)
        assert {e["args"]["parent"] for e in got} == {"build"}
    # the build span on the Unix clock, inside the wall time of the call
    base = doc["baseTimeNanoseconds"] / 1e9
    (build,) = [e for e in spans if e["name"] == "build"]
    (manifest,) = [e for e in spans if e["name"] == "manifest"]
    assert t0 <= base + manifest["ts"] / 1e6 <= base + build["ts"] / 1e6
    assert base + (build["ts"] + build["dur"]) / 1e6 <= t1
    assert build["args"]["parent"] is None and manifest["args"]["parent"] is None
    assert build["dur"] / 1e3 == pytest.approx(st["build_ms"], abs=1.0)


def test_library_callers_get_the_same_keys(corpus, tmp_path):
    m = tman.read_manifest(corpus)
    cfg = IndexConfig(device="cpu", device_tokenize=True, stream_chunk_docs=9,
                      trace_out=str(tmp_path / "t.json"))
    st = build_index(m, cfg, output_dir=str(tmp_path / "out"))
    assert not {"manifest_ms", "build_ms", "card_wait_ms"} & set(st)
    _, spans = _spans(tmp_path / "t.json")
    # its own collector: the phases are the top spans
    assert {e["args"]["parent"] for e in spans if e["name"] in st["phases_ms"]} == {None}


def test_card_wait_counts_into_the_running_build():
    trace = chrometrace.TraceEvents()
    timer = timing.PhaseTimer(trace)
    outer = timing.current()
    timing.make_current(timer)
    try:
        with timer.phase("device_index"):
            timing.wait_on_card(lambda: time.sleep(0.002))
        timing.wait_on_card(lambda: None)
    finally:
        timing.make_current(outer)
    timing.wait_on_card(lambda: None)  # outside a build: counted nowhere
    assert timer.report()["card_wait_ms"] >= 2.0
    waits = [e for e in trace._events if e["name"] == "card_wait"]
    assert [e["args"]["parent"] for e in waits] == ["device_index", None]
    assert "card_wait_ms" not in timing.PhaseTimer().report()


def test_a_step_that_raised_records_nothing():
    trace = chrometrace.TraceEvents()
    with pytest.raises(StopIteration):
        with timing.Step("read", trace) as step:
            next(iter(()))
    assert step.ms is None and trace._events == [] and trace.innermost() is None
    with timing.Step("read", trace, cpu=True) as step:
        pass
    (ev,) = trace._events
    assert step.ms >= 0 and ev["args"]["cpu_ms"] >= 0 and ev["args"]["parent"] is None


def test_a_worker_span_nests_in_the_phase_open_on_the_main_thread():
    trace = chrometrace.TraceEvents()
    timer = timing.PhaseTimer(trace)
    with timer.phase("merge"):
        worker = threading.Thread(
            target=lambda: trace.span("read", 0.0, 1.0, tid=chrometrace.READER_BASE))
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    assert {e["name"]: e["args"]["parent"] for e in trace._events} == {
        "read": "merge", "merge": None}
