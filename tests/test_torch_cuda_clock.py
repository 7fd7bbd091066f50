"""The program's spans and the card's kernels on one clock: a span
recorded around a sleep kernel and its synchronize holds the kernel's
interval in the ``torch.profiler`` trace, each end within 1 ms; and a
streaming all-device build on the card counts its waits on the card
(``card_wait_ms``, ``card_wait`` spans inside ``feed`` or ``device_index``).
Every test needs a CUDA device and skips without one; none needs JAX, so
on the card ``python -m pytest --noconftest tests/test_torch_cuda_clock.py
-m cuda -s`` runs them and prints the offsets."""

import json

import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.obs import (
    chrometrace,
    timing,
)

pytestmark = pytest.mark.cuda

#: the sleep kernel's length
SLEEP_S = 5e-3


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _sleep_cycles(seconds: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that take about ``seconds`` here."""
    probe = 1_000_000
    torch.cuda._sleep(probe)  # the first launch loads the kernel
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * seconds * 1e3 / start.elapsed_time(end))


def test_span_holds_the_kernel_on_the_profiler_clock(tmp_path):
    _need_cuda()
    from portbench import bench, spans

    cycles = _sleep_cycles(SLEEP_S)
    torch.cuda.synchronize()
    trace = chrometrace.TraceEvents()
    with bench.Profile(torch, tmp_path) as prof:
        with timing.Step("sleep", trace):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
    dev = prof.read()
    trace.write(str(tmp_path / "spans.json"))
    (span,) = spans.read(tmp_path / "spans.json")
    k0, k1 = max(dev["intervals"], key=lambda iv: iv[1] - iv[0])
    start_ms, end_ms = (k0 - span["start"]) * 1e3, (span["end"] - k1) * 1e3
    print(f"sleep kernel {(k1 - k0) * 1e3:.3f} ms in a span of "
          f"{(span['end'] - span['start']) * 1e3:.3f} ms: kernel start - span start "
          f"{start_ms:.3f} ms, span end - kernel end {end_ms:.3f} ms ({torch.cuda.get_device_name(0)})")
    assert (k1 - k0) > SLEEP_S / 2
    assert -1.0 < start_ms < 1.0 and -1.0 < end_ms < 1.0


def test_stream_build_on_the_card_counts_its_waits(tmp_path, capsys):
    _need_cuda()
    docs = tsyn.zipf_corpus(num_docs=40, vocab_size=500, tokens_per_doc=60, seed=6)
    tman.write_manifest(tmp_path / "list.txt", tsyn.write_corpus(tmp_path / "docs", docs))
    capsys.readouterr()
    rc = main(["4", "26", str(tmp_path / "list.txt"), "--output-dir", str(tmp_path / "out"),
               "--stats", "--device-tokenize", "--stream-chunk-docs", "8",
               "--trace-out", str(tmp_path / "t.json")])
    st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and st["card_wait_ms"] > 0
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    waits = [e for e in events if e["name"] == "card_wait"]
    assert waits and {e["args"]["parent"] for e in waits} <= {"feed", "device_index", "fetch"}
    assert sum(e["dur"] for e in waits) / 1e3 == pytest.approx(st["card_wait_ms"], abs=0.01)
