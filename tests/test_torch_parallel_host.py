"""The port's multi-worker host map/reduce (``backend="cpu"``: K scan
workers on the steal queue, the native merge, M letter reducers)
against the JAX package's and the oracle.

Scheduling — worker count, reducer count, the steal order — may reorder
work but never bytes.  ``host_threads`` follows the rule both packages
document (``IndexConfig.resolved_host_threads``): ``num_mappers`` when
it is above 1, else the default thread count.  The JAX matrix test
asserts ``host_threads == num_mappers`` and so fails at one mapper; this
twin asserts the documented rule instead (ROADMAP §C)."""

import os

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import native as jnative
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import faults, native
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus.scheduler import (
    plan_letter_ranges,
)

from conftest import read_letter_files
from test_torch_cpu_backend import _disarm, build_both, corpus_pair, stable  # noqa: F401

pytestmark = pytest.mark.parallel_host


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The 29-document corpus of the JAX suite and its oracle bytes."""
    root = tmp_path_factory.mktemp("parallel")
    tm, jm, _ = corpus_pair(root)
    tpkg.oracle_index(tm, str(root / "oracle"))
    return tm, jm, read_letter_files(root / "oracle")


@pytest.mark.parametrize("mappers", [1, 2, 4])
@pytest.mark.parametrize("reducers", [1, 3, 26])
def test_parallel_cpu_matrix_matches_oracle_and_jax(tmp_path, golden, mappers, reducers):
    tm, jm, want = golden
    env = {"MRI_CPU_WINDOW_BYTES": "512"}
    cfg = tpkg.IndexConfig(backend="cpu", num_mappers=mappers, num_reducers=reducers,
                           io_prefetch=2)
    r, js = build_both(tm, jm, tmp_path, env=env, num_mappers=mappers,
                       num_reducers=reducers, io_prefetch=2)
    assert read_letter_files(tmp_path / "port") == want
    assert read_letter_files(tmp_path / "jax") == want
    assert stable(r) == stable(js)
    threads = cfg.resolved_host_threads()
    assert r["host_threads"] == threads
    assert threads == (mappers if mappers > 1 else native.default_threads())
    assert r["io_windows"] > mappers  # the plan really shards
    if threads > 1 or reducers > 1:
        assert r["reduce_workers"] == reducers
        assert len(r["stage_read_ms_per_worker"]) == threads
        assert len(r["stage_tokenize_ms_per_worker"]) == threads
        assert len(r["stage_emit_ms_per_reducer"]) == reducers


@pytest.mark.parametrize("seed", [1, 42, 20260805])
def test_steal_order_shuffle_never_changes_output(seed, tmp_path):
    tm, jm, _ = corpus_pair(tmp_path, num_docs=37, seed=2)
    tpkg.oracle_index(tm, str(tmp_path / "oracle"))
    build_both(tm, jm, tmp_path, env={"MRI_CPU_WINDOW_BYTES": "512",
                                      "MRI_STEAL_SHUFFLE_SEED": str(seed)},
               num_mappers=3, num_reducers=4)
    want = read_letter_files(tmp_path / "oracle")
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax") == want


@pytest.mark.native_san
@pytest.mark.parametrize("mappers,reducers", [(1, 1), (2, 3), (4, 26)])
def test_port_host_matrix_matches_oracle(tmp_path, golden, mappers, reducers, monkeypatch):
    """The port's half of the (K, M) matrix alone: scan workers on the
    steal queue, the native merge and the letter reducers."""
    tm, _, want = golden
    monkeypatch.setenv("MRI_CPU_WINDOW_BYTES", "512")
    r = tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", num_mappers=mappers,
                                              num_reducers=reducers, io_prefetch=2),
                         output_dir=str(tmp_path / "port"))
    assert "cpu_fallback" not in r
    assert read_letter_files(tmp_path / "port") == want


@pytest.mark.native_san
def test_host_threads_flag_drives_workers(tmp_path):
    tm, _, _ = corpus_pair(tmp_path, num_docs=11, seed=1)
    r = tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", num_mappers=1, host_threads=3),
                         output_dir=str(tmp_path / "ht"))
    assert r["host_threads"] == 3 and len(r["stage_read_ms_per_worker"]) == 3


def _split_feed(mod, contents, ids, order, parts):
    streams = [mod.HostIndexStream() for _ in range(parts)]
    for k, i in enumerate(order):
        streams[k % parts].feed([contents[i]], [ids[i]])
    for s in streams:
        assert s.partial()["partial_ms"] >= 0.0
    return streams


@pytest.mark.parametrize("order", ["plan", "reversed"])
def test_host_merge_matches_single_stream_and_jax(order, tmp_path):
    """Three streams merged and emitted over five letter ranges equal one
    stream's finalize — also when a worker fed its windows out of plan
    order (``partial()`` re-sorts each run) — and the JAX merge."""
    tm, _, _ = corpus_pair(tmp_path, num_docs=31, vocab_size=400, tokens_per_doc=50, seed=4)
    contents, ids = tman.load_documents(tm)
    with native.HostIndexStream() as single:
        single.feed(contents, ids)
        stats = single.finalize_emit(tmp_path / "single")
    idx = list(range(len(ids)))
    if order == "reversed":
        idx.reverse()
    outs = {}
    for name, mod in (("port", native), ("jax", jnative)):
        streams = _split_feed(mod, contents, ids, idx, 3)
        try:
            with mod.HostIndexMerge(streams) as merge:
                total = sum(merge.emit_range(lo, hi, tmp_path / name)
                            for lo, hi in plan_letter_ranges(5))
                outs[name] = (total, merge.stats(), merge.audit())
        finally:
            for s in streams:
                s.close()
    total, mstats, audit = outs["port"]
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "single")
    assert read_letter_files(tmp_path / "jax") == read_letter_files(tmp_path / "single")
    assert total == stats["bytes_written"] == outs["jax"][0]
    assert audit == outs["jax"][2] == (0, -1)
    for key in ("unique_terms", "tokens", "unique_pairs", "documents"):
        assert mstats[key] == stats[key] == outs["jax"][1][key]


@pytest.mark.native_san
@pytest.mark.parametrize("order", ["plan", "reversed"])
def test_host_merge_matches_single_stream(order, tmp_path):
    """The port's half of the merge test alone: three streams, one of
    them fed out of plan order, merged and emitted over five letter
    ranges, equal one stream's finalize."""
    tm, _, _ = corpus_pair(tmp_path, num_docs=31, vocab_size=400, tokens_per_doc=50, seed=4)
    contents, ids = tman.load_documents(tm)
    with native.HostIndexStream() as single:
        single.feed(contents, ids)
        stats = single.finalize_emit(tmp_path / "single")
    idx = list(range(len(ids)))[::-1 if order == "reversed" else 1]
    streams = _split_feed(native, contents, ids, idx, 3)
    try:
        with native.HostIndexMerge(streams) as merge:
            total = sum(merge.emit_range(lo, hi, tmp_path / "port")
                        for lo, hi in plan_letter_ranges(5))
            assert merge.audit() == (0, -1)
            assert merge.stats()["unique_pairs"] == stats["unique_pairs"]
    finally:
        for s in streams:
            s.close()
    assert total == stats["bytes_written"]
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "single")


@pytest.mark.native_san
def test_handles_free_exactly_once():
    """close, the context manager and __del__ each free a handle once."""
    s = native.HostIndexStream()
    s.feed([b"alpha beta"], [1])
    s.partial()
    with native.HostIndexMerge([s]) as m:
        assert m.stats()["unique_terms"] == 2
    assert m._handle is None and m._streams == []
    m.close()  # idempotent
    s.close()
    assert s._handle is None
    s.close()
    s.__del__()
    with native.HostIndexStream() as s2:
        pass
    assert s2._handle is None


def test_degradation_report_merge_equals_jax():
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import faults as jfaults

    sums = []
    for mod in (faults, jfaults):
        a, b = mod.DegradationReport(), mod.DegradationReport()
        a.record_retry()
        b.record_retry()
        b.record_retry()
        b.record_skip(doc_id=7, path="x", reason="boom")
        b.record_worker_recovery(windows_requeued=3)
        b.record_reducer_takeover()
        a.record_worker_recovery(windows_requeued=1)
        a.merge(b)
        a.merge(a)  # a self-merge is a no-op
        c = mod.DegradationReport()
        c.record_worker_recovery(windows_requeued=2)
        sums.append((a.summary(), b.summary(), b.degraded, c.degraded))
    assert sums[0] == sums[1]
    assert sums[0][0]["worker_recoveries"] == 2 and sums[0][0]["windows_requeued"] == 4
    assert sums[0][2] and not sums[0][3]  # recoveries alone are not degraded


def test_multi_worker_degraded_run_reports_all_skips(tmp_path):
    tm, jm, _ = corpus_pair(tmp_path, num_docs=12, seed=3)
    os.unlink(tm.paths[5])  # hard skip: no retry can save it
    r, js = build_both(tm, jm, tmp_path, num_mappers=3, num_reducers=2)
    assert r["degradation"]["skipped_docs"] == [6]
    assert r["degradation"] == js["degradation"]
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax")


@pytest.mark.native_san
def test_reducers_over_26_in_memory_path_warns(tmp_path, caplog):
    """The in-memory letter reduce keeps the reference's degenerate
    M > 26 ranges, and says so."""
    tm, _, _ = corpus_pair(tmp_path)
    with caplog.at_level("WARNING"):
        r = tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", num_mappers=2,
                                                  num_reducers=30),
                             output_dir=str(tmp_path / "out"))
    assert r["reduce_workers"] == 30
    assert any("exceeds the 26 letter partitions" in rec.message for rec in caplog.records)
