"""The port's default build end to end on the CPU: the pipelined plan
(native scan, provisional-key windows, one device sort), the one-shot
plan over the native combiner (``pipeline_chunk_docs=0`` and the
``KeyOverflow`` restart), and the CLI — letter files byte-equal to the
JAX package's same plan (``backend='tpu', device_shards=1,
pad_multiple=64``) and to the oracle, with the same phases and counters.
Corpora are made from a seed with numpy."""

import json

import numpy as np
import pytest

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import native as jnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native as tnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
    inverted_index as tmodel,
)

from conftest import read_letter_files

pytestmark = pytest.mark.skipif(
    not (tnative.available() and jnative.available()), reason="no C++ toolchain")

PIPELINED_PHASES = {"tokenize_feed", "finalize_vocab", "device_index", "fetch", "emit"}
PIPELINED_COUNTERS = ("host_threads", "window_plan_bytes", "window_imbalance",
                      "upload_windows", "documents", "tokens", "unique_terms",
                      "unique_pairs", "lines_written")


def _port_cfg(**kw):
    kw.setdefault("pad_multiple", 64)
    return tpkg.IndexConfig(device="cpu", **kw)


def _jax_cfg(**kw):
    kw.setdefault("pad_multiple", 64)
    return JaxConfig(backend="tpu", device_shards=1, **kw)


def _word(i: int) -> bytes:
    s = ""
    while True:
        s += chr(ord("a") + i % 26)
        i //= 26
        if not i:
            return s.encode()


def _manifest(tmp_path, docs, name="corpus"):
    paths = tsyn.write_corpus(tmp_path / name, docs)
    list_path = tmp_path / f"{name}.txt"
    tman.write_manifest(list_path, paths)
    return list_path


def _build_both(list_path, tmp_path, port_kw=None, jax_kw=None):
    """Build with the port and with the JAX package; returns both stats
    after asserting the letter files are byte-equal."""
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(**(port_kw or {})),
                          output_dir=str(tmp_path / "torch"))
    sj = jpkg.build_index(jpkg.read_manifest(list_path), _jax_cfg(**(jax_kw or {})),
                          output_dir=str(tmp_path / "jax"))
    assert read_letter_files(tmp_path / "torch") == read_letter_files(tmp_path / "jax")
    return st, sj


def _oracle_bytes(list_path, tmp_path):
    tpkg.oracle_index(tpkg.read_manifest(list_path), tmp_path / "oracle")
    return read_letter_files(tmp_path / "oracle")


ZIPF = dict(num_docs=41, vocab_size=700, tokens_per_doc=80)


# -- the pipelined plan against the JAX package ---------------------------


@pytest.mark.parametrize("chunk_docs", [1, 2, 7, None])
@pytest.mark.parametrize("seed", [3, 8])
def test_pipelined_matches_jax_and_oracle(chunk_docs, seed, tmp_path):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(**ZIPF, seed=seed))
    kw = {"pipeline_chunk_docs": chunk_docs}
    st, sj = _build_both(list_path, tmp_path, kw, kw)
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)
    assert set(st["phases_ms"]) == set(sj["phases_ms"]) == PIPELINED_PHASES
    for key in PIPELINED_COUNTERS:
        assert st[key] == sj[key], key
    assert st["upload_windows"] == (2 if chunk_docs is None else -(-41 // chunk_docs))
    assert set(st["window_modes"]) == {"u16"}
    assert len(st["window_wait_ms"]) == len(st["window_scan_ms"]) == st["upload_windows"]


@pytest.mark.parametrize("chunk_docs", [1, 2, 100, None])
def test_pipelined_matches_the_smoke_golden(chunk_docs, smoke_fixture, tmp_path, monkeypatch):
    monkeypatch.chdir(smoke_fixture)
    stats = tpkg.build_index(tpkg.read_manifest("manifest.txt"),
                             _port_cfg(pipeline_chunk_docs=chunk_docs),
                             output_dir=str(tmp_path))
    assert "tokenize_feed" in stats["phases_ms"]
    assert read_letter_files(tmp_path) == read_letter_files(smoke_fixture / "golden")


def test_u16_windows_switch_to_int32_keys_like_jax(tmp_path):
    """The second window's provisional ids pass 0xFFFF: it uploads int32
    keys while the first stays uint16 (tests/test_pipelined.py:77)."""
    n = 0x10000 + 50
    docs = [b" ".join(_word(i) for i in range(n // 2)),
            b" ".join(_word(i) for i in range(n // 2, n))]
    list_path = _manifest(tmp_path, docs)
    kw = {"pipeline_chunk_docs": 1}
    st, sj = _build_both(list_path, tmp_path, kw, kw)
    assert st["window_modes"] == ["u16", "keys"]
    assert st["unique_terms"] == sj["unique_terms"] == n
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)


@pytest.mark.parametrize("threads", [1, 3])
def test_host_threads_are_output_invariant(threads, tmp_path):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(num_docs=37, vocab_size=500,
                                                     tokens_per_doc=120, seed=5))
    kw = {"host_threads": threads}
    st, _ = _build_both(list_path, tmp_path, kw, kw)
    assert st["host_threads"] == threads
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)


@pytest.mark.parametrize("backend", ["auto", "native", "python"])
def test_emit_backends_write_the_same_bytes_as_jax(backend, tmp_path):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(**ZIPF, seed=1))
    kw = {"emit_backend": backend}
    _build_both(list_path, tmp_path, kw, kw)
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)


@pytest.mark.parametrize("plan", [{}, {"pipeline_chunk_docs": 0}])
def test_empty_corpus_writes_26_empty_files(plan, tmp_path):
    list_path = _manifest(tmp_path, [b"   \n\t \n", b"123 ... !!"])
    st, sj = _build_both(list_path, tmp_path, plan, plan)
    files = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert files == [f"{chr(97 + i)}.txt" for i in range(26)]
    assert read_letter_files(tmp_path / "torch") == b""
    assert st["unique_terms"] == sj["unique_terms"] == 0
    assert set(st["phases_ms"]) == set(sj["phases_ms"])


# -- the one-shot plan over the native combiner ---------------------------


def _big_vocab_docs():
    """70,000 distinct words and repeats: past the u16 engine's vocab."""
    words = [_word(i) for i in range(70_000)]
    rng = np.random.default_rng(2)
    per_doc = [[] for _ in range(30)]
    for i, w in enumerate(words):
        per_doc[i % 30].append(w)
    for idx in rng.integers(0, len(words), 20_000):
        per_doc[int(rng.integers(0, 30))].append(words[int(idx)])
    return [b" ".join(ws) for ws in per_doc]


@pytest.mark.parametrize("corpus,engine", [
    (lambda: tsyn.zipf_corpus(**ZIPF, seed=4), "u16_prededuped"),
    (_big_vocab_docs, "packed"),
])
def test_chunk_zero_runs_the_prededuped_one_shot_like_jax(corpus, engine, tmp_path):
    list_path = _manifest(tmp_path, corpus())
    kw = {"pipeline_chunk_docs": 0}
    st, sj = _build_both(list_path, tmp_path, kw, kw)
    assert st["engine"] == engine
    assert "tokenize_feed" not in st["phases_ms"]
    assert set(st["phases_ms"]) == set(sj["phases_ms"]) == {
        "load", "tokenize", "feed", "device_index", "fetch", "emit"}
    for key in ("tokens", "unique_terms", "unique_pairs", "host_threads", "documents"):
        assert st[key] == sj[key], key
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)


def _explode_after_doc(monkeypatch, module, first_bad_doc):
    """Make the module's stream raise KeyOverflow on the window holding
    ``first_bad_doc`` (the JAX package's own test does the same)."""
    real = module.NativeKeyStream.feed_u16

    def exploding(self, contents, doc_ids, granule=1 << 14):
        if doc_ids and doc_ids[0] >= first_bad_doc:
            raise module.KeyOverflow()
        return real(self, contents, doc_ids, granule)

    monkeypatch.setattr(module.NativeKeyStream, "feed_u16", exploding)


def test_key_overflow_restarts_on_the_one_shot_plan_like_jax(tmp_path, monkeypatch):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(num_docs=9, vocab_size=300,
                                                     tokens_per_doc=50, seed=11))
    _explode_after_doc(monkeypatch, tnative, 6)
    _explode_after_doc(monkeypatch, jnative, 6)
    kw = {"pipeline_chunk_docs": 2}
    st, sj = _build_both(list_path, tmp_path, kw, kw)
    assert st["pipelined_fallback"] == sj["pipelined_fallback"] == "key_overflow"
    assert set(st["phases_ms"]) == set(sj["phases_ms"])
    assert "aborted_pipelined" in st["phases_ms"] and "tokenize_feed" not in st["phases_ms"]
    assert st["engine"] == "u16_prededuped"
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)


def test_real_key_overflow_restarts_on_the_pairs_engine_like_jax(tmp_path):
    """No monkeypatch: 33,000 distinct words in one document and a
    65,534-entry manifest (stride 65,536) push prov_id * stride past
    int32; the one-shot restart cannot pack either and sorts int64."""
    big = tmp_path / "big.txt"
    big.write_bytes(b" ".join(_word(i) for i in range(33_000)))
    small = tmp_path / "small.txt"
    small.write_bytes(b"zz top")
    list_path = tmp_path / "list.txt"
    tman.write_manifest(list_path, [str(small)] * 30_000 + [str(big)] + [str(small)] * 35_533)
    st, sj = _build_both(list_path, tmp_path)
    assert st["pipelined_fallback"] == sj["pipelined_fallback"] == "key_overflow"
    assert st["engine"] == "pairs"
    assert st["unique_pairs"] == sj["unique_pairs"] == 33_000 + 2 * 65_533


def test_skipped_document_is_recorded_once_across_the_restart(tmp_path, monkeypatch):
    paths = tsyn.write_corpus(tmp_path / "docs", [b"alpha beta", b"beta gamma", b"delta"])
    list_path = tmp_path / "list.txt"
    tman.write_manifest(list_path, [paths[0], str(tmp_path / "gone.txt"), *paths[1:]])
    _explode_after_doc(monkeypatch, tnative, 3)
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(pipeline_chunk_docs=2),
                          output_dir=str(tmp_path / "out"))
    assert st["pipelined_fallback"] == "key_overflow"
    assert st["degradation"]["skipped_docs"] == [2]
    assert (tmp_path / "out" / "g.txt").read_bytes() == b"gamma:[3]\n"


def test_without_the_library_the_default_build_runs_the_numpy_one_shot(tmp_path, monkeypatch):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(**ZIPF, seed=6))
    monkeypatch.setattr(tnative, "available", lambda: False)
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(),
                          output_dir=str(tmp_path / "out"))
    assert st["engine"] == "u16" and "tokenize_feed" not in st["phases_ms"]
    assert read_letter_files(tmp_path / "out") == _oracle_bytes(list_path, tmp_path)


@pytest.mark.parametrize("kw", [{"use_native": False}, {"collect_skew_stats": True},
                                {"pipeline_chunk_docs": 0}])
def test_plan_eligibility_matches_jax(kw, tmp_path):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(**ZIPF, seed=7))
    st, sj = _build_both(list_path, tmp_path, kw, kw)
    assert "tokenize_feed" not in st["phases_ms"]
    assert set(st["phases_ms"]) == set(sj["phases_ms"])


def test_manifest_past_0xfffe_docs_is_not_eligible(tmp_path):
    m = tpkg.Manifest(paths=("x",) * 0xFFFF, sizes=(1,) * 0xFFFF)
    model = tmodel.InvertedIndexModel(_port_cfg())
    assert not model._pipelined_eligible(m)
    assert model._pipelined_eligible(tpkg.Manifest(paths=("x",) * 0xFFFE, sizes=(1,) * 0xFFFE))


# -- the reader thread ----------------------------------------------------


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_yields_what_the_plain_reader_yields(depth, tmp_path):
    paths = tsyn.write_corpus(tmp_path / "d", [b"a", b"bb", b"ccc", b"dddd", b"e"])
    m = tman.Manifest(paths=(paths[0], str(tmp_path / "gone"), *paths[1:]),
                      sizes=(1, 0, 2, 3, 4, 1))
    ranges = [(0, 2), (2, 2), (2, 6)]
    r1, r2 = tman.DegradationReport(), tman.DegradationReport()
    assert (list(tman.prefetch_document_ranges(m, ranges, r1, depth=depth))
            == list(tman.iter_document_ranges(m, ranges, r2)))
    assert r1.summary()["skipped_docs"] == r2.summary()["skipped_docs"] == [2]


def test_prefetch_reraises_a_reader_error_in_the_consumer(tmp_path):
    class Broken(tman.Manifest):
        def read_doc(self, index):
            raise MemoryError("disk on fire")

    m = Broken(paths=("a", "b"), sizes=(1, 1))
    with pytest.raises(MemoryError, match="disk on fire"):
        list(tman.prefetch_document_ranges(m, [(0, 1), (1, 2)]))


# -- the CLI --------------------------------------------------------------


@pytest.mark.parametrize("flags,windows,threads", [
    ([], 2, 4),
    (["--pipeline-chunk-docs", "3"], 14, 4),
    (["--host-threads", "2"], 2, 2),
    (["--emit-backend", "python"], 2, 4),
    (["--emit-backend", "native", "--host-threads", "1"], 2, 1),
])
def test_cli_default_build_takes_the_pipelined_plan(flags, windows, threads, tmp_path, capsys):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(**ZIPF, seed=9))
    rc = tcli.main(["4", "26", str(list_path), "--device", "cpu", "--stats",
                    "--output-dir", str(tmp_path / "out"), *flags])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats["phases_ms"]) == PIPELINED_PHASES
    assert stats["upload_windows"] == windows and stats["host_threads"] == threads
    assert read_letter_files(tmp_path / "out") == _oracle_bytes(list_path, tmp_path)


@pytest.mark.parametrize("flags", [["--pipeline-chunk-docs", "-1"], ["--host-threads", "0"]])
def test_cli_rejects_bad_plan_flags_with_exit_2(flags, tmp_path, capsys):
    list_path = _manifest(tmp_path, [b"alpha beta"])
    assert tcli.main(["1", "1", str(list_path), "--device", "cpu", *flags]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and err.count("\n") == 1


def test_cli_plan_flags_match_jax():
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli

    jp = jcli.make_parser()
    tp = tcli.make_parser()
    for dest in ("pipeline_chunk_docs", "host_threads", "emit_backend", "overlap_tail_fraction",
                 "overlap_device_windows", "overlap_window_split"):
        ja = next(a for a in jp._actions if a.dest == dest)
        ta = next(a for a in tp._actions if a.dest == dest)
        assert (ta.option_strings, ta.default, ta.choices, ta.type) == (
            ja.option_strings, ja.default, ja.choices, ja.type)


def test_cli_default_device_is_the_card(tmp_path, capsys):
    list_path = _manifest(tmp_path, [b"alpha beta"])
    if tmodel.torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main(["1", "1", str(list_path), "--output-dir", str(tmp_path / "out")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
