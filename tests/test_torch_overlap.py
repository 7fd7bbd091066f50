"""The port's windowed overlap plan (``overlap_tail_fraction``) against
the JAX package's ``_run_tpu_overlap`` and ``oracle_index``: the byte
share window plan, the native combiner's df snapshots and the multi-run
emit, and whole builds at any tail fraction, thread count and window
split — byte-equal, with the same counters — plus the degenerate
corpora, the ``KeyOverflow`` restart and the config messages."""

import json

import numpy as np
import pytest

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import native as jnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    manifest as jman,
    scheduler as jsched,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native as tnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    scheduler as tsched,
    synthetic as tsyn,
)

from conftest import read_letter_files

OVERLAP_PHASES = {"tokenize_feed", "finalize_vocab", "host_tail", "host_views", "fetch",
                  "emit"}
OVERLAP_COUNTERS = ("host_threads", "window_plan_bytes", "documents", "tokens",
                    "unique_terms", "upload_windows", "overlap_tail_fraction",
                    "device_pairs", "unique_pairs", "lines_written", "bytes_written")


@pytest.fixture(autouse=True)
def _needs_the_native_library():
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


def _port_cfg(**kw):
    kw.setdefault("pad_multiple", 64)
    kw.setdefault("overlap_tail_fraction", 0.4)
    return tpkg.IndexConfig(device="cpu", **kw)


def _jax_cfg(**kw):
    kw.setdefault("pad_multiple", 64)
    kw.setdefault("overlap_tail_fraction", 0.4)
    return JaxConfig(backend="tpu", device_shards=1, **kw)


def _corpus(tmp_path, docs):
    paths = tsyn.write_corpus(tmp_path / "docs", docs)
    tman.write_manifest(tmp_path / "list.txt", paths)
    tpkg.oracle_index(tpkg.read_manifest(tmp_path / "list.txt"), tmp_path / "oracle")
    return tmp_path / "list.txt", read_letter_files(tmp_path / "oracle")


def _build_both(list_path, tmp_path, **kw):
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(**kw),
                          output_dir=str(tmp_path / "torch"))
    sj = jpkg.build_index(jpkg.read_manifest(list_path), _jax_cfg(**kw),
                          output_dir=str(tmp_path / "jax"))
    got = read_letter_files(tmp_path / "torch")
    assert got == read_letter_files(tmp_path / "jax")
    return st, sj, got


# -- plan_fraction_windows ---------------------------------------------------


@pytest.mark.parametrize("sizes,fractions", [
    ([10, 30, 5, 5, 50, 10, 20, 70], (0.5, 0.5)),
    ([10, 30, 5, 5, 50, 10, 20, 70], (0.3, 0.3, 0.4)),
    ([10, 30, 5, 5, 50, 10, 20, 70], (0.05, 0.95)),
    ([10] * 100, (0.25, 0.25, 0.5)),
    ([0, 0, 7], (0.2, 0.8)),
    ([], (0.55 * 0.6, 0.45 * 0.6, 0.4)),
])
def test_plan_fraction_windows_matches_jax(sizes, fractions):
    paths = tuple(f"f{i}" for i in range(len(sizes)))
    got = tsched.plan_fraction_windows(tman.Manifest(paths=paths, sizes=tuple(sizes)), fractions)
    assert got == jsched.plan_fraction_windows(
        jman.Manifest(paths=paths, sizes=tuple(sizes)), fractions)
    assert got[0][0] == 0 and got[-1][1] == len(sizes)
    assert all(b == c for (_, b), (c, _) in zip(got, got[1:]))
    if sizes == [10] * 100:
        assert got == ((0, 25), (25, 50), (50, 100))


@pytest.mark.parametrize("fractions", [(), (0.5, -0.5, 1.0), (0.5, 0.2)])
def test_plan_fraction_windows_rejects_bad_fractions(fractions):
    m = tman.Manifest(paths=("f0",), sizes=(10,))
    with pytest.raises(ValueError, match="fractions must"):
        tsched.plan_fraction_windows(m, fractions)


# -- native df snapshots and the multi-run emit --------------------------------


@pytest.mark.parametrize("threads", [1, 3])
def test_df_snapshot_matches_the_jax_stream(threads):
    docs = tsyn.zipf_corpus(num_docs=30, vocab_size=400, tokens_per_doc=40, seed=threads)
    stride = len(docs) + 2
    t_stream = tnative.NativeKeyStream(stride, num_threads=threads)
    j_stream = jnative.NativeKeyStream(stride, num_threads=threads)
    try:
        for lo in range(0, 30, 7):
            window = docs[lo:lo + 7], list(range(lo + 1, min(lo + 8, 31)))
            t_stream.feed(*window)
            j_stream.feed(*window)
            for hint in (1, 1 << 16):  # too small (retried at the size needed) and ample
                got = t_stream.df_snapshot(hint=hint)
                np.testing.assert_array_equal(got, j_stream.df_snapshot(hint=hint))
        final = t_stream.finalize()
        # the last snapshot is the finalize's prov-space df
        np.testing.assert_array_equal(got, final[3])
    finally:
        t_stream.close()
        j_stream.close()


def _emit_case(seed):
    rng = np.random.default_rng(seed)
    vocab = np.sort(np.array([b"ant", b"bee", b"cat", b"dog", b"emu", b"fox", b"zebra"],
                             dtype="S5"))
    v = len(vocab)
    df = rng.integers(1, 9, size=v).astype(np.int64)
    offsets = np.cumsum(df) - df
    postings = np.concatenate(
        [np.sort(rng.choice(50, size=n, replace=False)) + 1 for n in df]).astype(np.uint16)
    letters = np.array([w[0] - ord("a") for w in vocab.tolist()])
    order = np.lexsort((-df, letters))
    # each term's postings cut at a random point into two runs
    split = np.array([rng.integers(0, n + 1) for n in df], dtype=np.int64)
    runs = []
    for lo, cnt in ((np.zeros(v, np.int64), split), (split, df - split)):
        segs = [postings[offsets[t] + lo[t]: offsets[t] + lo[t] + cnt[t]] for t in range(v)]
        runs.append((np.concatenate(segs).astype(np.uint16), np.cumsum(cnt) - cnt, cnt))
    return vocab, order, df, offsets, postings, runs


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_emit_native_runs_matches_jax_and_a_single_run(seed, tmp_path):
    vocab, order, df, offsets, postings, runs = _emit_case(seed)
    tnative.emit_native(tmp_path / "one", vocab, order, df, offsets, postings)
    n = tnative.emit_native_runs(tmp_path / "two", vocab, order, runs)
    assert n == jnative.emit_native_runs(tmp_path / "jax", vocab, order, runs)
    assert read_letter_files(tmp_path / "two") == read_letter_files(tmp_path / "one")
    assert read_letter_files(tmp_path / "two") == read_letter_files(tmp_path / "jax")


def test_emit_native_runs_with_empty_runs(tmp_path):
    vocab = np.array([b"abc"], dtype="S3")
    order = np.array([0], dtype=np.int64)
    zero, one = np.zeros(1, np.int64), np.ones(1, np.int64)
    runs = [(np.empty(0, np.uint16), zero, zero), (np.array([3], np.uint16), zero, one),
            (np.empty(0, np.uint16), one, zero)]
    tnative.emit_native_runs(tmp_path / "out", vocab, order, runs)
    jnative.emit_native_runs(tmp_path / "jax", vocab, order, runs)
    assert (tmp_path / "out" / "a.txt").read_bytes() == b"abc:[3]\n"
    assert read_letter_files(tmp_path / "out") == read_letter_files(tmp_path / "jax")
    tnative.emit_native_runs(tmp_path / "none", np.empty(0, "S1"), np.empty(0, np.int64), [])
    assert read_letter_files(tmp_path / "none") == b""


# -- whole builds --------------------------------------------------------------


@pytest.mark.parametrize("tail", [0.1, 0.4, 0.9])
def test_matches_the_smoke_golden_at_any_fraction(tail, smoke_fixture, tmp_path, monkeypatch):
    monkeypatch.chdir(smoke_fixture)
    stats = tpkg.build_index(tpkg.read_manifest("manifest.txt"),
                             _port_cfg(overlap_tail_fraction=tail), output_dir=str(tmp_path))
    assert set(stats["phases_ms"]) == OVERLAP_PHASES
    assert read_letter_files(tmp_path) == read_letter_files(smoke_fixture / "golden")


@pytest.mark.parametrize("tail,threads", [(0.15, 1), (0.5, 4), (0.85, 1)])
def test_random_corpus_matches_jax_and_the_oracle(tail, threads, tmp_path):
    list_path, want = _corpus(tmp_path, tsyn.zipf_corpus(num_docs=53, vocab_size=900,
                                                         tokens_per_doc=70, seed=11))
    st, sj, got = _build_both(list_path, tmp_path, overlap_tail_fraction=tail,
                              host_threads=threads)
    assert got == want
    assert set(st["phases_ms"]) == OVERLAP_PHASES == set(sj["phases_ms"])
    for key in OVERLAP_COUNTERS:
        assert st[key] == sj[key], key
    assert 0 < st["device_pairs"] < st["unique_pairs"]


def test_a_small_tail_leaves_most_pairs_on_the_device(tmp_path):
    list_path, want = _corpus(tmp_path, tsyn.zipf_corpus(num_docs=64, vocab_size=500,
                                                         tokens_per_doc=60, seed=5))
    st, _, got = _build_both(list_path, tmp_path, overlap_tail_fraction=0.2)
    assert got == want and st["upload_windows"] == 2
    assert st["device_pairs"] > st["unique_pairs"] // 2


@pytest.mark.parametrize("case", ["tiny", "empty", "numbers_only_tail", "no_tail_docs"])
def test_degenerate_corpora_match_jax_and_the_oracle(case, tmp_path):
    docs = {
        # < 8 docs: one device window and the tail
        "tiny": [b"alpha beta gamma", b"beta beta delta", b"zeta alpha"],
        "empty": [b"   \n\t  "],
        "numbers_only_tail": [b"alpha beta", b"gamma delta epsilon", b"123 456 --- !!"],
        # the tail's byte share rounds to no document at all
        "no_tail_docs": [b"alpha beta gamma delta " * 40, b"x"],
    }[case]
    list_path, want = _corpus(tmp_path, docs)
    st, sj, got = _build_both(list_path, tmp_path, overlap_tail_fraction=0.2)
    assert got == want
    for key in ("upload_windows", "device_pairs", "unique_pairs"):
        assert st[key] == sj[key], key
    if case == "tiny":
        assert st["upload_windows"] == 1


@pytest.mark.parametrize("kw", [{"overlap_window_split": 0.25}, {"overlap_window_split": 0.75},
                                {"overlap_device_windows": 1}])
def test_window_split_and_count_match_jax(kw, tmp_path):
    list_path, want = _corpus(tmp_path, tsyn.zipf_corpus(num_docs=24, vocab_size=300,
                                                         tokens_per_doc=50, seed=5))
    st, sj, got = _build_both(list_path, tmp_path, overlap_tail_fraction=0.5, **kw)
    assert got == want
    assert st["window_plan_bytes"] == sj["window_plan_bytes"]
    assert st["upload_windows"] == (1 if "overlap_device_windows" in kw else 2)


def test_key_overflow_restarts_on_the_one_shot_plan(tmp_path, monkeypatch):
    list_path, want = _corpus(tmp_path, tsyn.zipf_corpus(num_docs=12, vocab_size=200,
                                                         tokens_per_doc=30, seed=2))

    def overflow(*args, **kwargs):
        raise tnative.KeyOverflow()

    monkeypatch.setattr(tnative.NativeKeyStream, "feed_u16", overflow)
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(),
                          output_dir=str(tmp_path / "out"))
    assert st["pipelined_fallback"] == "key_overflow"
    assert "aborted_pipelined" in st["phases_ms"] and "tokenize" in st["phases_ms"]
    assert read_letter_files(tmp_path / "out") == want


@pytest.mark.parametrize("kw", [{"use_native": False}, {"collect_skew_stats": True}])
def test_a_config_off_the_pipelined_path_is_refused(kw, tmp_path):
    list_path, _ = _corpus(tmp_path, [b"alpha beta"])
    with pytest.raises(ValueError, match="requires the pipelined path"):
        tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(**kw),
                         output_dir=str(tmp_path / "out"))


def test_cli_overlap_plan(tmp_path, capsys):
    list_path, want = _corpus(tmp_path, tsyn.zipf_corpus(num_docs=11, vocab_size=300,
                                                         tokens_per_doc=70, seed=2))
    assert tcli.main(["4", "26", str(list_path), "--device", "cpu", "--stats",
                      "--overlap-tail-fraction", "0.3", "--overlap-device-windows", "1",
                      "--overlap-window-split", "0.4",
                      "--output-dir", str(tmp_path / "cli")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["overlap_tail_fraction"] == 0.3 and stats["upload_windows"] == 1
    assert read_letter_files(tmp_path / "cli") == want
    assert tcli.main(["4", "26", str(list_path), "--device", "cpu",
                      "--overlap-tail-fraction", "1.5"]) == 2
    assert "overlap_tail_fraction" in capsys.readouterr().err


@pytest.mark.parametrize("kw,match", [
    ({"overlap_tail_fraction": 0.0}, "overlap_tail_fraction must be in"),
    ({"overlap_tail_fraction": 1.0}, "overlap_tail_fraction must be in"),
    ({"overlap_tail_fraction": 0.5, "backend": "oracle"}, "backend"),
    ({"overlap_tail_fraction": 0.5, "pipeline_chunk_docs": 0}, "pipelined"),
    ({"overlap_tail_fraction": 0.5, "stream_chunk_docs": 100}, "stream_chunk_docs"),
    ({"overlap_tail_fraction": 0.5, "device_tokenize": True}, "host-scan"),
    ({"overlap_device_windows": 3}, "overlap_device_windows"),
    ({"overlap_window_split": 1.5}, "overlap_window_split"),
    ({"overlap_window_split": 0.0}, "overlap_window_split"),
])
def test_config_messages_match_jax(kw, match):
    with pytest.raises(ValueError, match=match) as port_err:
        tpkg.IndexConfig(**kw)
    jkw = {**kw, "backend": "cpu" if kw.get("backend") == "oracle" else "tpu"}
    with pytest.raises(ValueError, match=match) as jax_err:
        JaxConfig(**jkw)
    assert str(port_err.value).replace("'cuda'", "'tpu'").replace(
        "'oracle'", "'cpu'") == str(jax_err.value)
