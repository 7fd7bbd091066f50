"""The port's streaming plan (``stream_chunk_docs``) against the JAX
package's: the document-window loader, the streaming tokenizer's
provisional ids, the bounded device accumulator (packed mode, the
switch to pair mode, capacity doubling) on the same feeds, and whole
builds byte-equal to the JAX build and to the oracle, with the same
phases and counters.  Inputs are made from seeds with numpy; the JAX
side always gets fresh numpy copies (its CPU backend may alias host
memory)."""

import json

import numpy as np
import pytest

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    manifest as jman,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.ops import (
    streaming as jstream,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.text import (
    streaming as jtstream,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    streaming as tstream,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
    streaming as ttstream,
)

from conftest import read_letter_files

STREAM_PHASES = {"stream", "device_index", "fetch", "emit"}
STREAM_COUNTERS = ("documents", "tokens", "unique_terms", "vocab_curve", "stream_windows",
                   "accumulator_capacity", "accumulator_mode", "unique_pairs",
                   "lines_written", "host_threads")


def _port_cfg(**kw):
    kw.setdefault("pad_multiple", 64)
    return tpkg.IndexConfig(device="cpu", **kw)


def _jax_cfg(**kw):
    kw.setdefault("pad_multiple", 64)
    return JaxConfig(backend="tpu", device_shards=1, **kw)


def _manifest(tmp_path, docs, name="corpus"):
    paths = tsyn.write_corpus(tmp_path / name, docs)
    list_path = tmp_path / f"{name}.txt"
    tman.write_manifest(list_path, paths)
    return list_path


def _oracle_bytes(list_path, tmp_path):
    tpkg.oracle_index(tpkg.read_manifest(list_path), tmp_path / "oracle")
    return read_letter_files(tmp_path / "oracle")


def _word(i: int) -> bytes:
    s = ""
    while True:
        s += chr(ord("a") + i % 26)
        i //= 26
        if not i:
            return s.encode()


# -- the loader and the tokenizer ------------------------------------------


@pytest.mark.parametrize("chunk_docs", [1, 3, 7, 100])
def test_iter_document_chunks_matches_jax(chunk_docs, tmp_path):
    paths = tsyn.write_corpus(tmp_path / "d", [b"a", b"bb", b"ccc", b"dddd", b"e", b"ff", b"g"])
    paths.insert(2, str(tmp_path / "gone.txt"))
    m = tman.Manifest(paths=tuple(paths), sizes=(1,) * len(paths))
    report = tman.DegradationReport()
    got = list(tman.iter_document_chunks(m, chunk_docs, report))
    want = list(jman.iter_document_chunks(jman.Manifest(paths=m.paths, sizes=m.sizes),
                                          chunk_docs))
    assert got == want
    assert report.summary()["skipped_docs"] == [3]


def test_iter_document_chunks_rejects_zero(tmp_path):
    m = tman.Manifest(paths=("x",), sizes=(1,))
    with pytest.raises(ValueError, match="chunk_docs"):
        next(tman.iter_document_chunks(m, 0))


@pytest.mark.parametrize("use_native", [True, False])
def test_streaming_tokenizer_matches_jax(use_native):
    docs = tsyn.zipf_corpus(num_docs=12, vocab_size=300, tokens_per_doc=60, seed=4)
    tok = ttstream.StreamingTokenizer(use_native=use_native, num_threads=2)
    jtok = jtstream.StreamingTokenizer(use_native=use_native, num_threads=2)
    for lo in range(0, 12, 5):
        ids = list(range(lo + 1, min(lo + 5, 12) + 1))
        got, want = tok.feed(docs[lo:lo + 5], ids), jtok.feed(docs[lo:lo + 5], ids)
        np.testing.assert_array_equal(got.prov_term_ids, want.prov_term_ids)
        np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
        assert got.raw_tokens == want.raw_tokens
        assert tok.vocab_size == jtok.vocab_size
    for a, b in zip(tok.finalize(), jtok.finalize()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="finalize"):
        tok.feed([b"late"], [13])


def test_streaming_tokenizer_ids_are_append_stable():
    tok = ttstream.StreamingTokenizer(use_native=False)
    c1 = tok.feed([b"beta alpha"], [1])
    c2 = tok.feed([b"alpha gamma"], [2])
    c3 = tok.feed([b"gamma beta delta"], [3])
    vocab, remap, letters = tok.finalize()
    assert vocab.tolist() == [b"alpha", b"beta", b"delta", b"gamma"]
    np.testing.assert_array_equal(remap, [0, 1, 3, 2])
    np.testing.assert_array_equal(c1.prov_term_ids, [1, 0])
    np.testing.assert_array_equal(c2.prov_term_ids, [0, 2])
    np.testing.assert_array_equal(c3.prov_term_ids, [2, 1, 3])
    np.testing.assert_array_equal(letters, [0, 1, 3, 6])


# -- the engine on the same feeds as the JAX engine ------------------------


def _feed_both(feeds, *, max_doc_id, window_pad, initial_capacity, device="cpu"):
    """Feed both engines the same windows; returns the engines and the
    port's capacity after each window."""
    eng = tstream.StreamingIndexEngine(max_doc_id=max_doc_id, device=device,
                                       window_pad=window_pad,
                                       initial_capacity=initial_capacity)
    jeng = jstream.StreamingIndexEngine(max_doc_id=max_doc_id, window_pad=window_pad,
                                        initial_capacity=initial_capacity)
    caps = []
    for terms, docs, vocab_so_far in feeds:
        eng.feed(terms.copy(), docs.copy(), vocab_so_far)
        jeng.feed(terms.copy(), docs.copy(), vocab_so_far)
        assert (eng.mode, eng.capacity, eng.windows_fed) == (
            jeng.mode, jeng.capacity, jeng.windows_fed)
        caps.append(eng.capacity)
    return eng, jeng, caps


def _finalize_both(eng, jeng, vocab_size, seed):
    rng = np.random.default_rng(seed)
    remap = rng.permutation(vocab_size).astype(np.int32)
    letters = np.sort(rng.integers(0, 26, vocab_size)).astype(np.int32)
    got = {k: v.cpu().numpy() for k, v in eng.finalize(remap.copy(), letters.copy(),
                                                       vocab_size).items()}
    want = {k: np.asarray(v) for k, v in jeng.finalize(remap.copy(), letters.copy(),
                                                       vocab_size).items()}
    assert set(got) == set(want) == {"postings", "df", "order", "offsets", "num_unique"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def _random_feeds(seed, windows, n, vocab, max_doc):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32),
             rng.integers(1, max_doc + 1, n).astype(np.int32), vocab) for _ in range(windows)]


@pytest.mark.parametrize("seed", [0, 5])
def test_engine_packed_mode_matches_jax(seed):
    feeds = _random_feeds(seed, windows=4, n=300, vocab=500, max_doc=40)
    eng, jeng, _ = _feed_both(feeds, max_doc_id=40, window_pad=128, initial_capacity=4096)
    assert eng.mode == "packed"
    got = _finalize_both(eng, jeng, 500, seed)
    pairs = {(t, d) for terms, docs, _ in feeds for t, d in zip(terms.tolist(), docs.tolist())}
    assert int(got["num_unique"]) == len(pairs)


def test_engine_capacity_doubles_like_jax():
    feeds = _random_feeds(1, windows=4, n=200, vocab=5000, max_doc=3)
    eng, jeng, caps = _feed_both(feeds, max_doc_id=3, window_pad=128, initial_capacity=256)
    assert caps == [256, 512, 1024, 1024]  # 800 pairs fed -> two doublings
    _finalize_both(eng, jeng, 5000, 1)


@pytest.mark.parametrize("switch_after", [0, 2])
def test_engine_switches_to_pair_mode_like_jax(switch_after):
    """stride 100,002 stops packing past ~21,000 terms: the engine
    changes representation mid-stream (or from the first window) and
    loses nothing (tests/test_streaming.py's own case)."""
    rng = np.random.default_rng(1)
    feeds, vocab = [], 10_000
    for w in range(4):
        if w == switch_after:
            vocab = 30_000
        feeds.append((rng.integers(0, vocab, 300).astype(np.int32),
                      rng.integers(1, 50, 300).astype(np.int32), vocab))
    eng, jeng, _ = _feed_both(feeds, max_doc_id=100_000, window_pad=128,
                              initial_capacity=512)
    assert eng.mode == "pairs"
    got = _finalize_both(eng, jeng, 30_000, 2)
    seen = {}
    for terms, docs, _ in feeds:
        for t, d in zip(terms.tolist(), docs.tolist()):
            seen.setdefault(t, set()).add(d)
    assert int(got["num_unique"]) == sum(len(s) for s in seen.values())


def test_engine_empty_window_is_not_a_window():
    eng = tstream.StreamingIndexEngine(max_doc_id=3, device="cpu")
    eng.feed(np.empty(0, np.int32), np.empty(0, np.int32), 0)
    assert eng.windows_fed == 0
    with pytest.raises(ValueError, match="no windows"):
        eng.finalize(np.empty(0, np.int32), np.empty(0, np.int32), 0)


def test_packed_finalize_goes_through_unique_mask_count(monkeypatch):
    feeds = _random_feeds(3, windows=2, n=100, vocab=50, max_doc=9)
    eng = tstream.StreamingIndexEngine(max_doc_id=9, device="cpu", window_pad=64,
                                       initial_capacity=256)
    for terms, docs, vocab in feeds:
        eng.feed(terms, docs, vocab)
    calls = []
    real = tstream.engine.unique_mask_count
    monkeypatch.setattr(tstream.engine, "unique_mask_count",
                        lambda *a: calls.append(a) or real(*a))
    eng.finalize(np.arange(50, dtype=np.int32), np.zeros(50, np.int32), 50)
    assert len(calls) == 1


# -- whole builds ----------------------------------------------------------


def _build_both(list_path, tmp_path, **kw):
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(**kw),
                          output_dir=str(tmp_path / "torch"))
    sj = jpkg.build_index(jpkg.read_manifest(list_path), _jax_cfg(**kw),
                          output_dir=str(tmp_path / "jax"))
    assert read_letter_files(tmp_path / "torch") == read_letter_files(tmp_path / "jax")
    return st, sj


@pytest.mark.parametrize("chunk_docs", [1, 5, 100])
@pytest.mark.parametrize("seed", [0, 6])
def test_streaming_build_matches_jax_and_oracle(chunk_docs, seed, tmp_path):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(num_docs=12, vocab_size=400,
                                                     tokens_per_doc=120, seed=seed))
    st, sj = _build_both(list_path, tmp_path, stream_chunk_docs=chunk_docs)
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)
    assert set(st["phases_ms"]) == set(sj["phases_ms"]) == STREAM_PHASES
    for key in STREAM_COUNTERS:
        assert st[key] == sj[key], key
    assert st["stream_windows"] == -(-12 // chunk_docs)
    assert st["accumulator_mode"] == "packed"


def test_streaming_build_matches_the_smoke_golden(smoke_fixture, tmp_path, monkeypatch):
    monkeypatch.chdir(smoke_fixture)
    stats = tpkg.build_index(tpkg.read_manifest("manifest.txt"),
                             _port_cfg(stream_chunk_docs=2), output_dir=str(tmp_path))
    assert "stream" in stats["phases_ms"]
    assert read_letter_files(tmp_path) == read_letter_files(smoke_fixture / "golden")


def test_streaming_build_switches_to_pairs_like_jax(tmp_path):
    """A 65,534-entry manifest (stride 65,536) and 33,000 distinct words:
    the vocabulary stops packing in the window that holds the big
    document, so the accumulator moves to pair mode mid-stream."""
    big = tmp_path / "big.txt"
    big.write_bytes(b" ".join(_word(i) for i in range(33_000)))
    small = tmp_path / "small.txt"
    small.write_bytes(b"zz top")
    list_path = tmp_path / "list.txt"
    tman.write_manifest(list_path, [str(small)] * 30_000 + [str(big)] + [str(small)] * 35_533)
    st, sj = _build_both(list_path, tmp_path, stream_chunk_docs=20_000)
    assert st["accumulator_mode"] == sj["accumulator_mode"] == "pairs"
    for key in STREAM_COUNTERS:
        assert st[key] == sj[key], key
    assert st["unique_pairs"] == 33_000 + 2 * 65_533


def test_streaming_build_of_an_empty_corpus(tmp_path):
    list_path = _manifest(tmp_path, [b"   \n\t \n", b"123 ... !!"])
    st, sj = _build_both(list_path, tmp_path, stream_chunk_docs=1)
    assert read_letter_files(tmp_path / "torch") == b""
    assert set(st["phases_ms"]) == set(sj["phases_ms"]) == {"stream", "emit"}
    assert st["stream_windows"] == sj["stream_windows"] == 0


def test_streaming_build_skips_an_unreadable_file_with_exit_3(tmp_path, capsys):
    paths = tsyn.write_corpus(tmp_path / "docs", [b"alpha beta", b"beta gamma", b"delta"])
    list_path = tmp_path / "list.txt"
    tman.write_manifest(list_path, [paths[0], str(tmp_path / "gone.txt"), *paths[1:]])
    rc = tcli.main(["2", "2", str(list_path), "--device", "cpu", "--stream-chunk-docs", "2",
                    "--stats", "--output-dir", str(tmp_path / "out")])
    assert rc == 3
    captured = capsys.readouterr()
    stats = json.loads(captured.out.strip().splitlines()[-1])
    assert stats["degradation"]["skipped_docs"] == [2]
    assert stats["stream_windows"] == 2
    assert "DEGRADED" in captured.err
    assert (tmp_path / "out" / "g.txt").read_bytes() == b"gamma:[3]\n"


@pytest.mark.parametrize("chunk_docs", ["1", "5"])
def test_cli_streaming_matches_the_jax_cli(chunk_docs, tmp_path, capsys):
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli

    list_path = _manifest(tmp_path, tsyn.zipf_corpus(num_docs=11, vocab_size=300,
                                                     tokens_per_doc=70, seed=2))
    assert tcli.main(["4", "26", str(list_path), "--device", "cpu", "--stats",
                      "--stream-chunk-docs", chunk_docs,
                      "--output-dir", str(tmp_path / "torch")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(["4", "26", str(list_path), "--device-shards", "1",
                      "--stream-chunk-docs", chunk_docs,
                      "--output-dir", str(tmp_path / "jax")]) == 0
    assert read_letter_files(tmp_path / "torch") == read_letter_files(tmp_path / "jax")
    assert set(stats["phases_ms"]) == STREAM_PHASES


@pytest.mark.parametrize("kw,match", [
    ({"stream_chunk_docs": 0}, "stream_chunk_docs"),
    ({"stream_chunk_docs": -3}, "stream_chunk_docs"),
    ({"stream_chunk_docs": 4, "collect_skew_stats": True}, "collect_skew_stats"),
    ({"stream_chunk_docs": 4, "backend": "oracle"}, "backend"),
    # a stream checkpoint needs the streaming plan's all-device variant
    ({"stream_chunk_docs": 4, "stream_checkpoint": "s.npz"}, "streaming all-device"),
    ({"stream_chunk_docs": 4, "device_tokenize": True, "stream_checkpoint_every": 0},
     "stream_checkpoint_every"),
    ({"stream_chunk_docs": 4, "device_tokenize": True, "resume": "maybe"}, "resume"),
    ({"stream_chunk_docs": 4, "overlap_tail_fraction": 0.5}, "stream_chunk_docs"),
])
def test_config_rejects_what_the_streaming_plan_lacks(kw, match):
    with pytest.raises(ValueError, match=match):
        tpkg.IndexConfig(**kw)


def test_streaming_takes_precedence_over_the_pipelined_plan(tmp_path):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(num_docs=6, vocab_size=90,
                                                     tokens_per_doc=30, seed=1))
    st, sj = _build_both(list_path, tmp_path, stream_chunk_docs=2, pipeline_chunk_docs=3)
    assert set(st["phases_ms"]) == set(sj["phases_ms"]) == STREAM_PHASES


def test_cli_new_flags_match_jax():
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli

    jp, tp = jcli.make_parser(), tcli.make_parser()
    for dest in ("stream_chunk_docs", "device_tokenize", "device_tokenize_width",
                 "stream_checkpoint", "stream_checkpoint_every", "resume",
                 "overlap_tail_fraction", "overlap_device_windows", "overlap_window_split"):
        ja = next(a for a in jp._actions if a.dest == dest)
        ta = next(a for a in tp._actions if a.dest == dest)
        assert (ta.option_strings, ta.default, ta.choices, ta.type, ta.nargs) == (
            ja.option_strings, ja.default, ja.choices, ja.type, ja.nargs)
