"""The port's native host scan (native/tokenizer.cc + native/__init__.py)
against the JAX package's: the one-shot tokenizer, the provisional-key
stream (int32 keys, uint16 feeds, finalize), the letter-file emit, the
two engine programs that consume combiner-deduped feeds, and the
library's own build.  Inputs are made from a seed with numpy; exact
equality throughout."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import native as jnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    scheduler as jsched,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.ops import (
    engine as je,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.text import (
    formatter as jfmt,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native as tnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    scheduler as tsched,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    engine as te,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
    formatter as tfmt,
    tokenizer as ttok,
)

from conftest import REPO_ROOT, read_letter_files

INT32_MAX = 2**31 - 1


@pytest.fixture(autouse=True)
def _toolchain(request):
    """Skip without a C++ toolchain — decided per test, and for a
    ``native_san`` test from the port's library alone: a sanitizer run
    builds no JAX library."""
    libs = (tnative,) if request.node.get_closest_marker("native_san") else (tnative, jnative)
    if not all(lib.available() for lib in libs):
        pytest.skip("no C++ toolchain")


def _word(i: int) -> bytes:
    """Letters-only base-26 word for integer ``i`` (distinct per ``i``)."""
    s = ""
    while True:
        s += chr(ord("a") + i % 26)
        i //= 26
        if not i:
            return s.encode()


CORPORA = {
    "zipf": lambda: tsyn.zipf_corpus(num_docs=23, vocab_size=900, tokens_per_doc=120, seed=4),
    "edges": lambda: [b"Don't x1y2z3 caf\xc3\xa9 ALPHA\tbeta\ngamma\r\x0bdelta",
                      b"", b"  \n  ", b"a" * 40 + b" " + b"b" * 305, b"...  z",
                      b"alpha alpha ALPHA beta"],
    "long_words": lambda: [b" ".join(b"q" * n for n in (7, 8, 9, 15, 16, 17, 31, 299, 300)),
                           b"q" * 33 + b" short q" * 3],
    "no_letters": lambda: [b"123 456", b"!!!", b""],
}


def _ids(docs):
    return list(range(1, len(docs) + 1))


# -- one-shot tokenizer --------------------------------------------------


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_tokenize_native_matches_jax(name, dedup, threads):
    docs = CORPORA[name]()
    want = jnative.tokenize_native(docs, _ids(docs), dedup_pairs=dedup, num_threads=threads)
    got = tnative.tokenize_native(docs, _ids(docs), dedup_pairs=dedup, num_threads=threads)
    for field in ("term_ids", "doc_ids", "vocab", "letter_of_term"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (got.pairs_deduped, got.raw_tokens) == (want.pairs_deduped, want.raw_tokens)


@pytest.mark.native_san
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_native_scan_keeps_the_numpy_tokenizers_contract(name):
    """Without the combiner the native scan is token for token the numpy
    tokenizer; ``tokenize(use_native=False)`` is the numpy tokenizer."""
    docs = CORPORA[name]()
    want = ttok.tokenize_documents(docs, _ids(docs))
    for got in (ttok.tokenize(docs, _ids(docs), use_native=True),
                ttok.tokenize(docs, _ids(docs), use_native=False)):
        for field in ("term_ids", "doc_ids", "vocab", "letter_of_term"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_tokenize_falls_back_to_numpy_without_the_library(monkeypatch):
    docs = CORPORA["zipf"]()
    monkeypatch.setattr(tnative, "available", lambda: False)
    got = ttok.tokenize(docs, _ids(docs), use_native=True, dedup_pairs=True)
    assert not got.pairs_deduped and got.raw_tokens is None
    np.testing.assert_array_equal(got.term_ids, ttok.tokenize_documents(docs, _ids(docs)).term_ids)


# -- provisional-key stream ----------------------------------------------


def _windows(n_docs, window):
    return [(s, min(s + window, n_docs)) for s in range(0, n_docs, window)]


def _assert_final_equal(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"finalize[{i}]")


@pytest.mark.parametrize("window", [1, 5, 1000])
@pytest.mark.parametrize("threads", [1, 3])
def test_key_stream_keys_match_jax(threads, window):
    docs = CORPORA["zipf"]() + CORPORA["edges"]()
    ids = _ids(docs)
    stride = len(docs) + 2
    with tnative.NativeKeyStream(stride, threads) as ts, \
            jnative.NativeKeyStream(stride, threads) as js:
        for lo, hi in _windows(len(docs), window):
            got_keys, got_raw = ts.feed(docs[lo:hi], ids[lo:hi])
            want_keys, want_raw = js.feed(docs[lo:hi], ids[lo:hi])
            np.testing.assert_array_equal(got_keys, want_keys)
            assert got_raw == want_raw
        _assert_final_equal(ts.finalize(), js.finalize())


@pytest.mark.parametrize("granule", [1, 64, 1 << 14])
@pytest.mark.parametrize("window", [1, 5, 1000])
@pytest.mark.parametrize("threads", [1, 3])
def test_key_stream_u16_feeds_match_jax(threads, window, granule):
    docs = CORPORA["zipf"]() + CORPORA["long_words"]()
    ids = _ids(docs)
    stride = len(docs) + 2
    with tnative.NativeKeyStream(stride, threads) as ts, \
            jnative.NativeKeyStream(stride, threads) as js:
        for lo, hi in _windows(len(docs), window):
            got = ts.feed_u16(docs[lo:hi], ids[lo:hi], granule=granule)
            want = js.feed_u16(docs[lo:hi], ids[lo:hi], granule=granule)
            assert got[0] == want[0] and got[2:] == want[2:]
            np.testing.assert_array_equal(got[1], want[1])
            assert got[1].dtype == want[1].dtype
        _assert_final_equal(ts.finalize(), js.finalize())


@pytest.mark.parametrize("threads", [1, 3])
def test_key_stream_u16_window_switches_to_int32_keys_like_jax(threads):
    n = 0x10000 + 50  # prov ids pass 0xFFFF inside the second window
    docs = [b" ".join(_word(i) for i in range(0, n // 2)),
            b" ".join(_word(i) for i in range(n // 2, n))]
    with tnative.NativeKeyStream(4, threads) as ts, jnative.NativeKeyStream(4, threads) as js:
        modes = []
        for d in range(2):
            got = ts.feed_u16([docs[d]], [d + 1])
            want = js.feed_u16([docs[d]], [d + 1])
            assert got[0] == want[0] and got[2:] == want[2:]
            np.testing.assert_array_equal(got[1], want[1])
            modes.append(got[0])
        assert modes == ["u16", "keys"]
        _assert_final_equal(ts.finalize(), js.finalize())


@pytest.mark.parametrize("method", ["feed", "feed_u16"])
def test_key_overflow_raises_like_jax(method):
    """prov_id * stride past int32 raises KeyOverflow in both packages
    (stride 2**30: the third word's key is 2**31)."""
    docs, ids = [b"alpha beta gamma"], [1]
    for mod in (tnative, jnative):
        with mod.NativeKeyStream(1 << 30) as s, pytest.raises(mod.KeyOverflow):
            getattr(s, method)(docs, ids)


def test_key_stream_empty_window_and_empty_finalize_match_jax():
    with tnative.NativeKeyStream(5) as ts, jnative.NativeKeyStream(5) as js:
        for fn in ("feed_u16", "feed"):
            got, want = getattr(ts, fn)([b"  ", b"123"], [1, 2]), getattr(js, fn)([b"  ", b"123"], [1, 2])
            assert [np.asarray(g).tolist() for g in got] == [np.asarray(w).tolist() for w in want]
        _assert_final_equal(ts.finalize(), js.finalize())


# -- the engine programs fed by the combiner ------------------------------


def _prov_windows(seed, sizes, modes, vocab, max_doc, granule=64):
    """Distinct (prov, doc) pairs split into windows, each either the
    uint16 ``[terms | docs]`` buffer or padded int32 keys.  Returns the
    windows and the number of pairs."""
    rng = np.random.default_rng(seed)
    stride = max_doc + 2
    idx = rng.choice(vocab * max_doc, size=sum(sizes), replace=False)
    terms, docs = idx // max_doc, idx % max_doc + 1
    out, start = [], 0
    for size, mode in zip(sizes, modes):
        t, d = terms[start:start + size], docs[start:start + size]
        start += size
        padded = -(-size // granule) * granule
        if mode == "u16":
            out.append(te.pack_u16_feed(t, d, padded))
        else:
            buf = np.full(padded, INT32_MAX, np.int32)
            buf[:size] = t * stride + d
            out.append(buf)
    return out, start


def _to_torch(buf):
    return torch.from_numpy(buf.view(np.int16) if buf.dtype == np.uint16 else buf)


@pytest.mark.parametrize("modes", [("u16",), ("keys",), ("u16", "keys"), ("keys", "u16", "u16"),
                                   ("u16", "u16", "keys", "keys")])
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_prov_chunks_matches_jax(modes, seed):
    vocab, max_doc = 3000, 300
    sizes = [int(x) for x in np.random.default_rng(seed).integers(1, 5000, len(modes))]
    bufs, n_valid = _prov_windows(seed, sizes, modes, vocab, max_doc)
    out_size = min(sum(len(b) // (2 if b.dtype == np.uint16 else 1) for b in bufs),
                   -(-n_valid // 64) * 64)
    want = np.asarray(je.sort_prov_chunks(tuple(jnp.asarray(b) for b in bufs),
                                          stride=max_doc + 2, out_size=out_size))
    got = te.sort_prov_chunks([_to_torch(b) for b in bufs], stride=max_doc + 2,
                              out_size=out_size)
    assert got.dtype == torch.int16 and want.dtype == np.uint16
    np.testing.assert_array_equal(te.host_u16(got.numpy())[:n_valid], want[:n_valid])


@pytest.mark.parametrize("out_size", [None, 64, 4096])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_prededuped_u16_matches_jax(seed, out_size):
    vocab, max_doc = 2000, 355
    bufs, n_valid = _prov_windows(seed, [3000], ["u16"], vocab, max_doc, granule=1024)
    buf = bufs[0]
    want = np.asarray(je.index_prededuped_u16(jnp.asarray(buf), max_doc_id=max_doc,
                                              out_size=out_size))
    got = te.index_prededuped_u16(_to_torch(buf), max_doc_id=max_doc, out_size=out_size)
    np.testing.assert_array_equal(te.host_u16(got.numpy()), want)


def test_pending_fetch_on_the_cpu_is_the_tensor():
    t = torch.arange(5, dtype=torch.int16)
    np.testing.assert_array_equal(te.PendingFetch(t).wait(), t.numpy())
    host = np.arange(6, dtype=np.int32)
    keep = []
    assert te.upload(host, torch.device("cpu"), keep).data_ptr() == host.ctypes.data
    assert keep == []


# -- the letter-file emit -------------------------------------------------


def _emit_arrays(docs, dtype):
    """Emit inputs from a combiner-deduped tokenization: df, order,
    offsets and the (term, doc)-sorted postings."""
    corpus = tnative.tokenize_native(docs, _ids(docs), dedup_pairs=True)
    df = np.bincount(corpus.term_ids, minlength=corpus.vocab_size).astype(np.int64)
    order, offsets = te.host_order_offsets(corpus.letter_of_term, df)
    postings = corpus.doc_ids[np.lexsort((corpus.doc_ids, corpus.term_ids))].astype(dtype)
    return corpus, dict(order=order, df=df, offsets=offsets, postings=postings)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_native_emit_matches_python_emit_and_jax(name, dtype, tmp_path):
    docs = CORPORA[name]()
    corpus, arrays = _emit_arrays(docs, dtype)
    common = dict(vocab=corpus.vocab, letter_of_term=corpus.letter_of_term,
                  max_doc_id=len(docs), **arrays)
    outs = {}
    for backend in ("native", "python", "auto"):
        stats = tfmt.emit_index(tmp_path / backend, backend=backend, **common)
        assert stats["lines_written"] == corpus.vocab_size
        assert stats["emit_backend"] == ("python" if backend == "python" else "native")
        outs[backend] = read_letter_files(tmp_path / backend)
    for backend in ("native", "python"):
        jfmt.emit_index(tmp_path / f"jax_{backend}", backend=backend, **common)
        outs[f"jax_{backend}"] = read_letter_files(tmp_path / f"jax_{backend}")
    assert len(set(outs.values())) == 1
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == [
        f"{chr(97 + i)}.txt" for i in range(26)]


@pytest.mark.native_san
@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_native_emit_matches_python_emit(name, dtype, tmp_path):
    """The port's native emit against its Python emit alone."""
    docs = CORPORA[name]()
    corpus, arrays = _emit_arrays(docs, dtype)
    common = dict(vocab=corpus.vocab, letter_of_term=corpus.letter_of_term,
                  max_doc_id=len(docs), **arrays)
    for backend in ("native", "python"):
        tfmt.emit_index(tmp_path / backend, backend=backend, **common)
    assert read_letter_files(tmp_path / "native") == read_letter_files(tmp_path / "python")


@pytest.mark.native_san
@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("chunk", [1, 7, None])
def test_pipelined_cpu_builds_match_the_oracle(chunk, threads, tmp_path):
    """The pipelined plan on the CPU device — the native scan's key
    stream in uint16 windows, the native emit — equals the oracle."""
    docs = CORPORA["zipf"]() + CORPORA["edges"]() + CORPORA["long_words"]()
    paths = tsyn.write_corpus(tmp_path / "docs", docs)
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tpkg.read_manifest(tmp_path / "list.txt")
    tpkg.oracle_index(m, str(tmp_path / "oracle"))
    r = tpkg.build_index(m, tpkg.IndexConfig(device="cpu", pipeline_chunk_docs=chunk,
                                             host_threads=threads, emit_backend="native"),
                         output_dir=str(tmp_path / "out"))
    assert "tokenize_feed" in r["phases_ms"]
    assert read_letter_files(tmp_path / "out") == read_letter_files(tmp_path / "oracle")


def test_native_emit_returns_the_bytes_written(tmp_path):
    corpus, arrays = _emit_arrays(CORPORA["zipf"](), np.uint16)
    n = tnative.emit_native(tmp_path, corpus.vocab, **arrays)
    assert n == len(read_letter_files(tmp_path)) > 0


def test_emit_backend_native_without_the_library_raises(monkeypatch, tmp_path):
    corpus, arrays = _emit_arrays(CORPORA["zipf"](), np.uint16)
    monkeypatch.setattr(tnative, "load", lambda: None)
    common = dict(vocab=corpus.vocab, letter_of_term=corpus.letter_of_term, max_doc_id=23,
                  **arrays)
    with pytest.raises(RuntimeError, match="native"):
        tfmt.emit_index(tmp_path / "n", backend="native", **common)
    assert tfmt.emit_index(tmp_path / "a", backend="auto", **common)["emit_backend"] == "python"
    with pytest.raises(ValueError, match="unknown emit backend"):
        tfmt.emit_index(tmp_path / "x", backend="fast", **common)


# -- the library's build --------------------------------------------------


def test_library_has_its_own_stem_and_directory():
    so = tnative._compile()
    assert so.parent == REPO_ROOT / tpkg.__name__ / "native" / "_build"
    assert so.name.startswith("libmri_torch_scan_") and so.suffix == ".so"
    jso = jnative._compile()
    assert jso.parent != so.parent and not jso.name.startswith("libmri_torch_scan_")
    # both loaded in one process, each through its own handle (RTLD_LOCAL)
    assert tnative.load()._handle != jnative.load()._handle
    assert (ctypes.cast(tnative.load().mri_emit, ctypes.c_void_p).value
            != ctypes.cast(jnative.load().mri_emit, ctypes.c_void_p).value)


def test_prune_removes_only_this_librarys_stale_builds():
    build = tnative._BUILD_DIR
    keep = tnative._compile().name
    stale = build / "libmri_torch_scan_000000000000.so"
    other = build / "libmri_tokenizer_000000000000.so"
    tmp = build / f"{keep}.99999999.tmp"
    for p in (stale, other, tmp):
        p.write_bytes(b"")
    try:
        tnative._prune_stale(keep)
        assert not stale.exists() and other.exists() and tmp.exists()
        assert (build / keep).exists()
    finally:
        for p in (stale, other, tmp):
            p.unlink(missing_ok=True)


# -- scheduler and config parity ------------------------------------------


@pytest.mark.parametrize("num_windows", [1, 2, 3, 7, 40])
@pytest.mark.parametrize("sizes", [[5, 1, 1, 1, 9, 2], [0, 0, 0], [10], [], [3] * 17])
def test_window_plans_match_jax(sizes, num_windows):
    want = jsched.plan_contiguous_ranges(sizes, num_windows)
    assert tsched.plan_contiguous_ranges(sizes, num_windows) == want
    m = tman.Manifest(paths=tuple(f"d{i}" for i in range(len(sizes))), sizes=tuple(sizes))
    assert tsched.plan_contiguous_windows(m, num_windows) == want
    assert tsched.window_balance_stats(m, want) == jsched.window_balance_stats(m, want)


@pytest.mark.parametrize("kw", [{}, {"num_mappers": 4}, {"num_mappers": 4, "host_threads": 2},
                                {"host_threads": 3}])
def test_resolved_host_threads_match_jax(kw):
    assert (tpkg.IndexConfig(**kw).resolved_host_threads()
            == JaxConfig(**kw).resolved_host_threads())


@pytest.mark.parametrize("kw", [{"pipeline_chunk_docs": -1}, {"host_threads": 0},
                                {"emit_backend": "fast"}])
def test_new_config_validation_messages_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tpkg.IndexConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_pipeline_chunk_docs_needs_the_device_backend():
    with pytest.raises(ValueError, match="pipeline_chunk_docs requires backend='cuda'"):
        tpkg.IndexConfig(backend="oracle", pipeline_chunk_docs=3)
