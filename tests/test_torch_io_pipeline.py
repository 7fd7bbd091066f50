"""The port's io subsystem (``io/``: window arenas, byte-window plans,
the prefetching reader) and its pipelined host route, against the JAX
package's on the same corpora.

The arenas are the zero-copy seam between the manifest readers and the
native scan (``mri_hidx_feed`` reads their raw pointers with the GIL
released), so these equalities are what lets the host backend skip the
join/marshal copies without a parity risk."""

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import io as jio
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    manifest as jman,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import io as tio
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
    inverted_index as TMI,
)

from conftest import read_letter_files
from test_torch_cpu_backend import build_both, corpus_pair


@pytest.fixture
def pair(tmp_path):
    return corpus_pair(tmp_path, num_docs=23, vocab_size=400, tokens_per_doc=60, seed=11)


# -- WindowArena ----------------------------------------------------------


def _fill(mod):
    a = mod.WindowArena(byte_capacity=8, doc_capacity=2)
    a.append_bytes(5, b"hello")
    a.append_bytes(9, b" world of arenas")  # byte growth
    a.append_bytes(2, b"x")                 # doc growth
    v = a.view(64)                          # an oversized view keeps the prefix
    v[:3] = b"def"
    a.commit(7, 3)                          # a short read commits less
    return a


def test_arena_equals_jax():
    t, j = _fill(tio), _fill(jio)
    for x, y in zip(t.feed_views(), j.feed_views()):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert t.contents() == j.contents() == [b"hello", b" world of arenas", b"x", b"def"]
    assert (t.used_bytes, t.num_docs) == (j.used_bytes, j.num_docs)


def test_arena_reset_reuses_buffer():
    a = tio.WindowArena(byte_capacity=16, doc_capacity=4)
    a.append_bytes(0, b"first window")
    backing = a._buf
    a.reset()
    a.append_bytes(1, b"second")
    assert a._buf is backing and a.contents() == [b"second"]


# -- planning and window reads ---------------------------------------------


class _Sizes:
    """Sizes-only duck manifest for planner edge cases."""

    def __init__(self, sizes):
        self.sizes = tuple(sizes)
        self.paths = tuple(f"<doc{i}>" for i in range(len(sizes)))

    def __len__(self):
        return len(self.sizes)


@pytest.mark.parametrize("sizes,target", [
    ([], 1024), ([1 << 20], 4096), ([0, 0, 0, 0], 1),
    ([100, 900, 30, 30, 30, 5000, 1], 512), ([7] * 50, 20),
])
def test_plan_byte_windows_equals_jax(sizes, target):
    m = _Sizes(sizes)
    windows = tio.plan_byte_windows(m, target)
    assert windows == jio.plan_byte_windows(m, target)
    assert [i for lo, hi in windows for i in range(lo, hi)] == list(range(len(sizes)))


def test_plan_byte_windows_on_a_corpus(pair):
    tm, jm, _ = pair
    windows = tio.plan_byte_windows(tm, 1 << 10)
    assert windows == jio.plan_byte_windows(jm, 1 << 10) and len(windows) > 1
    assert tio.plan_byte_windows(tm, 1 << 30) == [(0, len(tm))]


def test_read_window_into_equals_load_documents_and_jax(pair):
    tm, jm, _ = pair
    contents, ids = tman.load_documents(tm)
    arena = tio.read_window_into(tm, 0, len(tm), tio.WindowArena())
    assert arena.contents() == contents
    assert arena.feed_views()[2].tolist() == ids
    assert arena.contents() == jio.read_window_into(jm, 0, len(jm), jio.WindowArena()).contents()
    assert tman.load_documents_arena(tm).contents() == contents
    assert jman.load_documents_arena(jm).contents() == contents


def test_read_doc_into_reads_real_files_in_place(pair):
    tm, _, _ = pair
    buf = bytearray(tm.sizes[3])
    assert tio.read_doc_into(tm, 3, memoryview(buf)) == len(buf)
    assert bytes(buf) == tm.read_doc(3)
    short = bytearray(10)  # the manifest size is authoritative: cut to it
    assert tm.read_doc_into(3, short) == 10 and bytes(short) == tm.read_doc(3)[:10]


def test_read_window_into_virtual_manifest():
    class Virtual:
        sizes = [4, 2]  # estimates: the second document is longer
        paths = ["<v0>", "<v1>"]

        def __len__(self):
            return 2

        def doc_id(self, i):
            return i + 1

        def read_doc(self, i):
            return [b"aaaa", b"bbbbbb"][i]

    arena = tio.read_window_into(Virtual(), 0, 2, tio.WindowArena())
    assert arena.contents() == [b"aaaa", b"bbbbbb"]


# -- PipelinedWindowReader -------------------------------------------------


def test_reader_yields_every_window_in_order(pair):
    tm, _, _ = pair
    windows = tio.plan_byte_windows(tm, 1 << 10)
    ring = [tio.WindowArena(byte_capacity=1 << 12) for _ in range(3)]
    reader = tio.PipelinedWindowReader(tm, windows, depth=2, arenas=ring)
    assert reader.arenas is ring
    seen, order = [], []
    for arena in reader:
        assert arena in ring
        seen.extend(arena.contents())
        order.append(arena.window_index)
        reader.recycle(arena)
    assert seen == tman.load_documents(tm)[0]
    assert order == list(range(1, len(windows) + 1))
    assert reader.read_busy_s >= 0.0


def test_reader_propagates_source_exception():
    class Broken:
        sizes = [4]
        paths = ["<b0>"]

        def __len__(self):
            return 1

        def doc_id(self, i):
            return i

        def read_doc(self, i):
            raise ValueError("corrupt source")

    reader = tio.PipelinedWindowReader(Broken(), [(0, 1)], depth=1)
    with pytest.raises(ValueError, match="corrupt source"):
        for arena in reader:
            reader.recycle(arena)


@pytest.mark.parametrize("how", ["close", "context"])
def test_reader_close_joins_an_abandoned_thread(how, pair):
    tm, _, _ = pair
    windows = tio.plan_byte_windows(tm, 256)
    assert len(windows) > 2
    if how == "close":
        reader = tio.PipelinedWindowReader(tm, windows, depth=1)
        reader.recycle(next(iter(reader)))
        assert reader.close() is True and reader.close() is True
    else:
        with tio.PipelinedWindowReader(tm, windows, depth=1) as reader:
            next(iter(reader))
    assert not reader._thread.is_alive()


# -- zero-copy feed and the pipelined route ---------------------------------


def test_feed_arrays_matches_feed_lists(pair, tmp_path):
    tm, _, _ = pair
    contents, ids = tman.load_documents(tm)
    arena = tio.read_window_into(tm, 0, len(tm), tio.WindowArena())
    with native.HostIndexStream() as s1:
        s1.feed_arrays(*arena.feed_views())
        stats1 = s1.finalize_emit(tmp_path / "arrays")
    with native.HostIndexStream() as s2:
        s2.feed(contents, ids)
        stats2 = s2.finalize_emit(tmp_path / "lists")
    assert read_letter_files(tmp_path / "arrays") == read_letter_files(tmp_path / "lists")
    for key in ("unique_terms", "unique_pairs", "tokens", "bytes_written"):
        assert stats1[key] == stats2[key]


@pytest.mark.parametrize("prefetch", [0, 2, 3])
def test_pipelined_route_equals_oracle_and_jax(prefetch, tmp_path):
    tm, jm, _ = corpus_pair(tmp_path, num_docs=41, vocab_size=400, tokens_per_doc=60, seed=3)
    tpkg.oracle_index(tm, str(tmp_path / "oracle"))
    ts, js = build_both(tm, jm, tmp_path, env={"MRI_CPU_WINDOW_BYTES": "1024"},
                        host_threads=1, io_prefetch=prefetch)
    golden = read_letter_files(tmp_path / "oracle")
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax") == golden
    assert sorted(ts) == sorted(js)
    if prefetch:
        assert ts["io_windows"] == js["io_windows"] > 1
        assert ts["io_prefetch"] == prefetch
        for key in ("stage_read_ms", "stage_tokenize_ms", "stage_emit_ms"):
            assert key in ts


def test_pipelined_many_tiny_windows(tmp_path, monkeypatch):
    """Window-boundary stress: one document per window."""
    monkeypatch.setattr(TMI.InvertedIndexModel, "_CPU_WINDOW_BYTES", 1)
    tm, _, _ = corpus_pair(tmp_path, num_docs=17, vocab_size=400, tokens_per_doc=60, seed=8)
    tpkg.oracle_index(tm, str(tmp_path / "oracle"))
    r = tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", host_threads=1, io_prefetch=3),
                         output_dir=str(tmp_path / "tiny"))
    assert r["io_windows"] == 17
    assert read_letter_files(tmp_path / "tiny") == read_letter_files(tmp_path / "oracle")
