"""The port's mesh all-device engines against the JAX package's, on the
same byte shards made from a seed with numpy: ``_mix32`` bit for bit
(column values across the whole uint32 range), ``index_bytes_dist``
owner by owner (hash and letter ownership, long words, the exchange
retry) with its stats, and ``DistDeviceStreamEngine`` window by window.
The JAX side gets fresh copies of every window (its CPU backend aliases
host memory)."""

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.parallel import (
    dist_device_streaming as jdds,
    dist_device_tokenizer as jddt,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.parallel.mesh import (
    make_mesh as jax_mesh,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    scheduler as tsched,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
    inverted_index as tmodel,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    device_tokenizer as TDT,
    kernels as tkernels,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
    dist_device_streaming as tdds,
    dist_device_tokenizer as tddt,
    mesh as M,
)
import torch


@pytest.mark.parametrize("ncols", [1, 2, 7])
def test_mix32_matches_jax_bit_for_bit(ncols):
    rng = np.random.default_rng(ncols)
    cols = [rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
            for _ in range(ncols)]
    cols[0][:4] = [0, -1, 2**31 - 1, -2**31]  # 0, 2^32-1, 2^31-1, 2^31 as uint32
    got = tddt._mix32([torch.from_numpy(c) for c in cols]).numpy()
    want = np.asarray(jddt._mix32([jnp.asarray(c) for c in cols])).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2**32


def _docs(seed: int, long_words: bool):
    docs = tsyn.zipf_corpus(num_docs=24, vocab_size=400, tokens_per_doc=50, seed=seed)
    if long_words:  # 13-40 letter words: tail groups and the sparse tail fetch
        docs += [b" ".join(bytes(97 + (3 * d + 5 * w + 7 * j) % 26 for j in range(13 + (d + w) % 28))
                           for w in range(12)) for d in range(4)]
    return docs


def _shards(docs, n: int, pad: int = 64):
    """Contiguous byte-balanced doc shards packed as the model packs
    them: equal buffer and ends/ids lengths across shards."""
    ids = list(range(1, len(docs) + 1))
    parts = [(docs[lo:hi], ids[lo:hi])
             for lo, hi in tsched.plan_contiguous_ranges([len(d) for d in docs], n)]
    shard_len = -(-max(max(sum(len(c) for c in cs) for cs, _ in parts), 1) // pad) * pad
    docs_cap = max(max(len(cs) for cs, _ in parts), 1)
    bufs, ends, idv = zip(*(tmodel._pack_window(cs, ii, shard_len, docs_cap) for cs, ii in parts))
    stats = [TDT.host_token_stats(b, e) for b, e in zip(bufs, ends)]
    return list(bufs), list(ends), list(idv), max(s[0] for s in stats), max(s[1] for s in stats)


def _fresh(arrays):
    return [np.array(a) for a in arrays]


def _assert_owners_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for o in got:
        g, w = got[o], want[o]
        assert (g["num_words"], g["num_pairs"]) == (w["num_words"], w["num_pairs"]), o
        np.testing.assert_array_equal(g["df"], w["df"])
        np.testing.assert_array_equal(g["postings"], w["postings"])
        assert len(g["unique_groups"]) == len(w["unique_groups"])
        for (gh, gl), (wh, wl) in zip(g["unique_groups"], w["unique_groups"]):
            np.testing.assert_array_equal(gh, wh)
            np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("letter", [False, True])
@pytest.mark.parametrize("long_words", [False, True])
def test_index_bytes_dist_matches_jax(n, letter, long_words):
    bufs, ends, ids, tok_count, max_len = _shards(_docs(n, long_words), n)
    tok_cap = -(-(tok_count + 1) // 1024) * 1024
    sort_cols = -(-max_len // 4)
    owner_of_letter = tsched.owner_of_letter_table(n)[1] if letter else None
    kw = dict(width=48, tok_cap=tok_cap, sort_cols=sort_cols, max_doc_id=len(_docs(n, long_words)),
              owner_of_letter=owner_of_letter)
    tstats, jstats = {}, {}
    got, (tlen, tretries) = tddt.index_bytes_dist(bufs, ends, ids, mesh=M.make_mesh(n, "cpu"),
                                                  stats=tstats, **kw)
    want, (jlen, jretries) = jddt.index_bytes_dist(_fresh(bufs), _fresh(ends), _fresh(ids),
                                                   mesh=jax_mesh(n), stats=jstats, **kw)
    assert (tlen, tretries) == (jlen, jretries) and tlen == max_len
    assert tstats == jstats
    _assert_owners_equal(got, want)


@pytest.mark.parametrize("letter", [False, True])
def test_index_bytes_dist_exchange_retry_matches_jax(letter):
    """One repeated word per doc: every row of every shard goes to one
    owner, past the default capacity; the retry at the safe capacity
    gives the JAX package's blocks."""
    docs = [b"anchor " * 400 + f"x{i}".encode() for i in range(16)]
    bufs, ends, ids, tok_count, max_len = _shards(docs, 8)
    kw = dict(width=48, tok_cap=-(-(tok_count + 1) // 1024) * 1024, sort_cols=-(-max_len // 4),
              max_doc_id=len(docs),
              owner_of_letter=tsched.owner_of_letter_table(8)[1] if letter else None)
    tstats, jstats = {}, {}
    got, (_, tretries) = tddt.index_bytes_dist(bufs, ends, ids, mesh=M.make_mesh(8, "cpu"),
                                               stats=tstats, **kw)
    want, (_, jretries) = jddt.index_bytes_dist(_fresh(bufs), _fresh(ends), _fresh(ids),
                                                mesh=jax_mesh(8), stats=jstats, **kw)
    assert tretries == jretries == 1 and tstats == jstats
    _assert_owners_equal(got, want)


def _stream_windows(n: int, seed: int):
    docs = _docs(seed, long_words=True)
    windows = []
    for lo in range(0, len(docs), 7):
        windows.append(_shards(docs[lo:lo + 7], n))
    return windows, len(docs)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("initial_capacity", [16, 1 << 15])
def test_dist_device_stream_engine_matches_jax(n, initial_capacity):
    """The same owner blocks as the JAX engine.  The port dedups each
    shard's window before the exchange and sizes the exchange and every
    merge from the window's read, so it never retries: an owner's
    accumulator holds at least ``initial_capacity`` rows, and more only
    as its rows need, where the JAX engine doubles a capacity and
    retries.  ``capacity`` is the longest owner's."""
    windows, max_doc = _stream_windows(n, seed=20 + n)
    port = tdds.DistDeviceStreamEngine(width=48, mesh=M.make_mesh(n, "cpu"),
                                       window_pad=256, initial_capacity=initial_capacity)
    jeng = jdds.DistDeviceStreamEngine(width=48, mesh=jax_mesh(n), window_pad=256,
                                       initial_capacity=initial_capacity)
    caps = []
    for bufs, ends, ids, tok_count, max_len in windows:
        port.feed(bufs, ends, ids, tok_count=tok_count, max_len=max_len)
        jeng.feed(_fresh(bufs), _fresh(ends), _fresh(ids), tok_count=tok_count, max_len=max_len)
        assert port.merge_retries == 0 and port.capacity >= initial_capacity
        caps.append(port.capacity)
    if initial_capacity == 16:
        assert jeng.merge_retries >= 1 and caps[-1] > caps[0] > 16
    else:
        assert caps == [initial_capacity] * len(windows)
    sort_cols = -(-port.max_word_len // 4)
    tstats, jstats = {}, {}
    got = port.finalize(sort_cols=sort_cols, max_doc_id=max_doc, stats=tstats)
    want = jeng.finalize(sort_cols=sort_cols, max_doc_id=max_doc, stats=jstats)
    if initial_capacity == 16:
        # the fetch trims to the port's tighter accumulators
        assert tstats.keys() == jstats.keys()
        assert tstats["dist_fetched_bytes"] <= jstats["dist_fetched_bytes"]
        assert tstats["merge_retries"] == 0
        assert tstats["accumulator_capacity_per_owner"] == caps[-1]
    else:
        assert tstats == jstats
    assert caps[-1] >= max(ow["num_pairs"] for ow in got.values())
    _assert_owners_equal(got, want)


def test_dist_device_stream_engine_keeps_the_sort_merge(monkeypatch):
    """The mesh engine folds exchanged rows, which come in no order, so
    it merges with the sort-based ``_merge_unique_rows`` and never with
    the single-card engine's merge kernel."""
    calls = []

    def spy(*a, **kw):
        calls.append(kw["cap"])
        return merge(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the mesh engine called merge_sorted_rows")

    merge = tdds._merge_unique_rows
    monkeypatch.setattr(tdds, "_merge_unique_rows", spy)
    monkeypatch.setattr(tkernels, "merge_sorted_rows", refuse)
    windows, _ = _stream_windows(2, seed=9)
    eng = tdds.DistDeviceStreamEngine(width=48, mesh=M.make_mesh(2, "cpu"), window_pad=256)
    bufs, ends, ids, tok_count, max_len = windows[0]
    eng.feed(bufs, ends, ids, tok_count=tok_count, max_len=max_len)
    assert len(calls) == 2 and max(calls) == eng.capacity  # one fold per owner


def test_dist_device_stream_engine_refuses_finalize_before_feed():
    eng = tdds.DistDeviceStreamEngine(width=48, mesh=M.make_mesh(2, "cpu"))
    eng.feed([np.full(64, 0x20, np.uint8)] * 2, [np.array([64], np.int32)] * 2,
             [np.array([1], np.int32)] * 2, tok_count=0, max_len=0)
    with pytest.raises(ValueError, match="no windows fed"):
        eng.finalize(sort_cols=1, max_doc_id=1)
