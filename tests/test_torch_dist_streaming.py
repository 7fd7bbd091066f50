"""The port's ``DistStreamingIndexEngine`` (``parallel/dist_streaming.py``)
against the JAX package's, fed the same windows made from a seed with
numpy: packed mode, the switch to pair mode mid-stream and from the
first window, capacity growth with its retries, and an empty feed
(the cases of tests/test_dist_streaming.py).  Equal: the mode, every
owner's rows, ``dist_fetched_bytes``, the capacity, the retries and the
window count."""

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.parallel.dist_streaming import (  # noqa: E501
    DistStreamingIndexEngine as JaxEngine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.parallel.mesh import (
    make_mesh as jax_mesh,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
    mesh as M,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel.dist_streaming import (  # noqa: E501
    DistStreamingIndexEngine as PortEngine,
)


def _both(n: int, **kw):
    return (PortEngine(mesh=M.make_mesh(n, "cpu"), **kw), JaxEngine(mesh=jax_mesh(n), **kw))


def _feed_both(engines, terms, docs, vocab):
    for eng in engines:
        # fresh copies per engine: nothing one engine does reaches the other
        eng.feed(np.array(terms), np.array(docs), vocab)


def _assert_same(port, jax_eng):
    assert (port.mode, port.capacity, port.merge_retries, port.windows_fed) == (
        jax_eng.mode, jax_eng.capacity, jax_eng.merge_retries, jax_eng.windows_fed)
    tstats, jstats = {}, {}
    tmode, trows = port.finalize(stats=tstats)
    jmode, jrows = jax_eng.finalize(stats=jstats)
    assert tmode == jmode and sorted(trows) == sorted(jrows)
    for o in trows:
        if tmode == "packed":
            np.testing.assert_array_equal(trows[o], np.asarray(jrows[o]), err_msg=f"owner {o}")
        else:
            for t, j in zip(trows[o], jrows[o]):
                np.testing.assert_array_equal(t, np.asarray(j), err_msg=f"owner {o}")
    assert tstats == jstats
    return tmode, trows


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_packed_stream_matches_jax(n):
    max_doc = 300
    engines = _both(n, max_doc_id=max_doc, window_pad=64)
    rng = np.random.default_rng(n)
    want = set()
    vocab = 0
    for _ in range(5):
        vocab += 150
        terms = np.minimum(rng.zipf(1.4, 700) - 1, vocab - 1).astype(np.int32)
        docs = rng.integers(1, max_doc + 1, 700).astype(np.int32)
        _feed_both(engines, terms, docs, vocab)
        want.update(terms.astype(np.int64) * (max_doc + 2) + docs)
    mode, rows = _assert_same(*engines)
    assert mode == "packed"
    assert sorted(int(k) for r in rows.values() for k in r) == sorted(want)


@pytest.mark.parametrize("n", [2, 4])
def test_capacity_growth_and_retry_match_jax(n):
    """Every term is a multiple of n: every pair lands on owner 0, whose
    tiny accumulator must grow (retrying against the preserved one)."""
    engines = _both(n, max_doc_id=8, window_pad=64, initial_capacity=64)
    rng = np.random.default_rng(5)
    for _ in range(6):
        terms = (rng.integers(0, 400, size=300) * n).astype(np.int32)
        docs = rng.integers(1, 9, size=300).astype(np.int32)
        _feed_both(engines, terms, docs, 400 * n)
    port = engines[0]
    assert port.capacity > 64 and port.merge_retries >= 1
    _assert_same(*engines)


@pytest.mark.parametrize("switch_at", [0, 2])
def test_pair_mode_switch_matches_jax(switch_at):
    """A vocabulary that outgrows int32 packing switches the accumulator
    to pairs — mid-stream (window 2) or from the first window."""
    max_doc = 1 << 20  # stride 2^20 + 2: about 2047 terms still pack
    engines = _both(4, max_doc_id=max_doc, window_pad=64, initial_capacity=1 << 12)
    rng = np.random.default_rng(9 + switch_at)
    want = set()
    for step in range(4):
        vocab = 5000 if step >= switch_at else 100
        terms = rng.integers(0, 100, size=200).astype(np.int32)
        docs = rng.integers(1, max_doc + 1, size=200).astype(np.int32)
        _feed_both(engines, terms, docs, vocab)
        want.update(zip(terms.tolist(), docs.tolist()))
        assert engines[0].mode == engines[1].mode == ("pairs" if step >= switch_at else "packed")
    mode, rows = _assert_same(*engines)
    assert mode == "pairs"
    got = sorted((int(t), int(d)) for tt, dd in rows.values() for t, d in zip(tt, dd))
    assert got == sorted(want)


def test_empty_feed_and_finalize_match_jax():
    engines = _both(2, max_doc_id=3)
    _feed_both(engines, np.empty(0, np.int32), np.empty(0, np.int32), 0)
    assert engines[0].windows_fed == engines[1].windows_fed == 0
    assert engines[0].finalize() == ("packed", {})
    assert engines[1].finalize() == ("packed", {})
