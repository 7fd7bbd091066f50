"""The port's ``parallel/dist_engine.py`` against the JAX package's, on
the same inputs made from a seed with numpy: ``dist_index`` (df, emit
order, offsets, postings, unique count), ``dist_sort_prov_windows`` and
``dist_letter_windows`` (rows per owner, ``dist_fetched_bytes``,
``dist_valid_pairs``), the host merges and ``default_capacity``, and the
overflow retry (``capacity_factor=0.25``, and the letter partition's
skew at 2.0) giving what the roomy capacity gives.  The JAX side runs
on its virtual CPU devices (tests/conftest.py), the port on
``make_mesh(N, "cpu")``.  Everything is integers: exact equality."""

import jax
import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.parallel import (
    dist_engine as jdist,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.parallel.mesh import (
    make_mesh as jax_mesh,
    shard_spec,
    sharding,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    scheduler as tsched,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    engine as tengine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
    dist_engine as tdist,
    mesh as M,
)

INT32_MAX = 2**31 - 1
SIZES = [1, 2, 4, 8]


def _pairs(seed: int, num_pairs: int, vocab: int, max_doc: int, dup: bool):
    """Zipf-ish term ids and uniform docs; ``dup`` keeps duplicate pairs
    (the one-shot feed before dedup), else each pair once."""
    rng = np.random.default_rng(seed)
    terms = np.minimum(rng.zipf(1.3, num_pairs) - 1, vocab - 1).astype(np.int64)
    docs = rng.integers(1, max_doc + 1, num_pairs).astype(np.int64)
    keys = terms * (max_doc + 2) + docs
    if not dup:
        keys = np.unique(keys)
        rng.shuffle(keys)
    return keys.astype(np.int32)


def _padded(keys: np.ndarray, granule: int) -> np.ndarray:
    out = np.full(-(-max(keys.size, 1) // granule) * granule, INT32_MAX, np.int32)
    out[: keys.size] = keys
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("factor", [2.0, 0.25])
def test_dist_index_matches_jax(n, factor):
    vocab, max_doc = 300, 40
    keys = _padded(_pairs(n, 5000, vocab, max_doc, dup=True), 64 * n)
    letters = np.random.default_rng(7).integers(0, 26, vocab).astype(np.int32)
    want = jdist.dist_index(np.array(keys), np.array(letters), vocab_size=vocab,
                            max_doc_id=max_doc, mesh=jax_mesh(n), capacity_factor=factor)
    mesh = M.make_mesh(n, "cpu")
    got = tdist.dist_index(M.shard(keys, mesh), torch.from_numpy(letters), vocab_size=vocab,
                           max_doc_id=max_doc, mesh=mesh, capacity_factor=factor)
    num_unique = int(want["num_unique"])
    assert int(got["num_unique"]) == num_unique
    for k in ("df", "order", "offsets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["postings"], np.asarray(want["postings"]))
    # and the single-device engine's answer
    ref = tengine.index_packed(torch.from_numpy(keys), torch.from_numpy(letters),
                               vocab_size=vocab, max_doc_id=max_doc)
    assert int(ref["num_unique"]) == num_unique
    np.testing.assert_array_equal(got["df"].numpy(), ref["df"].numpy())
    np.testing.assert_array_equal(got["postings"], ref["postings"].numpy()[:num_unique])


def test_dist_index_overflow_retry_on_one_term():
    """Every pair is one term: every source's pairs land in one bucket
    and the default capacity overflows; the retry at the safe capacity
    gives the same index as the JAX package."""
    keys = _padded(np.array([5 * 12 + d for d in range(1, 11)] * 6, np.int32), 64)
    letters = np.zeros(8, np.int32)
    mesh = M.make_mesh(8, "cpu")
    got = tdist.dist_index(M.shard(keys, mesh), torch.from_numpy(letters), vocab_size=8,
                           max_doc_id=10, mesh=mesh)
    want = jdist.dist_index(np.array(keys), np.array(letters), vocab_size=8, max_doc_id=10,
                            mesh=jax_mesh(8))
    assert int(got["num_unique"]) == int(want["num_unique"]) == 10
    np.testing.assert_array_equal(got["postings"], np.asarray(want["postings"]))


def _windows(seed: int, n: int, max_doc: int, num_windows: int = 2):
    """Combiner-deduped provisional keys cut into windows, each padded
    to a multiple of the mesh size; returns (host windows, all keys)."""
    keys = _pairs(seed, 6000, 500, max_doc, dup=False)
    cuts = np.array_split(keys, num_windows)
    return [_padded(c, 64 * n) for c in cuts], keys


def _offsets(keys: np.ndarray, stride: int, vocab: int = 500):
    df = np.bincount(keys // stride, minlength=vocab).astype(np.int64)
    return np.cumsum(df) - df


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("factor", [2.0, 0.25])
def test_dist_sort_prov_windows_matches_jax(n, factor, monkeypatch):
    runs = []
    exchange = tdist._exchange_owned
    monkeypatch.setattr(tdist, "_exchange_owned",
                        lambda *a, **kw: runs.append(kw["capacity"]) or exchange(*a, **kw))
    max_doc = 60
    stride = max_doc + 2
    host, keys = _windows(10 + n, n, max_doc)
    offsets = _offsets(keys, stride)
    jstats, tstats = {}, {}
    jmesh = jax_mesh(n)
    want = jdist.dist_sort_prov_windows(
        [jax.device_put(np.array(w), sharding(jmesh, shard_spec())) for w in host],
        stride=stride, mesh=jmesh, offsets_prov=offsets, num_pairs=keys.size,
        capacity_factor=factor, stats=jstats)
    mesh = M.make_mesh(n, "cpu")
    got = tdist.dist_sort_prov_windows(
        [M.shard(w, mesh) for w in host], stride=stride, mesh=mesh, offsets_prov=offsets,
        num_pairs=keys.size, capacity_factor=factor, stats=tstats)
    np.testing.assert_array_equal(got, want)
    assert tstats == jstats
    if factor < 1 and n > 1:  # a quarter of the expected bucket load overflows
        assert len(runs) == 2 and runs[1] == host[0].size // n + host[1].size // n
    # the single-device sort of the same windows gives the same postings
    one = tengine.sort_prov_chunks([torch.from_numpy(w) for w in host], stride=stride,
                                   out_size=keys.size)
    np.testing.assert_array_equal(got, tengine.host_u16(one.numpy()))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("factor", [2.0, 0.25])
def test_dist_letter_windows_matches_jax(n, factor):
    max_doc = 50
    stride = max_doc + 2
    host, keys = _windows(30 + n, n, max_doc, num_windows=3)
    letters = np.random.default_rng(n).integers(0, 26, 500).astype(np.int32)
    _, owner_of_letter = tsched.owner_of_letter_table(n)
    owner_of_prov = owner_of_letter[letters]
    jstats, tstats = {}, {}
    jmesh = jax_mesh(n)
    want = jdist.dist_letter_windows(
        [jax.device_put(np.array(w), sharding(jmesh, shard_spec())) for w in host],
        owner_of_prov, stride=stride, mesh=jmesh, capacity_factor=factor, stats=jstats)
    mesh = M.make_mesh(n, "cpu")
    got = tdist.dist_letter_windows([M.shard(w, mesh) for w in host], owner_of_prov,
                                    stride=stride, mesh=mesh, capacity_factor=factor,
                                    stats=tstats)
    assert sorted(got) == sorted(want) == list(range(n))
    for o in range(n):
        np.testing.assert_array_equal(got[o], np.asarray(want[o]), err_msg=f"owner {o}")
        terms = got[o] // stride
        assert np.all(owner_of_prov[terms] == o)
    assert tstats == jstats
    assert tstats["dist_valid_pairs"] == keys.size


def test_merges_match_jax():
    rng = np.random.default_rng(3)
    stride = 30
    keys = np.unique(rng.integers(0, 200 * stride, 4000)).astype(np.int32)
    keys = keys[keys % stride > 0]
    owner = (keys // stride) % 3
    rows = [keys[owner == o] for o in range(3)]
    offsets = _offsets(keys, stride, vocab=200)
    np.testing.assert_array_equal(tdist.merge_owner_runs(rows, stride, offsets, keys.size),
                                  jdist.merge_owner_runs(rows, stride, offsets, keys.size))
    pair_rows = [(r // stride, r % stride) for r in rows]
    np.testing.assert_array_equal(
        tdist.merge_owner_pair_runs(pair_rows, offsets, keys.size),
        jdist.merge_owner_pair_runs(pair_rows, offsets, keys.size))
    empty = [np.empty(0, np.int32)]
    assert tdist.merge_owner_runs(empty, stride, offsets, 0).size == 0


@pytest.mark.parametrize("local", [1, 7, 64, 1000, 65536, 1 << 20])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("factor", [2.0, 0.25, 1.0])
def test_default_capacity_matches_jax(local, n, factor):
    assert tdist.default_capacity(local, n, factor) == jdist.default_capacity(local, n, factor)
