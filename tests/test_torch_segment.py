"""The port's ops/keys.py and ops/segment.py against the JAX package's,
on the same numpy inputs (INT32_MAX padding included).  Exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.ops import (
    keys as jkeys,
    segment as jseg,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    keys as tkeys,
    segment as tseg,
)

INT32_MAX = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _padded_sorted_ids(n, n_valid, hi, seed):
    rng = np.random.default_rng(seed)
    ids = np.full(n, INT32_MAX, np.int32)
    ids[:n_valid] = rng.integers(0, hi, n_valid)
    return np.sort(ids)


def test_int32_max_matches():
    assert tkeys.INT32_MAX == int(jkeys.INT32_MAX)


@pytest.mark.parametrize("vocab,max_doc", [(10, 5), (65535, 65534), (100_000, 20_000),
                                           (70_000, 30_700), (2**20, 2**12)])
def test_can_pack_matches(vocab, max_doc):
    assert tkeys.can_pack(vocab, max_doc) == jkeys.can_pack(vocab, max_doc)


@pytest.mark.parametrize("max_doc", [1, 355, 20_000])
def test_pack_unpack_match(max_doc):
    rng = np.random.default_rng(max_doc)
    terms = rng.integers(0, 1000, 500).astype(np.int32)
    docs = rng.integers(1, max_doc + 1, 500).astype(np.int32)
    jk = np.asarray(jkeys.pack_pairs(jnp.asarray(terms), jnp.asarray(docs), max_doc))
    tk = tkeys.pack_pairs(_t(terms), _t(docs), max_doc)
    np.testing.assert_array_equal(tk.numpy(), jk)
    keys = np.append(jk, np.int32(INT32_MAX))
    for j, t in zip(jkeys.unpack_pairs(jnp.asarray(keys), max_doc),
                    tkeys.unpack_pairs(_t(keys), max_doc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_occurrence_mask_matches(seed):
    keys = _padded_sorted_ids(4096, 3000, 700, seed)
    np.testing.assert_array_equal(
        tseg.first_occurrence_mask(_t(keys)).numpy(),
        np.asarray(jseg.first_occurrence_mask(jnp.asarray(keys))))


@pytest.mark.parametrize("num_segments", [1, 50, 700, 1000])
def test_sorted_segment_counts_matches(num_segments):
    ids = _padded_sorted_ids(4096, 3500, 700, num_segments)
    weights = np.random.default_rng(7).integers(0, 3, 4096).astype(np.int32)
    want = np.asarray(jseg.sorted_segment_counts(
        jnp.asarray(ids), jnp.asarray(weights), num_segments))
    got = tseg.sorted_segment_counts(_t(ids), _t(weights), num_segments)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_buckets", [1, 4, 26])
def test_bucket_edges_matches(num_buckets):
    # ids == num_buckets are the padding bucket and fall past the last edge
    ids = np.sort(np.random.default_rng(num_buckets).integers(
        0, num_buckets + 1, 2000).astype(np.int32))
    for j, t in zip(jseg.bucket_edges(jnp.asarray(ids), num_buckets),
                    tseg.bucket_edges(_t(ids), num_buckets)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("m", [1, 100, 1001])
def test_searchsorted_device_matches(m):
    a = _padded_sorted_ids(3000, 2500, 1000, m)
    v = np.arange(m, dtype=np.int32)
    want = np.asarray(jseg.searchsorted_device(jnp.asarray(a), jnp.asarray(v)))
    got = tseg.searchsorted_device(_t(a), _t(v))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(a, v, side="left"))


@pytest.mark.parametrize("out_len", [0, 1, 500, 4096, 5000])
def test_set_bit_positions_matches(out_len):
    mask = np.random.default_rng(out_len).random(4096) < 0.3
    want = np.asarray(jseg.set_bit_positions(jnp.asarray(mask), out_len))
    got = tseg.set_bit_positions(_t(mask), out_len)
    assert got.dtype == torch.int32 and got.shape == (out_len,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_size", [0, 10, 1200, 4096, 6000])
@pytest.mark.parametrize("fill", [0, -1])
def test_compact_matches(out_size, fill):
    rng = np.random.default_rng(out_size)
    values = rng.integers(0, 10_000, 4096).astype(np.int32)
    mask = rng.random(4096) < 0.4
    want = np.asarray(jseg.compact(jnp.asarray(values), jnp.asarray(mask), out_size,
                                   jnp.int32(fill)))
    got = tseg.compact(_t(values), _t(mask), out_size, fill)
    assert got.dtype == torch.int32 and got.shape == (out_size,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_compact_and_set_bits_on_empty_input():
    empty_v = np.zeros(0, np.int32)
    empty_m = np.zeros(0, bool)
    np.testing.assert_array_equal(
        tseg.compact(_t(empty_v), _t(empty_m), 5, 7).numpy(),
        np.asarray(jseg.compact(jnp.asarray(empty_v), jnp.asarray(empty_m), 5, jnp.int32(7))))
    np.testing.assert_array_equal(tseg.set_bit_positions(_t(empty_m), 3).numpy(),
                                  np.full(3, INT32_MAX, np.int32))
