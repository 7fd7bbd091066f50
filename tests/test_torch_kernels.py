"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode (as tests/test_pallas.py does).
Exact equality throughout: every value is an integer.  The ``cuda``
tests hold the CUDA kernels against the plain versions and skip without
a card; they need no JAX, so on the card
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``
runs them (the repo's conftest imports JAX).
"""

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    engine as te,
    kernels as tk,
)


class _JaxKernels:
    """The JAX package's Pallas kernels, imported at first use, so that
    the ``cuda`` tests also run on a machine without JAX
    (``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``)."""

    def __getattr__(self, name):
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.ops.pallas import (
            kernels,
        )
        return getattr(kernels, name)


jk = _JaxKernels()

INT32_MAX = 2**31 - 1
BLOCK = 8192


def _sorted_keys(n, n_valid, vocab, stride, seed):
    rng = np.random.default_rng(seed)
    term = rng.integers(0, vocab, n_valid)
    doc = rng.integers(1, stride - 1, n_valid)
    keys = np.full(n, INT32_MAX, np.int32)
    keys[:n_valid] = term * stride + doc
    return np.sort(keys)


def _unique_case(case, n):
    """(keys, valid_limit) for one named input shape."""
    if case == "random":
        return _sorted_keys(n, n - 777, 5000, 357, n), 5000 * 357
    if case == "dense":
        # long runs of equal keys cross every block edge
        return np.sort(np.repeat(np.arange(64, dtype=np.int32) * 7, n // 64)), 1 << 30
    if case == "padding":
        return np.full(n, INT32_MAX, np.int32), 100
    if case == "limit_cuts":
        # the validity limit falls inside the valid keys
        keys = _sorted_keys(n, n, 5000, 357, n + 1)
        return keys, int(keys[n // 2])
    raise AssertionError(case)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("n", [BLOCK, 3 * BLOCK])
@pytest.mark.parametrize("case", ["random", "dense", "padding", "limit_cuts"])
def test_unique_mask_count_matches_pallas(case, n):
    keys, limit = _unique_case(case, n)
    jmask, jcount = jk.unique_mask_count(keys, limit)
    mask, count = tk.unique_mask_count(torch.from_numpy(keys), limit)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert count.dtype == torch.int32
    assert int(count) == int(jcount)


@pytest.mark.parametrize("n", [1, 2, 7, 8191, 10007])
def test_unique_mask_count_ragged_matches_numpy(n):
    keys = _sorted_keys(n, n - n // 5, 300, 11, n)
    limit = 300 * 11
    mask, count = tk.unique_mask_count(torch.from_numpy(keys), limit)
    expect = np.r_[True, keys[1:] != keys[:-1]] & (keys < limit)
    np.testing.assert_array_equal(mask.numpy(), expect)
    assert int(count) == int(expect.sum())


def test_unique_mask_count_empty_and_bad_input():
    mask, count = tk.unique_mask_count(torch.empty(0, dtype=torch.int32), 5)
    assert mask.shape == (0,) and int(count) == 0
    with pytest.raises(ValueError, match="int32"):
        tk.unique_mask_count(torch.zeros(4, dtype=torch.int64), 5)
    with pytest.raises(ValueError, match="int32"):
        tk.unique_mask_count(torch.zeros((2, 2), dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="valid_limit"):
        tk.unique_mask_count(torch.zeros(4, dtype=torch.int32), 2**31)


@pytest.mark.parametrize("n", [BLOCK, 3 * BLOCK])
@pytest.mark.parametrize("num_buckets", [2, 8, 26, 128])
def test_bucket_histogram_matches_pallas(num_buckets, n):
    rng = np.random.default_rng(num_buckets * n)
    # out-of-range values (padding == num_buckets, and negatives) are dropped
    vals = rng.integers(-2, num_buckets + 2, n).astype(np.int32)
    want = np.asarray(jk.bucket_histogram(vals, num_buckets))
    got = tk.bucket_histogram(torch.from_numpy(vals), num_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["padding", "one_bucket"])
def test_bucket_histogram_edge_inputs_match_pallas(case):
    vals = np.full(2 * BLOCK, 26 if case == "padding" else 3, np.int32)
    want = np.asarray(jk.bucket_histogram(vals, 26))
    np.testing.assert_array_equal(tk.bucket_histogram(torch.from_numpy(vals), 26).numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 13, 8191, 10007])
def test_bucket_histogram_ragged_matches_numpy(n):
    vals = np.random.default_rng(n).integers(0, 27, n).astype(np.int32)
    got = tk.bucket_histogram(torch.from_numpy(vals), 26).numpy()
    np.testing.assert_array_equal(got, np.bincount(vals[vals < 26], minlength=26))


HIST_VIEWS = ["contiguous", "offset1", "offset3", "strided3"]


def _hist_view(base, view, n):
    """An ``n``-long view of ``base`` (at least ``3n + 3`` values).  The
    offset views start 4 and 12 bytes past the allocation, off the
    16-byte boundary the CUDA kernel's vector loads need."""
    if view == "contiguous":
        return base[:n]
    if view == "offset1":
        return base[1:1 + n]
    if view == "offset3":
        return base[3:3 + n]
    if view == "strided3":
        return base[::3][:n]
    raise AssertionError(view)


def _hist_base(n, num_buckets, seed, one_hot=False):
    """``3n + 3`` ids with negatives and ids >= num_buckets mixed in."""
    if one_hot:
        return np.full(3 * n + 3, num_buckets - 1, np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(-3, num_buckets + 3, 3 * n + 3).astype(np.int32)


@pytest.mark.parametrize("n", [BLOCK, 8193, 8194, 8195])
@pytest.mark.parametrize("view", HIST_VIEWS)
@pytest.mark.parametrize("num_buckets", [1, 32, 33, 127])
def test_bucket_histogram_views_match_reference(num_buckets, view, n):
    """Offset and strided views, ``n % 4`` in {0, 1, 2, 3}: against the
    Pallas kernel where it takes the size, else against ``np.bincount``."""
    values = _hist_view(torch.from_numpy(_hist_base(n, num_buckets, n + num_buckets)), view, n)
    vals = np.ascontiguousarray(values.numpy())
    if n % BLOCK == 0:
        want = np.asarray(jk.bucket_histogram(vals, num_buckets))
    else:
        want = np.bincount(vals[(vals >= 0) & (vals < num_buckets)], minlength=num_buckets)
    got = tk.bucket_histogram(values, num_buckets)
    assert got.dtype == torch.int32 and got.shape == (num_buckets,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_buckets", [0, -1, 129, 1000])
def test_bucket_histogram_validation_matches_pallas(num_buckets):
    vals = np.zeros(BLOCK, np.int32)
    with pytest.raises(ValueError) as jerr:
        jk.bucket_histogram(vals, num_buckets)
    with pytest.raises(ValueError) as terr:
        tk.bucket_histogram(torch.from_numpy(vals), num_buckets)
    assert str(terr.value) == str(jerr.value)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (tk.unique_mask_count.launches, tk.bucket_histogram.launches)
    keys = torch.from_numpy(_sorted_keys(100, 90, 10, 12, 0))
    tk.unique_mask_count(keys, 120)
    tk.bucket_histogram(keys % 4, 4)
    assert (tk.unique_mask_count.launches, tk.bucket_histogram.launches) == before


def test_dedup_goes_through_the_unique_mask_count_wrapper(monkeypatch):
    calls = []

    def spy(keys, limit):
        calls.append((keys.shape[0], limit))
        return tk.unique_mask_count(keys, limit)

    monkeypatch.setattr(te, "unique_mask_count", spy)
    keys = torch.from_numpy(_sorted_keys(BLOCK, 5000, 40, 12, 3))
    te.dedup_df_postings(keys, vocab_size=40, max_doc_id=10)
    assert calls == [(BLOCK, 40 * 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8191, BLOCK, 1_000_003])
def test_cuda_unique_mask_count_matches_plain(n):
    _need_cuda()
    keys = torch.from_numpy(_sorted_keys(n, n - n // 9, 5000, 357, n)).cuda()
    before = tk.unique_mask_count.launches
    mask, count = tk.unique_mask_count(keys, 5000 * 357)
    pmask, pcount = tk.unique_mask_count_plain(keys, 5000 * 357)
    torch.cuda.synchronize()
    assert tk.unique_mask_count.launches == before + 1
    assert torch.equal(mask, pmask) and int(count) == int(pcount)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8194, 1_000_003, 2**24 + 4097])
@pytest.mark.parametrize("view", HIST_VIEWS)
@pytest.mark.parametrize("num_buckets", [1, 2, 26, 32, 33, 127, 128])
def test_cuda_bucket_histogram_matches_plain(num_buckets, view, n):
    """Offset and strided views, ``n % 4`` in {1, 2, 3}, 1 to 128 buckets;
    above 2**24 ids all in one bin, which no narrow counter survives."""
    _need_cuda()
    base = _hist_base(n, num_buckets, n + num_buckets, one_hot=n > 2**24)
    vals = _hist_view(torch.from_numpy(base).cuda(), view, n)
    before = tk.bucket_histogram.launches
    got = tk.bucket_histogram(vals, num_buckets)
    want = tk.bucket_histogram_plain(vals, num_buckets)
    torch.cuda.synchronize()
    assert tk.bucket_histogram.launches == before + 1
    assert torch.equal(got, want)
