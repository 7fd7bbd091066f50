"""The streaming accumulator's merge kernel (``csrc/merge_rows.cu``,
``kernels.merge_sorted_rows``) against its plain version, byte for byte:
rows and count, on random sorted-unique accumulators and windows that
share none, some or all of their rows, at 1, 2 and 4 live group pairs
of width 48 and at width 8, with an empty window or accumulator, a count
that lands exactly on the capacity, a merge into a larger capacity and
long runs of equal group keys that the tiles' diagonals fall inside.
Then a whole ``DeviceStreamEngine`` stream on the card against the same
stream on the CPU: ``rows_curve``, the finalize, snapshot, restore and
the rest of the stream.  Every test needs a CUDA device and skips
without one; none needs JAX, so on the card
``python -m pytest --noconftest tests/test_torch_cuda_merge_rows.py -m cuda``
runs them."""

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    device_streaming as tds,
    device_tokenizer as tdt,
    kernels as tk,
)

INT32_MAX = 2**31 - 1

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _pool(rng, n, nkey, key_range, docs):
    """``n`` or fewer distinct key rows (live group halves, then the
    doc), sorted lexicographically."""
    keys = rng.integers(0, key_range, (n, nkey), dtype=np.int64)
    keys[:, -1] = rng.integers(1, docs + 1, n)
    return np.unique(keys, axis=0)


def _columns(keys, cap, ncols):
    """Row columns of ``cap`` rows: the key rows first (the group pairs
    past the live ones 0), INT32_MAX after."""
    cols = np.full((ncols, cap), INT32_MAX, np.int32)
    n, nkey = keys.shape
    cols[:nkey - 1, :n] = keys[:, :-1].T
    cols[nkey - 1:ncols - 1, :n] = 0
    cols[ncols - 1, :n] = keys[:, -1]
    return cols


def _operands(seed, *, na, nb, overlap, live, key_range=1 << 30, docs=20_000):
    """Sorted-unique accumulator and window keys; ``overlap`` of the
    window's rows are accumulator rows."""
    rng = np.random.default_rng(seed)
    pool = _pool(rng, 2 * (na + nb) + 16, 2 * live + 1, key_range, docs)
    pick = rng.permutation(len(pool))
    a = pool[np.sort(pick[:na])]
    shared = min(int(round(overlap * nb)), na)
    rest = pick[na:na + nb - shared]
    b_rows = np.concatenate([a[rng.choice(na, shared, replace=False)] if shared else
                             a[:0], pool[rest]])
    b = np.unique(b_rows, axis=0)
    return a, b


def _merge_both(a_keys, b_keys, *, a_cap, b_cap, cap, live, ncols):
    _need_cuda()
    acc = _columns(a_keys, a_cap, ncols)
    win = _columns(b_keys, b_cap, ncols)
    d_acc = tuple(torch.from_numpy(c).cuda() for c in acc)
    d_win = tuple(torch.from_numpy(c).cuda() for c in win)
    a_n = torch.tensor(len(a_keys), dtype=torch.int32).cuda()
    b_n = torch.tensor(len(b_keys), dtype=torch.int32).cuda()
    before = tk.merge_sorted_rows.launches
    rows, count = tk.merge_sorted_rows(d_acc, d_win, a_n, b_n, cap=cap, live_groups=live)
    torch.cuda.synchronize()
    assert tk.merge_sorted_rows.launches == before + 1
    want, want_count = tk.merge_sorted_rows_plain(
        tuple(torch.from_numpy(c) for c in acc), tuple(torch.from_numpy(c) for c in win),
        cap=cap, live_groups=live)
    assert int(count) == int(want_count)
    assert len(rows) == len(want) == ncols
    for i, (g, w) in enumerate(zip(rows, want)):
        assert g.shape == (cap,), i
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=f"column {i}")
    return int(count)


@pytest.mark.parametrize("overlap", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("width,live", [(48, 1), (48, 2), (48, 4), (8, 1)])
def test_cuda_merge_matches_plain(width, live, overlap):
    ncols = 2 * tdt.num_groups_for(width) + 1
    a, b = _operands(width + live, na=150_000, nb=40_000, overlap=overlap, live=live)
    count = _merge_both(a, b, a_cap=len(a) + 777, b_cap=len(b) + 4096,
                        cap=len(a) + len(b) + 1000, live=live, ncols=ncols)
    assert count == len(np.unique(np.concatenate([a, b]), axis=0))
    assert count == len(a) + len(b) - round(overlap * len(b))


@pytest.mark.parametrize("empty", ["window", "accumulator", "accumulator_capacity", "both"])
def test_cuda_merge_with_an_empty_operand(empty):
    a, b = _operands(5, na=30_000, nb=9_000, overlap=0.3, live=1)
    if empty in ("window", "both"):
        b = b[:0]
    if empty != "window":
        a = a[:0]
    a_cap = 0 if empty in ("accumulator_capacity", "both") else len(a) + 512
    _merge_both(a, b, a_cap=a_cap, b_cap=len(b) + 300, cap=1 << 16, live=1, ncols=9)


@pytest.mark.parametrize("cap_over_count", [0, 1, 3])
def test_cuda_merge_count_on_or_just_under_the_capacity(cap_over_count):
    """The output count lands on ``cap`` (no padding row) or 1 and 3
    below it; ``cap`` is not a multiple of 4, so the columns of the
    output are misaligned for 16-byte stores."""
    a, b = _operands(6, na=70_001, nb=20_003, overlap=0.3, live=2)
    unique = len(np.unique(np.concatenate([a, b]), axis=0))
    count = _merge_both(a, b, a_cap=len(a), b_cap=len(b), cap=unique + cap_over_count,
                        live=2, ncols=9)
    assert count == unique


def test_cuda_merge_into_a_larger_capacity():
    a, b = _operands(7, na=100_000, nb=60_000, overlap=0.3, live=1)
    _merge_both(a, b, a_cap=1 << 17, b_cap=len(b) + 7, cap=1 << 19, live=1, ncols=9)


@pytest.mark.parametrize("live", [1, 2])
def test_cuda_merge_inside_runs_of_equal_group_keys(live):
    """Few distinct group keys, many docs each: every tile's diagonals
    fall inside runs of rows that differ only in the doc, and a window
    row equal to an accumulator row can sit at any tile edge."""
    a, b = _operands(8 + live, na=200_000, nb=80_000, overlap=0.5, live=live,
                     key_range=3, docs=60_000)
    _merge_both(a, b, a_cap=len(a) + 1, b_cap=len(b) + 2, cap=len(a) + len(b) + 3,
                live=live, ncols=9)


# -- the engine ----------------------------------------------------------------


def _byte_windows(n=6):
    """Byte windows of distinct documents, the last one a repeat of the
    first window's documents under the same ids."""
    out = []
    for w in range(n - 1):
        docs = tsyn.zipf_corpus(num_docs=80, vocab_size=30_000, tokens_per_doc=300,
                                seed=40 + w)
        total = sum(len(d) for d in docs)
        buf = np.full(-(-total // 4096) * 4096, 0x20, np.uint8)
        buf[:total] = np.frombuffer(b"".join(docs), np.uint8)
        ends = np.cumsum([len(d) for d in docs]).astype(np.int32)
        out.append((buf, ends, np.arange(1, 81, dtype=np.int32) + 80 * w))
    out.append(out[0])
    return out


def _feed(eng, windows):
    for buf, ends, ids in windows:
        count, max_len = tdt.host_token_stats(buf, ends)
        eng.feed(buf.copy(), ends.copy(), ids.copy(), tok_count=count, max_len=max_len)
    return eng


def _finalized(eng) -> dict:
    out = eng.finalize()
    flat = {k: out[k].cpu().numpy() for k in ("counts", "df", "postings")}
    for g, (hi, lo) in enumerate(out["unique_groups"]):
        flat[f"g{g}"] = np.stack([hi.cpu().numpy(), lo.cpu().numpy()])
    return flat


def test_cuda_engine_stream_matches_cpu_through_snapshot_and_restore():
    _need_cuda()
    windows = _byte_windows()
    kw = dict(width=48, window_pad=4096, initial_capacity=4096)
    before = tk.merge_sorted_rows.launches
    card = _feed(tds.DeviceStreamEngine(device="cuda", **kw), windows[:3])
    cpu = _feed(tds.DeviceStreamEngine(device="cpu", **kw), windows[:3])
    assert tk.merge_sorted_rows.launches == before + 3
    snap, want = card.snapshot(), cpu.snapshot()
    for k in ("count", "cap", "live_groups", "max_word_len", "windows_fed", "rows_curve"):
        assert snap[k] == want[k], k
    for a, b in zip(snap["columns"], want["columns"], strict=True):
        np.testing.assert_array_equal(a, b)
    rest = tds.DeviceStreamEngine(device="cuda", **kw)
    rest.restore(snap)
    for eng in (rest, card, cpu):
        _feed(eng, windows[3:])
        eng.snapshot()  # drains, so every merge is resolved
    assert card.rows_curve == cpu.rows_curve and len(card.rows_curve) == len(windows)
    assert rest.rows_curve == cpu.rows_curve
    # the last window repeats the first: every one of its rows is a duplicate
    first_pairs = cpu.rows_curve[0]
    assert card.merge_dup_rows == cpu.merge_dup_rows == first_pairs
    assert rest.merge_dup_rows == first_pairs
    assert card.capacity == cpu.capacity > 4096
    outs = [_finalized(e) for e in (card, rest, cpu)]
    for k in outs[2]:
        np.testing.assert_array_equal(outs[0][k], outs[2][k], err_msg=k)
        np.testing.assert_array_equal(outs[1][k], outs[2][k], err_msg=k)
