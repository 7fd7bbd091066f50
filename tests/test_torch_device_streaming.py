"""The port's device stream engine (``ops/device_streaming.py``) against
the JAX package's on the same byte windows: ``window_rows`` at word-row
widths 8, 48 and 64, the accumulator merge and its exact count, the
finalize, a multi-window engine run (rows, counts, ``rows_curve``,
capacity), and snapshot/restore with every rejection — all exactly
equal.  Inputs are made from seeds with numpy; the JAX side always gets
fresh numpy copies that are never mutated (its CPU backend may alias
host memory).  The whole builds are in
``tests/test_torch_device_streaming_build.py``."""

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.ops import (
    device_streaming as JDS,
    device_tokenizer as JDT,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    device_streaming as TDS,
    device_tokenizer as TDT,
    kernels as TK,
)

INT32_MAX = 2**31 - 1


def _window(seed, num_docs=6, max_word=12, pad=512):
    """A seeded byte window: Zipf words cut to at most ``max_word``
    letters, junk bytes, an empty doc and a doc-spanning repeat."""
    rng = np.random.default_rng(seed)
    docs = tsyn.zipf_corpus(num_docs=num_docs, vocab_size=60, tokens_per_doc=25, seed=seed)
    out = []
    for i, d in enumerate(docs):
        words = [w[: int(rng.integers(1, max_word + 1))] for w in d.split()]
        if i % 3 == 1:
            words.append(b"x" * max_word)
        out.append(b"" if i == 2 else b" ".join(words) + b" 42 -- A.B")
    out.append(out[0])  # the same words in another doc
    total = sum(len(d) for d in out)
    buf = np.full(-(-total // pad) * pad, 0x20, np.uint8)
    buf[:total] = np.frombuffer(b"".join(out), np.uint8)
    ends = np.cumsum([len(d) for d in out]).astype(np.int32)
    ids = np.arange(1, len(out) + 1, dtype=np.int32) + 10 * seed
    return buf, ends, ids


def _stats(buf, ends):
    return TDT.host_token_stats(buf, ends)


def _jax_window_rows(buf, ends, ids, **kw):
    import jax

    rows, counts = JDS.window_rows(jax.device_put(buf.copy()), jax.device_put(ends.copy()),
                                   jax.device_put(ids.copy()), **kw)
    return [np.asarray(r) for r in rows], np.asarray(counts)


def _torch_window_rows(buf, ends, ids, **kw):
    rows, counts = TDS.window_rows(torch.from_numpy(buf.copy()), torch.from_numpy(ends.copy()),
                                   torch.from_numpy(ids.copy()), **kw)
    return [r.numpy() for r in rows], counts.numpy()


def _assert_cols_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"column {i}")


# -- window_rows, merge, finalize ----------------------------------------------


@pytest.mark.parametrize("sort_cols", ["below", "at"])
@pytest.mark.parametrize("width", [8, 48, 64])
def test_window_rows_matches_jax(width, sort_cols):
    buf, ends, ids = _window(width, max_word=min(width, 30))
    count, max_len = _stats(buf, ends)
    ncols = width // 4
    sc = ncols if sort_cols == "at" else max(1, min(-(-max_len // 4), ncols) - 3)
    kw = dict(width=width, tok_cap=count + 64, num_docs=len(ids), sort_cols=sc,
              num_groups=TDT.num_groups_for(width), out_cap=count + 64)
    j_rows, j_counts = _jax_window_rows(buf, ends, ids, **kw)
    t_rows, t_counts = _torch_window_rows(buf, ends, ids, **kw)
    _assert_cols_equal(t_rows, j_rows)
    np.testing.assert_array_equal(t_counts, j_counts)
    assert t_counts[2] == count and t_counts[1] == max_len
    # the unique rows come first, padding rows (INT32_MAX everywhere) after
    n = int(t_counts[0])
    assert all((c[n:] == INT32_MAX).all() for c in t_rows)


def _rows_pair(seed, width, live_cols):
    buf, ends, ids = _window(seed, max_word=min(width, 30))
    count, _ = _stats(buf, ends)
    kw = dict(width=width, tok_cap=count + 64, num_docs=len(ids), sort_cols=live_cols,
              num_groups=TDT.num_groups_for(width), out_cap=count + 64)
    return _torch_window_rows(buf, ends, ids, **kw)[0]


@pytest.mark.parametrize("live_groups", [1, 2, 4])
def test_merge_unique_rows_matches_jax_with_an_exact_count(live_groups):
    """The merge count is the true unique-row count (padding never
    counts), equal to JAX's, with ``live_groups`` below ``num_groups``
    as well as at it; a window without its dead pairs merges the same."""
    width, cap = 48, 1024
    sc = 3 * live_groups
    acc = [np.concatenate([c, np.full(cap - len(c), INT32_MAX, np.int32)])
           for c in _rows_pair(1, width, sc)]
    win = _rows_pair(2, width, sc)
    t_rows, t_count = TDS._merge_unique_rows(
        tuple(torch.from_numpy(a.copy()) for a in acc), tuple(torch.from_numpy(w.copy()) for w in win),
        cap=cap, live_groups=live_groups)
    import jax

    j_rows, j_count = JDS._merge_unique_rows(
        tuple(jax.device_put(a.copy()) for a in acc), tuple(jax.device_put(w.copy()) for w in win),
        cap=cap, live_groups=live_groups)
    _assert_cols_equal([r.numpy() for r in t_rows], [np.asarray(r) for r in j_rows])
    truth = {tuple(int(c[i]) for c in rows) for rows in (acc, win)
             for i in range(len(rows[0])) if rows[0][i] != INT32_MAX}
    assert int(t_count) == int(j_count) == len(truth)
    # the mesh's call: a window of its live pairs and its doc alone
    live_rows, live_count = TDS._merge_unique_rows(
        tuple(torch.from_numpy(a.copy()) for a in acc),
        tuple(torch.from_numpy(w.copy()) for w in win[:2 * live_groups] + win[-1:]),
        cap=cap, live_groups=live_groups)
    _assert_cols_equal([r.numpy() for r in live_rows], [r.numpy() for r in t_rows])
    assert int(live_count) == int(t_count)


def _merge_operands(live_groups, acc_cap):
    """A sorted-unique accumulator of ``acc_cap`` rows and a window that
    shares some of its rows, as CPU tensors, with their valid counts."""
    width, sc = 48, 3 * live_groups
    first = _rows_pair(1, width, sc)
    win = _rows_pair(2, width, sc)
    acc, _ = TDS._merge_unique_rows(tuple(torch.from_numpy(c) for c in first),
                                    tuple(torch.from_numpy(c[:5]) for c in win),
                                    cap=acc_cap, live_groups=live_groups)
    counts = [int((c[0] != INT32_MAX).sum()) for c in (acc, win)]
    return acc, tuple(torch.from_numpy(c) for c in win), counts


@pytest.mark.parametrize("acc_cap,cap", [(1024, 1024), (600, 2048)])
@pytest.mark.parametrize("live_groups", [1, 2, 4])
def test_merge_sorted_rows_takes_the_plain_version_on_the_cpu(live_groups, acc_cap, cap):
    """On CPU tensors the wrapper is the sort-based merge, launches no
    kernel, and gives the same rows when the output capacity is larger
    than the accumulator's."""
    acc, win, (na, nb) = _merge_operands(live_groups, acc_cap)
    before = TK.merge_sorted_rows.launches
    rows, count = TK.merge_sorted_rows(acc, win, torch.tensor(na, dtype=torch.int32),
                                       torch.tensor(nb, dtype=torch.int32), cap=cap,
                                       live_groups=live_groups)
    assert TK.merge_sorted_rows.launches == before
    want, want_count = TDS._merge_unique_rows(acc, win, cap=cap, live_groups=live_groups)
    assert int(count) == int(want_count)
    _assert_cols_equal([r.numpy() for r in rows], [w.numpy() for w in want])
    assert all(r.shape == (cap,) for r in rows)


@pytest.mark.parametrize("fault,match", [
    ("column_counts", "odd column count"),
    ("even_columns", "odd column count"),
    ("live_groups", "live_groups"),
    ("dtype", "int32 columns"),
    ("ragged", "int32 columns"),
    ("count_dtype", "int32 scalars"),
    ("negative_cap", "negative"),
])
def test_merge_sorted_rows_refuses_what_the_kernel_does_not_take(fault, match):
    acc, win, (na, nb) = _merge_operands(1, 1024)
    a_n, b_n = torch.tensor(na, dtype=torch.int32), torch.tensor(nb, dtype=torch.int32)
    kw = dict(cap=1024, live_groups=1)
    if fault == "column_counts":
        win = win[:-2]
    elif fault == "even_columns":
        acc, win = acc[:-1], win[:-1]
    elif fault == "live_groups":
        kw["live_groups"] = 5
    elif fault == "dtype":
        acc = (acc[0].to(torch.int64),) + acc[1:]
    elif fault == "ragged":
        win = win[:-1] + (win[-1][:-1],)
    elif fault == "count_dtype":
        a_n = a_n.to(torch.int64)
    else:
        kw["cap"] = -1
    with pytest.raises(ValueError, match=match):
        TK.merge_sorted_rows(acc, win, a_n, b_n, **kw)


@pytest.mark.parametrize("second", ["repeat", "disjoint"])
def test_engine_counts_the_window_rows_already_merged(second):
    """A window fed twice adds no row, and its pairs count as duplicate
    rows; a window of other documents adds all of its rows."""
    buf, ends, ids = _window(6)
    windows = [(buf, ends, ids), (buf, ends, ids if second == "repeat" else ids + 1000)]
    eng = TDS.DeviceStreamEngine(width=48, device="cpu", window_pad=256)
    for b, e, i in windows:
        count, max_len = _stats(b, e)
        eng.feed(b.copy(), e.copy(), i.copy(), tok_count=count, max_len=max_len)
    eng.snapshot()  # resolves both merges
    first = eng.rows_curve[0]
    if second == "repeat":
        assert eng.rows_curve == [first, first] and eng.merge_dup_rows == first
    else:
        assert eng.rows_curve == [first, 2 * first] and eng.merge_dup_rows == 0


@pytest.mark.parametrize("width", [8, 48])
def test_finalize_rows_body_matches_jax(width):
    cap = 2048
    rows, _ = TDS._merge_unique_rows(
        tuple(torch.full((cap,), INT32_MAX, dtype=torch.int32)
              for _ in range(2 * TDT.num_groups_for(width) + 1)),
        tuple(torch.from_numpy(r) for r in _rows_pair(3, width, width // 4)),
        cap=cap, live_groups=TDT.num_groups_for(width))
    acc = [r.numpy() for r in rows]
    t = TDS.finalize_rows_body(tuple(torch.from_numpy(a.copy()) for a in acc),
                               num_groups=TDT.num_groups_for(width),
                               live_groups=TDT.num_groups_for(width))
    import jax

    j = JDS._finalize_rows(tuple(jax.device_put(a.copy()) for a in acc),
                           num_groups=TDT.num_groups_for(width))
    _assert_finalize_equal(t, j)
    assert int(t["counts"][1]) == int((acc[0] != INT32_MAX).sum())


@pytest.mark.parametrize("sort_cols", [3, 6])
def test_finalize_rows_body_of_the_live_pairs_matches_jax(sort_cols):
    """Reading only the live pairs gives JAX's index over every pair:
    the later pairs of a window's rows are zero on every valid row."""
    width = 48
    live = TDT.live_groups_for(sort_cols, width)
    rows = _rows_pair(3, width, sort_cols)
    valid = rows[0] != INT32_MAX
    assert valid.any() and all((r[valid] == 0).all() for r in rows[2 * live:-1])
    t = TDS.finalize_rows_body(tuple(torch.from_numpy(r.copy()) for r in rows),
                               num_groups=TDT.num_groups_for(width), live_groups=live)
    import jax

    j = JDS._finalize_rows(tuple(jax.device_put(r.copy()) for r in rows),
                           num_groups=TDT.num_groups_for(width))
    _assert_finalize_equal(t, j)


def _assert_finalize_equal(t, j):
    np.testing.assert_array_equal(t["counts"].numpy(), np.asarray(j["counts"]))
    for k in ("df", "postings"):
        got, want = t[k].numpy(), np.asarray(j[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert len(t["unique_groups"]) == len(j["unique_groups"])
    for (th, tl), (jh, jl) in zip(t["unique_groups"], j["unique_groups"]):
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# -- the engine ----------------------------------------------------------------


def _stream_windows(width=48, n=5):
    """Seeded windows for a multi-window run, one of them empty."""
    out = []
    for seed in range(n):
        if seed == 2:
            buf = np.full(512, 0x20, np.uint8)
            out.append((buf, np.array([512], np.int32), np.array([99], np.int32)))
            continue
        out.append(_window(seed + 4, max_word=min(width, 20)))
    return out


def _feed_both(windows, width, **kw):
    t_eng = TDS.DeviceStreamEngine(width=width, device="cpu", **kw)
    j_eng = JDS.DeviceStreamEngine(width=width, **kw)
    for buf, ends, ids in windows:
        count, max_len = _stats(buf, ends)
        # each engine gets its own fresh copies, never mutated afterwards
        t_eng.feed(buf.copy(), ends.copy(), ids.copy(), tok_count=count, max_len=max_len)
        j_eng.feed(buf.copy(), ends.copy(), ids.copy(), tok_count=count, max_len=max_len)
    return t_eng, j_eng


@pytest.mark.parametrize("initial_capacity", [256, 1 << 16])
def test_engine_run_matches_jax(initial_capacity):
    """A multi-window run — with an empty window and, at a small initial
    capacity, host-side doubling — gives JAX's finalize, curve and
    capacity."""
    t_eng, j_eng = _feed_both(_stream_windows(), 48, window_pad=256,
                              initial_capacity=initial_capacity)
    assert t_eng.windows_fed == j_eng.windows_fed == 4
    assert t_eng.capacity == j_eng.capacity
    assert t_eng.max_word_len == j_eng.max_word_len
    t_out, j_out = t_eng.finalize(), j_eng.finalize()
    assert t_eng.rows_curve == j_eng.rows_curve and len(t_eng.rows_curve) == 2
    _assert_finalize_equal(t_out, j_out)
    if initial_capacity == 256:
        assert t_eng.capacity > 256


def test_hooked_feed_resolves_every_merge_like_jax():
    stages = []
    t_eng = TDS.DeviceStreamEngine(width=48, device="cpu", window_pad=256, initial_capacity=256)
    j_eng = JDS.DeviceStreamEngine(width=48, window_pad=256, initial_capacity=256)
    for buf, ends, ids in _stream_windows():
        count, max_len = _stats(buf, ends)
        t_eng.feed(buf.copy(), ends.copy(), ids.copy(), tok_count=count, max_len=max_len,
                   stage_hook=lambda name, _: stages.append(name))
        j_eng.feed(buf.copy(), ends.copy(), ids.copy(), tok_count=count, max_len=max_len,
                   stage_hook=lambda name, _: None)
    assert stages == ["upload", "window_rows", "merge"] * 4
    assert t_eng.rows_curve == j_eng.rows_curve and len(t_eng.rows_curve) == 4
    assert t_eng.capacity == j_eng.capacity


def test_engine_with_no_windows_fed():
    eng = TDS.DeviceStreamEngine(width=48, device="cpu")
    assert eng.snapshot() is None and eng.snapshot_nbytes == 0
    with pytest.raises(ValueError, match="no windows fed"):
        eng.finalize()


def test_engine_refuses_a_classifier_divergence():
    buf, ends, ids = _window(3)
    count, max_len = _stats(buf, ends)
    eng = TDS.DeviceStreamEngine(width=48, device="cpu")
    eng.feed(buf, ends, ids, tok_count=count, max_len=max_len + 1)
    with pytest.raises(AssertionError, match="classifier divergence"):
        eng.finalize()


# -- snapshot / restore --------------------------------------------------------


def _fed(width=48, windows=None, **kw):
    kw.setdefault("window_pad", 256)
    return _feed_both(windows or _stream_windows()[:2], width, **kw)


def test_snapshot_matches_jax_and_round_trips():
    t_eng, j_eng = _fed()
    assert t_eng.snapshot_nbytes == j_eng.snapshot_nbytes
    t_snap, j_snap = t_eng.snapshot(), j_eng.snapshot()
    for k in ("width", "fetched_nbytes", "count", "cap", "live_groups", "max_word_len",
              "windows_fed", "rows_curve"):
        assert t_snap[k] == j_snap[k], k
    _assert_cols_equal(t_snap["columns"], [np.asarray(c) for c in j_snap["columns"]])
    # a restored engine finishes the stream exactly like the live one
    rest = TDS.DeviceStreamEngine(width=48, device="cpu", window_pad=256)
    rest.restore(t_snap)
    assert rest.windows_fed == 2 and rest.rows_curve == t_snap["rows_curve"]
    for eng in (rest, t_eng):
        for buf, ends, ids in _stream_windows()[3:]:
            count, max_len = _stats(buf, ends)
            eng.feed(buf.copy(), ends.copy(), ids.copy(), tok_count=count, max_len=max_len)
    a, b = rest.finalize(), t_eng.finalize()
    for k in ("counts", "df", "postings"):
        assert torch.equal(a[k], b[k]), k


def test_snapshot_prefix_fetch_matches_the_full_fetch():
    eng, _ = _fed()
    eng._snapshot_granule = 8  # force pad < cap
    assert eng.snapshot_nbytes < (2 * eng._num_groups + 1) * eng.capacity * 4
    trimmed = eng.snapshot()
    full, _ = _fed()
    full._snapshot_granule = full.capacity  # pad == cap: the whole columns
    reference = full.snapshot()
    assert trimmed["count"] == reference["count"] > 0
    assert trimmed["fetched_nbytes"] < reference["fetched_nbytes"]
    _assert_cols_equal(trimmed["columns"], reference["columns"])


@pytest.mark.parametrize("fault,match", [
    ("not_fresh", "fresh engine"),
    ("width", "checkpoint width"),
    ("num_columns", "row columns"),
    ("count_over_cap", "exceeds its capacity"),
    ("short_columns", "truncated or corrupt"),
    ("one_short_column", "column .* truncated or corrupt"),
])
def test_restore_rejections_match_jax(fault, match):
    snap = _fed()[0].snapshot()
    target_t = TDS.DeviceStreamEngine(width=48, device="cpu")
    target_j = JDS.DeviceStreamEngine(width=48)
    if fault == "not_fresh":
        for eng in (target_t, target_j):
            eng.windows_fed = 1
    elif fault == "width":
        target_t = TDS.DeviceStreamEngine(width=64, device="cpu")
        target_j = JDS.DeviceStreamEngine(width=64)
    elif fault == "num_columns":
        snap = dict(snap, columns=snap["columns"][:-1])
    elif fault == "count_over_cap":
        snap = dict(snap, count=snap["cap"] + 1)
    elif fault == "short_columns":
        snap = dict(snap, columns=[c[:-1] for c in snap["columns"]])
    else:
        snap = dict(snap, columns=snap["columns"][:-1] + [snap["columns"][-1][:-1]])
    with pytest.raises(ValueError, match=match):
        target_t.restore(snap)
    with pytest.raises(ValueError, match=match):
        target_j.restore(snap)


def test_restore_accepts_a_jax_snapshot():
    t_eng, j_eng = _fed()
    rest = TDS.DeviceStreamEngine(width=48, device="cpu")
    j_snap = j_eng.snapshot()
    rest.restore({**j_snap, "columns": [np.asarray(c) for c in j_snap["columns"]]})
    a = rest.finalize()
    t_eng.snapshot()  # drains, as the JAX snapshot did
    b = t_eng.finalize()
    for k in ("counts", "df", "postings"):
        assert torch.equal(a[k], b[k]), k
