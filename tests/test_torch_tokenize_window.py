"""The all-device plans' tokenizer kernel (``csrc/tokenize_window.cu``,
``kernels.tokenize_window``).

On the CPU the wrapper runs its plain version, ``tokenize_groups``: the
tests hold it equal to ``tokenize_groups`` on Zipf windows, hold both to
a byte-by-byte reference of the contract written here (each token walked
from its start byte to the next space or document start) on the edge
cases the kernel must meet, and check every refusal.  The ``cuda`` tests
hold the kernel against the plain version on the card, byte for byte,
padding included: the same edge cases, random windows over all 256 byte
values, the benchmark's Zipf window, runs longer than a tile, documents
smaller than a tile, 1, 2 and 4 live groups at width 48 and width 8, an
unaligned window; then a whole ``DeviceStreamEngine`` stream on the card
against the same stream on the CPU.  No test needs JAX, so on the card
``python -m pytest --noconftest tests/test_torch_tokenize_window.py -m cuda``
runs the card's tests."""

import bisect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models.inverted_index import (  # noqa: E501
    _pack_window,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    device_streaming as tds,
    device_tokenizer as tdt,
    kernels as tk,
)

INT32_MAX = 2**31 - 1
SPACES = frozenset(b" \t\n\v\f\r")
ROOT = Path(__file__).resolve().parent.parent


def _window(docs, *, pad_to=None, docs_cap=None):
    """``(buf, ends, ids)`` as the plans pack a window: the documents
    joined, space-padded to ``pad_to`` bytes, ends and ids padded to
    ``docs_cap`` entries (padded ends at the byte count, padded ids 1)."""
    total = sum(len(d) for d in docs)
    return _pack_window(docs, list(range(1, len(docs) + 1)),
                        total if pad_to is None else pad_to, docs_cap)


def _starts(data: bytes, inner: list) -> list:
    """Token start bytes: a non-space byte after a space, at byte 0 or at
    a document start."""
    doc_starts = set(inner)
    return [i for i, c in enumerate(data) if c not in SPACES
            and (i == 0 or data[i - 1] in SPACES or i in doc_starts)]


def _reference(buf, ends, ids, *, width, tok_cap, num_docs, sort_cols):
    """The contract, byte by byte: numpy ``(halves (2 * groups, tok_cap),
    doc (tok_cap,), max_word_len, num_tokens)``."""
    data = bytes(buf)
    n = len(data)
    inner = [int(e) for e in ends[:-1]]
    starts = _starts(data, inner)
    ngroups = tdt.num_groups_for(width)
    packed = min(width, 12 * tdt.live_groups_for(sort_cols, width))
    halves = np.zeros((2 * ngroups, tok_cap), np.int32)
    halves[:2] = INT32_MAX
    doc = np.full(tok_cap, INT32_MAX, np.int32)
    longest = 0
    for rank, p in enumerate(starts[:tok_cap]):
        slot = bisect.bisect_right(inner, p)
        stop = min(inner[slot], n) if slot < len(inner) else n
        codes = []
        for q in range(p, stop):
            if data[q] in SPACES:
                break
            if 0x61 <= data[q] | 0x20 <= 0x7A:
                codes.append(data[q] & 31)
        longest = max(longest, len(codes))
        if not codes:
            continue
        halves[:, rank] = 0
        for k, code in enumerate(codes[:packed]):
            halves[k // 6, rank] |= code << (25 - 5 * (k % 6))
        doc[rank] = ids[min(slot, num_docs - 1)]
    return halves, doc, longest, len(starts)


def _numpy(out):
    """A wrapper's output as numpy ``(halves, doc, max_word_len, num_tokens)``."""
    groups, doc, max_len, num_tokens = out
    halves = [h.cpu().numpy() for pair in groups for h in pair]
    return (np.stack(halves) if halves else np.zeros((0, 0), np.int32), doc.cpu().numpy(),
            int(max_len), int(num_tokens))


def _assert_same(got, want):
    assert got[2:] == want[2:]
    np.testing.assert_array_equal(got[0].reshape(want[0].shape), want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _args(buf, ends, ids, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in (buf, ends, ids))


def _kw(buf, ends, *, width=48, sort_cols=None, tok_cap=None, slots=5):
    """The wrapper's keywords; ``tok_cap`` defaults to the window's tokens
    and ``slots`` more."""
    if tok_cap is None:
        tok_cap = len(_starts(bytes(buf), [int(e) for e in ends[:-1]])) + slots
    return dict(width=width, sort_cols=sort_cols, tok_cap=tok_cap, num_docs=len(ends))


LETTERLESS = [b"42 abc 7x9 !! x1y2z", b"  ### 99", b"--"]
CONTROLS = [b"Hello\tWORLD\vMiXeD\fcase\rend\nZ", b"\x0b\x0cQ\x0d"]
ZERO_LENGTH = [b"", b"", b"ab", b"", b"", b"cd ef", b""]
MID_TOKEN = [b"abc", b"def", b"g h", b"ij"]
LONG_WORDS = [b"abcdefghijklm " + b"q" * 48 + b" x", b"z" * 60 + b" yy"]

# (docs, window keywords): the edge cases of the plain contract
EDGE_CASES = {
    "letterless_tokens": (LETTERLESS, {}),
    "upper_case_and_controls": (CONTROLS, {}),
    "zero_length_docs_share_a_start": (ZERO_LENGTH, {}),
    "doc_ends_mid_token": (MID_TOKEN, {}),
    "padded_window": (MID_TOKEN, dict(pad_to=64, docs_cap=9)),
    "tokens_one_below_tok_cap": (LETTERLESS, dict(slots=1)),
    "tokens_past_tok_cap": (LETTERLESS, dict(slots=-3)),
    "zero_tok_cap": (MID_TOKEN, dict(tok_cap=0)),
    "n0": ([b""], dict(tok_cap=0)),
    "n1": ([b"Q"], {}),
    "n15": ([b"abc def", b"ghi jkl"], dict(pad_to=15)),
    "words_13_48_60_all_groups": (LONG_WORDS, {}),
    "words_13_48_60_two_live_groups": (LONG_WORDS, dict(sort_cols=6)),
    "width_8": (LONG_WORDS, dict(width=8)),
    "width_8_letterless": (LETTERLESS, dict(width=8)),
}


def _edge(name):
    docs, kw = EDGE_CASES[name]
    window_kw = {k: kw[k] for k in ("pad_to", "docs_cap") if k in kw}
    buf, ends, ids = _window(docs, **window_kw)
    return (buf, ends, ids), _kw(buf, ends, **{k: v for k, v in kw.items()
                                               if k not in window_kw})


def _zipf_window(seed, num_docs=60, **kw):
    docs = tsyn.zipf_corpus(num_docs=num_docs, vocab_size=2000, tokens_per_doc=40, seed=seed)
    total = sum(len(d) for d in docs)
    return _window(docs, pad_to=-(-total // 256) * 256, **kw)


# -- CPU: the plain version and the contract ----------------------------------


@pytest.mark.parametrize("width,sort_cols", [(48, None), (48, 3), (40, 6), (8, None)])
def test_wrapper_on_the_cpu_is_tokenize_groups(width, sort_cols):
    buf, ends, ids = _zipf_window(5 + width, docs_cap=70)
    kw = _kw(buf, ends, width=width, sort_cols=sort_cols)
    tk.reset_launch_counts()
    got = tk.tokenize_window(*_args(buf, ends, ids), **kw)
    want = tdt.tokenize_groups(*_args(buf, ends, ids), **kw)
    assert tk.tokenize_window.launches == 0
    assert len(got[0]) == len(want[0]) == tdt.num_groups_for(width)
    for a, b in zip(got[0], want[0], strict=True):
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y) and x.dtype == torch.int32
    for x, y in zip(got[1:], want[1:], strict=True):
        assert torch.equal(x, y) and x.dtype == y.dtype == torch.int32
    _assert_same(_numpy(got), _reference(buf, ends, ids, **kw))


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_plain_contract_on_edge_cases(name):
    (buf, ends, ids), kw = _edge(name)
    before = tk.tokenize_window.launches
    got = _numpy(tk.tokenize_window(*_args(buf, ends, ids), **kw))
    _assert_same(got, _reference(buf, ends, ids, **kw))
    assert tk.tokenize_window.launches == before


def test_edge_cases_hit_what_they_name():
    """The cases reach the corners they are named after."""
    (buf, ends, ids), kw = _edge("tokens_past_tok_cap")
    _, _, _, num_tokens = _reference(buf, ends, ids, **kw)
    assert num_tokens == kw["tok_cap"] + 3
    (buf, ends, ids), kw = _edge("words_13_48_60_all_groups")
    halves, _, longest, _ = _reference(buf, ends, ids, **kw)
    assert longest == 60 and halves.shape[0] == 8 and (halves[7] != 0).any()
    (buf, ends, ids), kw = _edge("zero_length_docs_share_a_start")
    _, doc, _, _ = _reference(buf, ends, ids, **kw)
    # "ab" starts where three documents end: the last of them owns it
    assert doc[0] == 3 and list(ends[:2]) == [0, 0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_contract_on_random_bytes(seed):
    """Every byte value, and documents of 0 to 40 bytes."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, 3000, dtype=np.uint8)
    buf[rng.random(3000) < 0.3] = 0x20
    ends = np.sort(rng.integers(0, 3000, 120)).astype(np.int32)
    ends[-1] = 3000
    ids = rng.integers(1, 1000, 120).astype(np.int32)
    for sort_cols in (None, 3):
        kw = _kw(buf, ends, sort_cols=sort_cols)
        got = _numpy(tk.tokenize_window(*_args(buf, ends, ids), **kw))
        _assert_same(got, _reference(buf, ends, ids, **kw))


def _refused(buf, ends, ids, **kw):
    base = dict(width=48, tok_cap=64, num_docs=ids.shape[0])
    base.update(kw)
    with pytest.raises(ValueError, match="tokenize_window"):
        tk.tokenize_window(buf, ends, ids, **base)


def _good():
    buf, ends, ids = _window(MID_TOKEN)
    return _args(buf, ends, ids)


@pytest.mark.parametrize("case", [
    "data_int32", "ends_int64", "ids_int64", "non_contiguous", "two_d", "width_10",
    "width_300", "two_devices", "unsupported_device", "num_docs_0", "num_docs_past_ids",
    "empty_window_with_slots", "negative_tok_cap"])
def test_refusals(case):
    buf, ends, ids = _good()
    before = tk.tokenize_window.launches
    if case == "data_int32":
        _refused(buf.to(torch.int32), ends, ids)
    elif case == "ends_int64":
        _refused(buf, ends.to(torch.int64), ids)
    elif case == "ids_int64":
        _refused(buf, ends, ids.to(torch.int64))
    elif case == "non_contiguous":
        _refused(torch.cat([buf, buf])[::2], ends, ids)
    elif case == "two_d":
        _refused(buf.reshape(1, -1), ends, ids)
    elif case == "width_10":
        _refused(buf, ends, ids, width=10)
    elif case == "width_300":
        _refused(buf, ends, ids, width=300)
    elif case == "two_devices":
        _refused(buf, ends.to("meta"), ids)
    elif case == "unsupported_device":
        _refused(buf.to("meta"), ends.to("meta"), ids.to("meta"))
    elif case == "num_docs_0":
        _refused(buf, ends, ids, num_docs=0)
    elif case == "num_docs_past_ids":
        _refused(buf, ends, ids, num_docs=ids.shape[0] + 1)
    elif case == "empty_window_with_slots":
        _refused(buf[:0], ends, ids)
    elif case == "negative_tok_cap":
        _refused(buf, ends, ids, tok_cap=-1)
    assert tk.tokenize_window.launches == before


# -- the card: the kernel against the plain version ----------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _on_card(buf, ends, ids, offset=0, **kw):
    """The kernel and the plain version on the card, byte for byte."""
    _need_cuda()
    data = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint8), buf])).cuda()[offset:]
    args = (data, torch.from_numpy(np.array(ends)).cuda(), torch.from_numpy(np.array(ids)).cuda())
    before = tk.tokenize_window.launches
    got = _numpy(tk.tokenize_window(*args, **kw))
    torch.cuda.synchronize()
    assert tk.tokenize_window.launches == before + 1
    want = _numpy(tdt.tokenize_groups(*args, **kw))
    _assert_same(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_cuda_edge_cases(name):
    (buf, ends, ids), kw = _edge(name)
    _assert_same(_on_card(buf, ends, ids, **kw), _reference(buf, ends, ids, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_cuda_random_bytes(seed):
    """All 256 byte values, documents of 0 bytes to past a tile."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 300_000))
    buf = rng.integers(0, 256, n, dtype=np.uint8)
    buf[rng.random(n) < rng.random() * 0.5] = 0x20
    ends = np.sort(rng.integers(0, n + 1, int(rng.integers(1, 2000)))).astype(np.int32)
    ends[-1] = n
    ids = rng.integers(1, 1 << 30, len(ends)).astype(np.int32)
    for sort_cols in (None, 3):
        _on_card(buf, ends, ids, offset=seed % 3, **_kw(buf, ends, sort_cols=sort_cols))


@pytest.mark.cuda
def test_cuda_benchmark_zipf_window():
    """The benchmark cell's window: 2,500 documents of 1,000 Zipf words."""
    _need_cuda()
    from portbench import gen

    params = json.loads((ROOT / "portbench/configs/zipf100k-docs20k.json").read_text())
    c = gen.corpus({**params, "documents": 2500}, 2**31 + 11)
    docs = [c.doc(i) for i in range(len(c))]
    total = sum(len(d) for d in docs)
    buf, ends, ids = _window(docs, pad_to=-(-total // 256) * 256)
    count, max_len = tdt.host_token_stats(buf, ends)
    kw = _kw(buf, ends, sort_cols=-(-max_len // 4), tok_cap=-(-(count + 1) // 16384) * 16384)
    got = _on_card(buf, ends, ids, **kw)
    assert got[2:] == (max_len, count) and count == 2500 * 1000


@pytest.mark.cuda
def test_cuda_runs_longer_than_a_tile():
    docs = [b"a" * 20_000 + b" bb", b"1" * 20_000 + b"x " + b"Y" * 9000, b" " * 9000 + b"w",
            b"c" + b"-" * 17_000 + b"d"]
    buf, ends, ids = _window(docs)
    got = _on_card(buf, ends, ids, **_kw(buf, ends))
    assert got[2] == 20_000


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_many_documents_in_one_tile(offset):
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ab cZ9", np.uint8)
    docs = [rng.choice(alphabet, int(rng.integers(0, 8))).tobytes() for _ in range(5000)]
    buf, ends, ids = _window(docs, docs_cap=5003)
    _on_card(buf, ends, ids, offset=offset, **_kw(buf, ends))


@pytest.mark.cuda
@pytest.mark.parametrize("width,sort_cols,live", [(48, 3, 1), (48, 6, 2), (48, 12, 4),
                                                   (8, None, 1)])
def test_cuda_live_groups(width, sort_cols, live):
    assert tdt.live_groups_for(sort_cols, width) == live
    rng = np.random.default_rng(width + live)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = [rng.choice(letters, int(rng.integers(1, 49))).tobytes() for _ in range(20_000)]
    docs = [b" ".join(words[i:i + 50]) for i in range(0, len(words), 50)]
    buf, ends, ids = _window(docs)
    _on_card(buf, ends, ids, **_kw(buf, ends, width=width, sort_cols=sort_cols))


@pytest.mark.cuda
def test_cuda_engine_stream_matches_cpu():
    _need_cuda()
    windows = [_zipf_window(30 + w, num_docs=80) for w in range(4)]
    for w, (_, _, ids) in enumerate(windows):
        ids += 80 * w
    kw = dict(width=48, window_pad=4096, initial_capacity=4096)
    outs = []
    before = tk.tokenize_window.launches
    for device in ("cuda", "cpu"):
        eng = tds.DeviceStreamEngine(device=device, **kw)
        for buf, ends, ids in windows:
            count, max_len = tdt.host_token_stats(buf, ends)
            eng.feed(buf.copy(), ends.copy(), ids.copy(), tok_count=count, max_len=max_len)
        out = eng.finalize()
        outs.append({"counts": out["counts"].cpu().numpy(), "df": out["df"].cpu().numpy(),
                     "postings": out["postings"].cpu().numpy(),
                     **{f"g{g}": np.stack([h.cpu().numpy(), lo.cpu().numpy()])
                        for g, (h, lo) in enumerate(out["unique_groups"])}})
    assert tk.tokenize_window.launches == before + len(windows)
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
