"""The streaming all-device plan on a mesh of n = 2 and 4 CPU positions,
through the CLI: its per-window spans (``read``, ``pack``, ``scan`` and
``feed`` under ``stream_feed``; ``tokenize``, ``exchange``, ``merge`` and
``card_wait`` under ``feed``) and counters, the exchange's bytes and the
rows that changed position against a recount in numpy and against what
the exchange delivered, each owner's
block against the plain reference index (``portbench/reference``)
restricted to the words the content hash gives that owner, and one
build past 65,534 documents against the reference's letter files and
index."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import write_manifest
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus.scheduler import (
    plan_contiguous_ranges,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
    inverted_index,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    device_tokenizer as DT,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
    dist_device_streaming as DDS,
)
from portbench import gen
from portbench.entries import build as pbuild
from portbench.reference import letters

pytestmark = pytest.mark.obs

WIDTH = 48  # the default device_tokenize_width
CHUNK = 9
M32 = 0xFFFFFFFF
INT32_MAX = 2**31 - 1


def _mix32(cols) -> int:
    """The mesh's word-content hash (mul-xor over 32-bit words)."""
    h = cols[0] & M32
    for c in cols[1:]:
        h = ((h ^ (c & M32)) * 0x9E3779B1) & M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    return h ^ (h >> 13)


def _owner(word: bytes, n: int) -> int:
    """The owner of a cleaned word: its 5-bit letter codes, 12 to a
    (hi, lo) pair of 6 each, every pair of the row width hashed."""
    codes = [b & 31 for b in word] + [0] * (WIDTH - len(word))
    cols = []
    for g in range((WIDTH // 4 + 2) // 3):
        for half in (12 * g, 12 * g + 6):
            cols.append(sum(codes[half + k] << (25 - 5 * k) for k in range(6)
                            if half + k < WIDTH))
    return _mix32(cols) % n


def _words(doc: bytes) -> list[bytes]:
    """The document's cleaned words, in order (C-locale whitespace splits,
    letters kept and lowercased)."""
    out = []
    for tok in doc.split():
        w = bytes(b | 0x20 for b in tok if chr(b).isascii() and chr(b).isalpha())
        if w:
            out.append(w)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_stream")
    docs = tsyn.zipf_corpus(num_docs=31, vocab_size=300, tokens_per_doc=40, seed=4)
    # a 20-letter word in the last window: the rows gain a group pair
    docs.append(b"Abcdefghijklmnopqrst 7 Zipf-law zipf")
    write_manifest(root / "list.txt", tsyn.write_corpus(root / "docs", docs))
    return root, docs


def _cli(argv: list[str]) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def mesh_build(request, corpus):
    """One traced mesh build: its stats, its spans, its owner blocks and,
    per exchange, the rows and bytes each position delivered to another."""
    root, docs = corpus
    n = request.param
    out = root / f"out{n}"
    owners = {}
    delivered = []
    emit = inverted_index.InvertedIndexModel._merge_emit_owner_blocks
    exchange = DDS.exchange_buckets

    def keep(self, blocks, **kw):
        owners.update(blocks)
        return emit(self, blocks, **kw)

    def spy(send_rows, buckets, *, mesh, capacity):
        # recv[d][c]: column c of what d received, source-major, each
        # source's block ``capacity`` long (INT32_MAX past its rows)
        recv = exchange(send_rows, buckets, mesh=mesh, capacity=capacity)
        pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
        delivered.append((
            sum(int((recv[d][0][s * capacity:(s + 1) * capacity] != INT32_MAX).sum())
                for s, d in pairs),
            sum(col[s * capacity:(s + 1) * capacity].numel() * 4
                for s, d in pairs for col in recv[d])))
        return recv

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(inverted_index.InvertedIndexModel, "_merge_emit_owner_blocks", keep)
        mp.setattr(DDS, "exchange_buckets", spy)
        st = _cli(["4", "26", str(root / "list.txt"), "--device", "cpu", "--device-shards",
                   str(n), "--device-tokenize", "--stream-chunk-docs", str(CHUNK), "--artifact",
                   "--stats", "--output-dir", str(out), "--trace-out", str(root / f"t{n}.json")])
    events = json.loads((root / f"t{n}.json").read_text())["traceEvents"]
    return n, docs, st, [e for e in events if e["ph"] == "X"], owners, delivered


def _windows(docs, n):
    """Each window's shards, each a list of its documents' word sets."""
    for lo in range(0, len(docs), CHUNK):
        win = docs[lo:lo + CHUNK]
        yield [[set(_words(d)) for d in win[a:b]]
               for a, b in plan_contiguous_ranges([len(d) for d in win], n)]


def _exchanges(docs, n):
    """Each window's exchange, recounted: ``(sent, cols)``, ``sent[s][d]``
    the unique (word, doc) rows shard ``s`` has for owner ``d`` and
    ``cols`` the int32 columns of a row (the live group pairs and the
    doc)."""
    longest = 1
    for shards in _windows(docs, n):
        longest = max([longest] + [len(w) for shard in shards for ws in shard for w in ws])
        sent = np.zeros((n, n), np.int64)
        for s, shard in enumerate(shards):
            for ws in shard:
                for w in ws:
                    sent[s, _owner(w, n)] += 1
        yield sent, 2 * ((min(-(-longest // 4), WIDTH // 4) + 2) // 3) + 1


def test_spans_nest_per_window(mesh_build):
    n, docs, st, spans, _, _ = mesh_build
    windows = -(-len(docs) // CHUNK)
    assert st["stream_windows"] == windows and st["merge_retries"] == 0
    # the CPU positions tokenize with the tokenize kernel's plain version
    assert st["stream_tokenize_kernel_launches"] == 0
    assert st["device_shards"] == n
    for name, parent in (("read", "stream_feed"), ("pack", "stream_feed"),
                         ("scan", "stream_feed"), ("feed", "stream_feed"),
                         ("tokenize", "feed"), ("exchange", "feed"), ("merge", "feed")):
        got = [e for e in spans if e["name"] == name]
        assert len(got) == windows, name
        assert {e["args"]["parent"] for e in got} == {parent}, name
    # the per-window read and the finalize's
    waits = [e["args"]["parent"] for e in spans if e["name"] == "card_wait"]
    assert waits == ["feed"] * windows + ["device_index"]
    assert len(st["window_read_ms"]) == len(st["window_scan_ms"]) == windows
    reads = [e["dur"] / 1e3 for e in spans if e["name"] == "read"]
    assert reads[:windows] == pytest.approx(st["window_read_ms"], abs=2e-3)
    assert st["card_wait_ms"] == pytest.approx(
        sum(e["dur"] for e in spans if e["name"] == "card_wait") / 1e3, abs=0.01)


def test_exchange_bytes_are_every_window_padded_exchange(mesh_build):
    """Each window's exchange is sized to its largest bucket (rounded up
    to 8 rows), the same for every (source, destination) pair."""
    n, docs, st, _, _, _ = mesh_build
    want = 0
    for sent, cols in _exchanges(docs, n):
        cap = -(-int(sent.max()) // 8) * 8
        want += n * (n - 1) * cap * cols * 4
    assert st["exchange_bytes"] == want


def test_valid_rows_are_the_rows_that_changed_position(mesh_build):
    """Each shard dedups its window first: one row per (word, document)."""
    n, docs, st, _, _, _ = mesh_build
    moved = moved_bytes = 0
    for sent, cols in _exchanges(docs, n):
        rows = int(sent.sum() - np.trace(sent))
        moved += rows
        moved_bytes += rows * cols * 4
    assert moved > 0 and st["exchange_valid_rows"] == moved
    assert st["exchange_valid_bytes"] == moved_bytes < st["exchange_bytes"]


def test_counters_are_what_the_exchange_delivered(mesh_build):
    """The counters read the exchange itself: the rows that were not
    padding, and every byte, that one position sent another."""
    n, docs, st, _, _, delivered = mesh_build
    assert len(delivered) == st["stream_windows"]
    assert st["exchange_valid_rows"] == sum(rows for rows, _ in delivered)
    assert st["exchange_bytes"] == sum(nbytes for _, nbytes in delivered)


def test_each_owner_holds_its_share_of_the_reference(mesh_build):
    n, docs, st, _, owners, _ = mesh_build
    buf = np.frombuffer(b"".join(docs), np.uint8)
    lens = np.array([len(d) for d in docs])
    ix = letters.index(buf, np.cumsum(lens) - lens, np.cumsum(lens))
    want = {w: t for t, w in enumerate(ix.words)}
    assert sorted(owners) == list(range(n))
    seen = []
    for o, ow in owners.items():
        words = [bytes(w) for w in DT.decode_word_groups(ow["unique_groups"], WIDTH).tolist()]
        assert sorted(words) == sorted(w for w in ix.words if _owner(w, n) == o)
        offsets = np.cumsum(ow["df"]) - ow["df"]
        for w, df, at in zip(words, ow["df"].tolist(), offsets.tolist()):
            t = want[w]
            assert df == ix.df[t]
            assert (ow["postings"][at:at + df] == ix.docs[ix.offsets[t]:ix.offsets[t + 1]]).all()
        seen += words
    assert len(seen) == len(set(seen)) == len(ix.words)
    assert st["owner_rows"] == [owners[o]["num_pairs"] for o in range(n)]
    assert sum(st["owner_rows"]) == ix.unique_pairs == st["unique_pairs"]


def test_a_build_past_16_bit_doc_ids_matches_the_reference(tmp_path):
    params = {"documents": 65_600, "generator": {
        "documents_key": "documents", "tokens_per_doc": 3, "vocab": 500, "alpha": 1.2,
        "min_word": 2, "max_word": 10}}
    c = gen.corpus(params, 2 ** 31 + 7)
    write_manifest(tmp_path / "list.txt", gen.write_files(c, tmp_path / "docs"))
    out = tmp_path / "out"
    st = _cli(["4", "26", str(tmp_path / "list.txt"), "--device", "cpu", "--device-shards",
               "4", "--device-tokenize", "--stream-chunk-docs", "33000", "--artifact",
               "--stats", "--output-dir", str(out)])
    assert st["documents"] == 65_600 and st["device_shards"] == 4 and st["stream_windows"] == 2
    ix = letters.index(c.buf, c.starts, c.stops)
    assert int(ix.docs.max()) > 65_534
    got = [(out / f"{chr(ord('a') + i)}.txt").read_bytes() for i in range(26)]
    assert got == letters.letter_files(ix)
    assert pbuild.artifact_wrong(Path(out / "index.mri"), ix, len(c),
                                 pbuild.sample_terms(ix, 7)) == (0, 0)
