"""The port's all-device plan (``device_tokenize``) against the JAX
package's: ``index_bytes_device`` on the same bytes (word-row widths 40,
48 and 64, with and without the host-exact ``sort_cols`` bound, through
both of the JAX letter-compaction branches), the frontends, the fetch
packing, the word-row decode, the host token statistics, and whole
builds byte-equal to the JAX build, the oracle and the smoke golden —
including the ``WidthOverflow`` restart.  Inputs are made from seeds
with numpy; the JAX side always gets fresh numpy copies (its CPU
backend may alias host memory)."""

import json

import numpy as np
import pytest
import torch

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import native as jnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.ops import (
    device_tokenizer as JDT,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native as tnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    device_tokenizer as TDT,
)

from conftest import read_letter_files

DEVICE_PHASES = {"load", "feed", "device_index", "fetch", "host_views", "emit"}
DEVICE_COUNTERS = ("documents", "device_tokenize_width", "sort_cols", "unique_terms",
                   "unique_pairs", "tokens", "fetched_bytes", "lines_written")

EDGE_DOCS = [
    [b"don't foo-bar x1y2z3 I.Loomings tail42", b"", b"  42 ",
     b"pack my box with five dozen liquor jugs"],
    [b"supercalifragilisticexpialidocious antidisestablishmentarianism",
     b"zz top zz top aa"],
    # 39- and 37-letter words reach into the partial last group at width 40
    [b"a" * 39 + b" zz " + b"q" * 37, b"mid"],
    [b"a"] * 7 + [b"bb ccc"],
    [b"abc", b"", b"", b"de", b""],  # zero-length docs collide on one start byte
    [b"word\tword\nword\vword\fword\rword UPPER lower MiXeD"],
]


def _pad_concat(docs, multiple=256):
    total = sum(len(d) for d in docs)
    padded = -(-max(total, 1) // multiple) * multiple
    buf = np.full(padded, 0x20, np.uint8)
    if total:
        buf[:total] = np.frombuffer(b"".join(docs), np.uint8)
    ends = np.cumsum([len(d) for d in docs]).astype(np.int32)
    return buf, ends


def _seeded_docs(seed, num_docs=9):
    """Zipf words plus seeded junk bytes (digits, punctuation, upper
    case, tabs, UTF-8) and a few long words."""
    rng = np.random.default_rng(seed)
    docs = tsyn.zipf_corpus(num_docs=num_docs, vocab_size=200, tokens_per_doc=40, seed=seed)
    junk = np.frombuffer(b"ABZ09-'.\t\n\xc3\xa9 ", np.uint8)
    out = []
    for d in docs:
        raw = np.frombuffer(d, np.uint8).copy()
        pos = rng.integers(0, len(raw), len(raw) // 15)
        raw[pos] = rng.choice(junk, len(pos))
        out.append(raw.tobytes())
    out.append(b"x" + b"longword" * int(rng.integers(2, 5)) + b" tail")
    return out


def _run_both(buf, ends, ids, **kw):
    """``index_bytes_device`` of the JAX package and of the port on the
    same bytes; returns both outputs as numpy."""
    import jax

    j = JDT.index_bytes_device(jax.device_put(buf.copy()), jax.device_put(ends.copy()),
                               jax.device_put(ids.copy()), **kw)
    t = TDT.index_bytes_device(torch.from_numpy(buf.copy()), torch.from_numpy(ends.copy()),
                               torch.from_numpy(ids.copy()), **kw)
    return j, t


def _assert_index_equal(j, t):
    np.testing.assert_array_equal(t["counts"].numpy(), np.asarray(j["counts"]))
    for k in ("df", "postings"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    assert len(t["unique_groups"]) == len(j["unique_groups"])
    for (th, tl), (jh, jl) in zip(t["unique_groups"], j["unique_groups"]):
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# -- index_bytes_device against the JAX program ----------------------------


@pytest.mark.parametrize("branch", ["one_key", "two_key"])
@pytest.mark.parametrize("sort_cols", ["none", "exact"])
@pytest.mark.parametrize("width", [40, 48, 64])
@pytest.mark.parametrize("seed", [1, 2])
def test_index_bytes_device_matches_jax(seed, width, sort_cols, branch, monkeypatch):
    if branch == "two_key":  # the JAX (flag, position) two-key compaction
        monkeypatch.setattr(JDT, "_ONE_KEY_COMPACTION_LIMIT", 0)
    docs = _seeded_docs(seed)
    buf, ends = _pad_concat(docs)
    ids = np.arange(1, len(docs) + 1, dtype=np.int32)
    count, max_len = TDT.host_token_stats(buf, ends)
    kw = dict(width=width, tok_cap=count + 64, num_docs=len(docs),
              sort_cols=None if sort_cols == "none" else -(-max_len // 4))
    j, t = _run_both(buf, ends, ids, **kw)
    _assert_index_equal(j, t)
    assert int(t["counts"][3]) == count and int(t["counts"][2]) == max_len


@pytest.mark.parametrize("docs", EDGE_DOCS)
def test_index_bytes_device_edge_corpora_match_jax(docs):
    buf, ends = _pad_concat(docs)
    ids = np.arange(1, len(docs) + 1, dtype=np.int32) * 3  # ids need not be 1..n
    j, t = _run_both(buf, ends, ids, width=48, tok_cap=256, num_docs=len(docs))
    _assert_index_equal(j, t)


def test_one_byte_docs_fill_tok_cap():
    """One-byte docs: doc boundaries split tokens, so there is one token
    per byte — tok_cap sized by the host count is exactly enough."""
    docs = [b"a"] * 64
    buf, ends = _pad_concat(docs, multiple=64)
    count, _ = TDT.host_token_stats(buf, ends)
    assert count == 64
    ids = np.arange(1, 65, dtype=np.int32)
    j, t = _run_both(buf, ends, ids, width=8, tok_cap=count + 1, num_docs=64)
    _assert_index_equal(j, t)
    assert t["counts"].tolist()[:2] == [1, 64]


def test_buffer_ending_in_a_letter_matches_jax():
    docs = EDGE_DOCS[0][:-1] + [b"pack my box with five dozen liquor jugz"]
    buf, ends = _pad_concat(docs)
    buf = buf[: int(ends[-1])]  # no trailing pad: the last byte is a letter
    ids = np.arange(1, len(docs) + 1, dtype=np.int32)
    j, t = _run_both(buf, ends, ids, width=48, tok_cap=256, num_docs=len(docs))
    _assert_index_equal(j, t)


def test_all_spaces_and_numbers_only_give_no_words():
    for docs in ([b"   \t\n  "], [b"123 456", b"--- !!!"]):
        buf, ends = _pad_concat(docs)
        ids = np.arange(1, len(docs) + 1, dtype=np.int32)
        j, t = _run_both(buf, ends, ids, width=16, tok_cap=64, num_docs=len(docs))
        _assert_index_equal(j, t)
        assert t["counts"].tolist()[:3] == [0, 0, 0]


# -- the frontends ---------------------------------------------------------


@pytest.mark.parametrize("width", [40, 48, 64])
@pytest.mark.parametrize("docs", EDGE_DOCS[:3])
def test_tokenize_groups_is_pack_groups_of_tokenize_rows(docs, width):
    buf, ends = _pad_concat(docs)
    ids = np.arange(1, len(docs) + 1, dtype=np.int32)
    args = (torch.from_numpy(buf), torch.from_numpy(ends), torch.from_numpy(ids))
    kw = dict(width=width, tok_cap=256, num_docs=len(docs))
    sort_cols = -(-TDT.host_token_stats(buf, ends)[1] // 4)
    cols, doc_r, len_r, cnt_r = TDT.tokenize_rows(*args, **kw)
    nsort = TDT.clamp_sort_cols(sort_cols, len(cols))
    ref = TDT.pack_groups(cols, nsort)
    groups, doc_g, len_g, cnt_g = TDT.tokenize_groups(*args, **kw, sort_cols=sort_cols)
    assert len(groups) == TDT.num_groups_for(width)
    assert (int(len_r), int(cnt_r)) == (int(len_g), int(cnt_g))
    assert torch.equal(doc_r, doc_g)
    zero = torch.zeros(256, dtype=torch.int32)
    for g, (hi, lo) in enumerate(groups):
        eh, el = ref[g] if g < len(ref) else (zero, zero)
        assert torch.equal(hi, eh) and torch.equal(lo, el)


@pytest.mark.parametrize("docs", EDGE_DOCS[:3])
def test_tokenize_rows_matches_jax(docs):
    import jax

    buf, ends = _pad_concat(docs)
    ids = np.arange(1, len(docs) + 1, dtype=np.int32)
    kw = dict(width=48, tok_cap=256, num_docs=len(docs))
    jcols, jdoc, jlen, jcnt = jax.jit(lambda *a: JDT.tokenize_rows(*a, **kw))(
        jax.device_put(buf.copy()), jax.device_put(ends.copy()), jax.device_put(ids.copy()))
    tcols, tdoc, tlen, tcnt = TDT.tokenize_rows(
        torch.from_numpy(buf), torch.from_numpy(ends), torch.from_numpy(ids), **kw)
    assert (int(tlen), int(tcnt)) == (int(jlen), int(jcnt))
    np.testing.assert_array_equal(tdoc.numpy(), np.asarray(jdoc))
    for a, b in zip(tcols, jcols):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unpack_groups_inverts_pack_groups():
    docs = EDGE_DOCS[1]
    buf, ends = _pad_concat(docs)
    ids = np.arange(1, len(docs) + 1, dtype=np.int32)
    cols, _, _, _ = TDT.tokenize_rows(torch.from_numpy(buf), torch.from_numpy(ends),
                                      torch.from_numpy(ids), width=64, tok_cap=64,
                                      num_docs=len(docs))
    valid = cols[0] != TDT.INT32_MAX
    back = TDT.unpack_groups(TDT.pack_groups(cols, len(cols)), len(cols))
    for a, b in zip(cols, back):
        assert torch.equal(a[valid], b[valid])


def test_decode_word_groups_roundtrip():
    words = [b"cat", b"aardvark", b"z" * 12, b"q" * 16, b"m" * 37]
    width = 40
    rows = np.zeros((len(words), width), np.uint8)
    for i, w in enumerate(words):
        rows[i, : len(w)] = np.frombuffer(w, np.uint8)
    r32 = rows.reshape(len(words), width // 4, 4).astype(np.int64)
    cols = [torch.from_numpy(((r32[:, c, 0] << 24) | (r32[:, c, 1] << 16)
                              | (r32[:, c, 2] << 8) | r32[:, c, 3]).astype(np.int32))
            for c in range(width // 4)]
    groups = TDT.pack_groups(cols, width // 4)
    decoded = TDT.decode_word_groups([(h.numpy(), l.numpy()) for h, l in groups], width)
    assert [w.rstrip(b"\x00") for w in decoded.tolist()] == words
    jdecoded = JDT.decode_word_groups([(h.numpy(), l.numpy()) for h, l in groups], width)
    assert decoded.tolist() == jdecoded.tolist()


# -- fetch packing ---------------------------------------------------------


@pytest.mark.parametrize("k,narrow", [(1, True), (3, True), (1, False), (3, False)])
def test_fetch_pack_matches_jax_and_round_trips(k, narrow):
    docs = [b"short words here on every line",
            b"supercalifragilisticexpialidocious floccinaucinihilipilification",
            b"medium sized tokens xyz pneumonoultramicroscopicsilicovolcanoconiosis"]
    buf, ends = _pad_concat(docs)
    ids = np.arange(1, len(docs) + 1, dtype=np.int32)
    width, tok_cap = 48, 256
    sort_cols = -(-TDT.host_token_stats(buf, ends)[1] // 4)
    j, t = _run_both(buf, ends, ids, width=width, tok_cap=tok_cap, num_docs=len(docs),
                     sort_cols=sort_cols)
    num_words, num_pairs, _, _, num_long = t["counts"].tolist()
    assert num_long == 3  # the three >12-char words above
    live = TDT.live_groups_for(sort_cols, width)
    kw = dict(nu=tok_cap, npairs=tok_cap, nlong=64, k=k, live=live, narrow=narrow)
    tp = TDT.fetch_pack(t, **kw)
    jp = JDT.fetch_pack(j, **kw)
    assert set(tp) == set(jp) == {"df", "post", "g0", "long_idx", "tail"}
    for name in ("df", "post", "long_idx"):
        got, want = tp[name].numpy(), np.asarray(jp[name])
        if narrow and want.dtype == np.uint16:
            assert got.dtype == np.int16  # uint16 bits on the card
            got = got.view(np.uint16)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    for a, b in zip(tp["g0"] + sum(tp["tail"], ()), jp["g0"] + sum(jp["tail"], ())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    post = tp["post"].numpy()
    post = post.view(np.uint16) if post.dtype == np.int16 else post
    np.testing.assert_array_equal(TDT.unpack_postings(post, num_pairs, k),
                                  t["postings"][:num_pairs].numpy())
    idx = tp["long_idx"].numpy()[:num_long]
    rebuilt = TDT.rebuild_tail_groups(num_words, live, idx=idx,
                                      tails=[(h.numpy(), l.numpy()) for h, l in tp["tail"]],
                                      num_long=num_long)
    for g, (h, l) in enumerate(rebuilt, start=1):
        np.testing.assert_array_equal(h, t["unique_groups"][g][0][:num_words].numpy())
        np.testing.assert_array_equal(l, t["unique_groups"][g][1][:num_words].numpy())


@pytest.mark.parametrize("npairs", [1, 2, 3, 7, 4096])
def test_pack_postings_boundary_values(npairs):
    import jax.numpy as jnp

    rng = np.random.default_rng(npairs)
    post = rng.integers(0, 1024, npairs).astype(np.int32)
    post[0] = 1023  # the 10-bit field's largest value
    packed = TDT.pack_postings(torch.from_numpy(post), 3).numpy()
    assert packed.shape[0] == -(-npairs // 3)
    np.testing.assert_array_equal(packed, np.asarray(JDT.pack_postings(jnp.asarray(post), 3)))
    np.testing.assert_array_equal(TDT.unpack_postings(packed, npairs, 3), post)
    np.testing.assert_array_equal(TDT.unpack_postings(post, npairs, 1), post)
    for max_doc in (1, 1023, 1024, 70_000):
        assert TDT.doc_pack_width(max_doc) == JDT.doc_pack_width(max_doc)


# -- host token statistics -------------------------------------------------


def _stats_cases():
    b = np.frombuffer(b"abXcd ef", np.uint8).copy()
    cases = [(b, [4, 8]), (b, [8]), (b, [2, 2, 8]), (b, [3]),
             (np.frombuffer(b"  42!  ", np.uint8).copy(), [7]),
             (np.frombuffer(b"z", np.uint8).copy(), [1]),
             (np.frombuffer(b"a" * 200 + b" " + b"b" * 70, np.uint8).copy(), [271])]
    pad = np.full(64, 0x20, np.uint8)
    pad[:11] = np.frombuffer(b"hello world", np.uint8)
    cases.append((pad, [5, 11, 64, 64]))
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"ab XY.9\t\n-z", np.uint8)
    for _ in range(25):
        n = int(rng.integers(1, 400))
        buf = rng.choice(alphabet, n).astype(np.uint8)
        cases.append((buf, np.sort(rng.integers(0, n + 1, int(rng.integers(1, 6))))))
    return [(buf, np.asarray(ends, np.int64)) for buf, ends in cases]


def test_native_token_stats_match_the_numpy_mirror_and_jax():
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain")
    for buf, ends in _stats_cases():
        got = tnative.token_stats(buf, ends)
        assert got == TDT._host_token_stats_numpy(buf, ends), (bytes(buf), ends)
        assert got == jnative.token_stats(buf.copy(), ends.copy())
        assert got == TDT.host_token_stats(buf, ends)
    b = np.frombuffer(b"abXcd ef", np.uint8).copy()
    assert tnative.token_stats(b, np.array([9, 3, 11], np.int64)) is None
    assert tnative.token_stats(b, np.array([-1, 8], np.int64)) is None


def test_host_token_stats_without_the_library_use_the_mirror(monkeypatch):
    monkeypatch.setattr(tnative, "token_stats", lambda buf, ends: None)
    for buf, ends in _stats_cases()[:8]:
        assert TDT.host_token_stats(buf, ends) == JDT._host_token_stats_numpy(buf, ends)


# -- whole builds ----------------------------------------------------------


def _port_cfg(**kw):
    kw.setdefault("pad_multiple", 64)
    return tpkg.IndexConfig(device="cpu", device_tokenize=True, **kw)


def _jax_cfg(**kw):
    kw.setdefault("pad_multiple", 64)
    return JaxConfig(backend="tpu", device_tokenize=True, device_shards=1, **kw)


def _manifest(tmp_path, docs, name="corpus"):
    paths = tsyn.write_corpus(tmp_path / name, docs)
    list_path = tmp_path / f"{name}.txt"
    tman.write_manifest(list_path, paths)
    return list_path


def _build_both(list_path, tmp_path, **kw):
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(**kw),
                          output_dir=str(tmp_path / "torch"))
    sj = jpkg.build_index(jpkg.read_manifest(list_path), _jax_cfg(**kw),
                          output_dir=str(tmp_path / "jax"))
    assert read_letter_files(tmp_path / "torch") == read_letter_files(tmp_path / "jax")
    return st, sj


def _oracle_bytes(list_path, tmp_path):
    tpkg.oracle_index(tpkg.read_manifest(list_path), tmp_path / "oracle")
    return read_letter_files(tmp_path / "oracle")


@pytest.mark.parametrize("seed", [2, 9])
def test_device_tokenize_build_matches_jax_and_oracle(seed, tmp_path):
    list_path = _manifest(tmp_path, tsyn.zipf_corpus(num_docs=37, vocab_size=800,
                                                     tokens_per_doc=60, seed=seed))
    st, sj = _build_both(list_path, tmp_path)
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)
    assert set(st["phases_ms"]) == set(sj["phases_ms"]) == DEVICE_PHASES
    for key in DEVICE_COUNTERS:
        assert st[key] == sj[key], key


def test_device_tokenize_build_matches_the_smoke_golden(smoke_fixture, tmp_path, monkeypatch):
    monkeypatch.chdir(smoke_fixture)
    stats = tpkg.build_index(tpkg.read_manifest("manifest.txt"), _port_cfg(),
                             output_dir=str(tmp_path))
    assert "host_views" in stats["phases_ms"] and "device_tokenize_fallback" not in stats
    assert read_letter_files(tmp_path) == read_letter_files(smoke_fixture / "golden")


@pytest.mark.parametrize("case", ["edge", "long_words", "one_byte_docs", "over_1023_docs",
                                  "zero_length_docs"])
def test_device_tokenize_build_edge_corpora_match_jax(case, tmp_path):
    docs = {
        "edge": [b"don't foo-bar x1y2z3 I.Loomings cafe\xcc\x81 42 --- UPPER",
                 b"a  b\tc\nd\ve\ff\rg", b"", b"ab ab\x00 ab"],
        # 13-44 letters: tail groups, num_long > 0, the sparse tail fetch
        "long_words": [b" ".join(b"w" * n + bytes([97 + n % 26]) * 2 for n in range(11, 43)),
                       b"short " + b"k" * 44, b"mid " + b"k" * 44 + b" tail"],
        "one_byte_docs": [b"a"] * 64,
        # more than 1023 docs: postings travel as 16 bits, not 3 per int32
        "over_1023_docs": [bytes([97 + i % 26]) * (1 + i % 3) for i in range(1100)],
        "zero_length_docs": [b"abc", b"", b"", b"de", b"", b"abc de"],
    }[case]
    list_path = _manifest(tmp_path, docs)
    st, sj = _build_both(list_path, tmp_path)
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)
    for key in DEVICE_COUNTERS:
        assert st[key] == sj[key], key


def test_device_tokenize_wide_doc_ids_match_jax(tmp_path):
    """70,000 manifest entries: doc ids pass 2^16, so postings and df
    travel as untouched int32."""
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_bytes(b"alpha beta")
    b.write_bytes(b"gamma alpha")
    list_path = tmp_path / "list.txt"
    tman.write_manifest(list_path, [str(a), str(b)] * 35_000)
    st, sj = _build_both(list_path, tmp_path)
    assert st["unique_pairs"] == sj["unique_pairs"] == 140_000
    assert st["fetched_bytes"] == sj["fetched_bytes"]


@pytest.mark.parametrize("docs", [[b""], [b"  \t \r\n "], [b"123 456", b"--- !!!"]])
def test_device_tokenize_build_of_an_empty_corpus(docs, tmp_path):
    list_path = _manifest(tmp_path, docs)
    st, sj = _build_both(list_path, tmp_path)
    files = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert files == [f"{chr(97 + i)}.txt" for i in range(26)]
    assert read_letter_files(tmp_path / "torch") == b""
    assert set(st["phases_ms"]) == set(sj["phases_ms"])


@pytest.mark.parametrize("width,docs", [
    (16, [b"short words here", b"a" * 30 + b" tail", b"end doc"]),
    (48, [b"x" * 400 + b" normal words"]),  # past the reference's 299-letter cap
])
def test_width_overflow_restarts_on_the_host_plan_like_jax(width, docs, tmp_path):
    list_path = _manifest(tmp_path, docs)
    st, sj = _build_both(list_path, tmp_path, device_tokenize_width=width)
    assert read_letter_files(tmp_path / "torch") == _oracle_bytes(list_path, tmp_path)
    assert st["device_tokenize_fallback"] == sj["device_tokenize_fallback"]
    assert "aborted_device_tokenize" in st["phases_ms"]
    assert set(st["phases_ms"]) == set(sj["phases_ms"])
    assert "tokenize_feed" in st["phases_ms"]  # the pipelined plan, as in JAX
    for key in ("num_mappers", "num_reducers", "host_threads", "window_plan_bytes",
                "window_imbalance", "upload_windows", "documents", "tokens",
                "unique_terms", "unique_pairs", "lines_written"):
        assert st[key] == sj[key], key


def test_width_overflow_restart_records_a_skip_once(tmp_path):
    paths = tsyn.write_corpus(tmp_path / "docs", [b"alpha beta", b"g" * 20, b"delta"])
    list_path = tmp_path / "list.txt"
    tman.write_manifest(list_path, [paths[0], str(tmp_path / "gone.txt"), *paths[1:]])
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(device_tokenize_width=8),
                          output_dir=str(tmp_path / "out"))
    assert "device_tokenize_fallback" in st
    assert st["degradation"]["skipped_docs"] == [2]
    assert (tmp_path / "out" / "g.txt").read_bytes() == b"g" * 20 + b":[3]\n"


def test_device_tokenize_skips_an_unreadable_file_with_exit_3(tmp_path, capsys):
    paths = tsyn.write_corpus(tmp_path / "docs", [b"alpha beta", b"beta gamma"])
    list_path = tmp_path / "list.txt"
    tman.write_manifest(list_path, [paths[0], str(tmp_path / "gone.txt"), paths[1]])
    rc = tcli.main(["1", "1", str(list_path), "--device", "cpu", "--device-tokenize",
                    "--stats", "--output-dir", str(tmp_path / "out")])
    assert rc == 3
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["degradation"]["skipped_docs"] == [2]
    assert "host_views" in stats["phases_ms"]
    assert (tmp_path / "out" / "b.txt").read_bytes() == b"beta:[1 3]\n"


@pytest.mark.parametrize("flags", [["--device-tokenize"],
                                   ["--device-tokenize", "--device-tokenize-width", "8"]])
def test_cli_device_tokenize_matches_the_jax_cli(flags, tmp_path, capsys):
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli

    docs = tsyn.zipf_corpus(num_docs=13, vocab_size=300, tokens_per_doc=70, seed=5)
    list_path = _manifest(tmp_path, docs + [b"antidisestablishmentarianism"])
    assert tcli.main(["4", "26", str(list_path), "--device", "cpu", "--stats", *flags,
                      "--output-dir", str(tmp_path / "torch")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(["4", "26", str(list_path), "--device-shards", "1", *flags,
                      "--output-dir", str(tmp_path / "jax")]) == 0
    assert read_letter_files(tmp_path / "torch") == read_letter_files(tmp_path / "jax")
    assert ("device_tokenize_fallback" in stats) == ("8" in flags)


@pytest.mark.parametrize("kw,match", [
    ({"device_tokenize": True, "backend": "oracle"}, "backend"),
    ({"device_tokenize": True, "pipeline_chunk_docs": 3}, "host-scan"),
    ({"device_tokenize": True, "collect_skew_stats": True}, "skew"),
    # a stream checkpoint needs stream_chunk_docs beside device_tokenize
    ({"device_tokenize": True, "stream_checkpoint": "s.npz"}, "streaming all-device"),
    ({"device_tokenize_width": 30}, "device_tokenize_width"),
    ({"device_tokenize_width": 300}, "device_tokenize_width"),
    ({"device_tokenize_width": 0}, "device_tokenize_width"),
    ({"stream_checkpoint": "s.npz"}, "streaming all-device"),
    ({"device_tokenize": True, "stream_chunk_docs": 10, "stream_checkpoint_every": 0},
     "stream_checkpoint_every"),
    ({"device_tokenize": True, "resume": "maybe"}, "resume must be"),
    ({"device_tokenize": True, "overlap_tail_fraction": 0.0}, "overlap_tail_fraction"),
    ({"device_tokenize": True, "overlap_tail_fraction": 1.0}, "overlap_tail_fraction"),
    ({"device_tokenize": True, "overlap_tail_fraction": 0.5}, "host-scan"),
])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tpkg.IndexConfig(**kw)


def test_cli_rejects_a_bad_width_with_exit_2(tmp_path, capsys):
    list_path = _manifest(tmp_path, [b"alpha"])
    assert tcli.main(["1", "1", str(list_path), "--device", "cpu", "--device-tokenize",
                      "--device-tokenize-width", "30"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and "device_tokenize_width" in err
