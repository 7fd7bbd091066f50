"""The build plans' device side on the card: the pinned uploads, the
provisional-key sort and the one-shot prededuped sort, the streaming
accumulator, and the all-device program and its fetch packing against
the same programs on the CPU; and whole builds of every plan on the card
against the golden and the CPU build.  Every test needs a CUDA device
and skips without one; none needs JAX, so on the card
``python -m pytest --noconftest tests/test_torch_cuda_plan.py -m cuda``
runs them."""

from pathlib import Path

import numpy as np
import pytest
import torch

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    device_tokenizer as tdt,
    engine as te,
    kernels as tk,
    streaming as tstream,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
    formatter as tfmt,
)

INT32_MAX = 2**31 - 1
SMOKE = Path(__file__).resolve().parent / "fixtures" / "smoke"

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _windows(seed, sizes, modes, vocab, max_doc, granule=1 << 14):
    """Distinct (prov, doc) pairs as uint16 ``[terms | docs]`` buffers
    or padded int32 keys, one per window."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(vocab * max_doc, size=sum(sizes), replace=False)
    terms, docs = idx // max_doc, idx % max_doc + 1
    out, start = [], 0
    for size, mode in zip(sizes, modes):
        t, d = terms[start:start + size], docs[start:start + size]
        start += size
        padded = -(-size // granule) * granule
        if mode == "u16":
            out.append(te.pack_u16_feed(t, d, padded).view(np.int16))
        else:
            buf = np.full(padded, INT32_MAX, np.int32)
            buf[:size] = t * (max_doc + 2) + d
            out.append(buf)
    return out, start


@pytest.mark.parametrize("modes", [("u16",), ("keys", "keys"), ("u16", "keys", "u16")])
def test_cuda_sort_prov_chunks_matches_cpu(modes):
    _need_cuda()
    vocab, max_doc = 60_000, 20_000
    bufs, n_valid = _windows(len(modes), [400_000 + 7 * i for i in range(len(modes))],
                             modes, vocab if "keys" in modes else 3000, max_doc)
    out_size = -(-n_valid // (1 << 14)) * (1 << 14)
    keep: list = []
    dev = [te.upload(b, torch.device("cuda"), keep) for b in bufs]
    assert len(keep) == len(bufs) and all(k.is_pinned() for k in keep)
    got = te.PendingFetch(te.sort_prov_chunks(dev, stride=max_doc + 2, out_size=out_size))
    want = te.sort_prov_chunks([torch.from_numpy(b) for b in bufs], stride=max_doc + 2,
                               out_size=out_size)
    np.testing.assert_array_equal(got.wait()[:n_valid], want.numpy()[:n_valid])


@pytest.mark.parametrize("out_size", [None, 1 << 14])
def test_cuda_index_prededuped_u16_matches_cpu(out_size):
    _need_cuda()
    bufs, _ = _windows(5, [300_000], ["u16"], 30_000, 355, granule=1 << 16)
    got = te.index_prededuped_u16(torch.from_numpy(bufs[0]).cuda(), max_doc_id=355,
                                  out_size=out_size)
    want = te.index_prededuped_u16(torch.from_numpy(bufs[0]), max_doc_id=355,
                                   out_size=out_size)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(te.PendingFetch(got).wait(), want.numpy())


@pytest.mark.parametrize("kw", [{}, {"pipeline_chunk_docs": 1}, {"pipeline_chunk_docs": 0},
                                {"use_native": False}, {"collect_skew_stats": True}])
def test_cuda_build_matches_the_smoke_golden(kw, tmp_path, monkeypatch):
    _need_cuda()
    monkeypatch.chdir(SMOKE)
    tpkg.build_index(tpkg.read_manifest("manifest.txt"), tpkg.IndexConfig(**kw),
                     output_dir=str(tmp_path))
    assert tfmt.letters_md5(tmp_path) == tfmt.letters_md5(SMOKE / "golden")


@pytest.mark.parametrize("chunk_docs", [None, 3, 0])
def test_cuda_build_matches_the_cpu_build(chunk_docs, tmp_path):
    _need_cuda()
    paths = tsyn.write_corpus(tmp_path / "docs", tsyn.zipf_corpus(
        num_docs=200, vocab_size=80_000, tokens_per_doc=800, seed=13))
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tpkg.read_manifest(tmp_path / "list.txt")
    stats = {}
    for device in ("cuda", "cpu"):
        stats[device] = tpkg.build_index(
            m, tpkg.IndexConfig(device=device, pipeline_chunk_docs=chunk_docs),
            output_dir=str(tmp_path / device))
    assert tfmt.letters_md5(tmp_path / "cuda") == tfmt.letters_md5(tmp_path / "cpu")
    assert stats["cuda"]["unique_pairs"] == stats["cpu"]["unique_pairs"]
    if chunk_docs != 0:
        assert stats["cuda"]["window_modes"] == stats["cpu"]["window_modes"]


# -- the streaming plan ------------------------------------------------------


@pytest.mark.parametrize("switch_after", [None, 0, 2])
def test_cuda_streaming_engine_matches_cpu(switch_after):
    _need_cuda()
    rng = np.random.default_rng(7)
    feeds, vocab = [], 10_000
    for w in range(4):
        if w == switch_after:
            vocab = 30_000  # stride 100,002: stops packing past ~21,000 terms
        feeds.append((rng.integers(0, vocab, 30_000).astype(np.int32),
                      rng.integers(1, 50, 30_000).astype(np.int32), vocab))
    remap = np.random.default_rng(1).permutation(vocab).astype(np.int32)
    letters = np.sort(np.random.default_rng(2).integers(0, 26, vocab)).astype(np.int32)
    outs = []
    for device in ("cuda", "cpu"):
        eng = tstream.StreamingIndexEngine(max_doc_id=100_000, device=device,
                                           window_pad=1024, initial_capacity=2048)
        for terms, docs, v in feeds:
            eng.feed(terms, docs, v)
        outs.append((eng.mode, eng.capacity,
                     {k: v.cpu().numpy() for k, v in eng.finalize(remap, letters, vocab).items()}))
    assert outs[0][:2] == outs[1][:2]
    assert outs[0][0] == ("packed" if switch_after is None else "pairs")
    for k in outs[1][2]:
        np.testing.assert_array_equal(outs[0][2][k], outs[1][2][k], err_msg=k)


@pytest.mark.parametrize("chunk_docs", [1, 5, 100])
def test_cuda_streaming_build_matches_the_cpu_build(chunk_docs, tmp_path):
    _need_cuda()
    paths = tsyn.write_corpus(tmp_path / "docs", tsyn.zipf_corpus(
        num_docs=30, vocab_size=4000, tokens_per_doc=300, seed=3))
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tpkg.read_manifest(tmp_path / "list.txt")
    tk.reset_launch_counts()
    st = tpkg.build_index(m, tpkg.IndexConfig(stream_chunk_docs=chunk_docs),
                          output_dir=str(tmp_path / "cuda"))
    assert tk.unique_mask_count.launches == 1  # the packed finalize's dedup
    sc = tpkg.build_index(m, tpkg.IndexConfig(device="cpu", stream_chunk_docs=chunk_docs),
                          output_dir=str(tmp_path / "cpu"))
    assert tfmt.letters_md5(tmp_path / "cuda") == tfmt.letters_md5(tmp_path / "cpu")
    for key in ("stream_windows", "accumulator_capacity", "accumulator_mode", "unique_pairs"):
        assert st[key] == sc[key], key
    assert st["stream_windows"] == -(-30 // chunk_docs)


def test_cuda_streaming_build_matches_the_smoke_golden(tmp_path, monkeypatch):
    _need_cuda()
    monkeypatch.chdir(SMOKE)
    tpkg.build_index(tpkg.read_manifest("manifest.txt"), tpkg.IndexConfig(stream_chunk_docs=2),
                     output_dir=str(tmp_path))
    assert tfmt.letters_md5(tmp_path) == tfmt.letters_md5(SMOKE / "golden")


# -- the all-device plan -----------------------------------------------------


def _byte_window(seed, num_docs=300, long_words=True):
    """A seeded byte window with junk bytes, empty docs and long words."""
    docs = tsyn.zipf_corpus(num_docs=num_docs, vocab_size=3000, tokens_per_doc=200, seed=seed)
    rng = np.random.default_rng(seed)
    junk = np.frombuffer(b"ABZ09-'.\t\n\xc3\xa9 ", np.uint8)
    out = []
    for i, d in enumerate(docs):
        raw = np.frombuffer(d, np.uint8).copy()
        pos = rng.integers(0, len(raw), len(raw) // 20)
        raw[pos] = rng.choice(junk, len(pos))
        out.append(b"" if i % 37 == 5 else raw.tobytes())
    if long_words:
        out.append(b" ".join(b"q" * n + b"z" for n in range(12, 44)))
    total = sum(len(d) for d in out)
    buf = np.full(-(-total // 4096) * 4096, 0x20, np.uint8)
    buf[:total] = np.frombuffer(b"".join(out), np.uint8)
    ends = np.cumsum([len(d) for d in out]).astype(np.int32)
    return buf, ends, np.arange(1, len(out) + 1, dtype=np.int32)


@pytest.mark.parametrize("width,exact", [(40, False), (48, False), (48, True), (64, True)])
def test_cuda_index_bytes_device_matches_cpu(width, exact):
    _need_cuda()
    buf, ends, ids = _byte_window(4)
    count, max_len = tdt.host_token_stats(buf, ends)
    kw = dict(width=width, tok_cap=-(-(count + 1) // 4096) * 4096, num_docs=len(ids),
              sort_cols=-(-max_len // 4) if exact else None)
    host = [torch.from_numpy(a) for a in (buf, ends, ids)]
    got = tdt.index_bytes_device(*(t.cuda() for t in host), **kw)
    want = tdt.index_bytes_device(*host, **kw)
    assert got["counts"].cpu().tolist() == want["counts"].tolist()
    assert want["counts"].tolist()[2:4] == [max_len, count]
    for k in ("df", "postings"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for (gh, gl), (wh, wl) in zip(got["unique_groups"], want["unique_groups"]):
        assert torch.equal(gh.cpu(), wh) and torch.equal(gl.cpu(), wl)


@pytest.mark.parametrize("k,narrow", [(1, True), (3, True), (1, False)])
def test_cuda_fetch_pack_matches_cpu(k, narrow):
    _need_cuda()
    buf, ends, ids = _byte_window(5, num_docs=200)
    count, max_len = tdt.host_token_stats(buf, ends)
    tok_cap = -(-(count + 1) // 4096) * 4096
    kw = dict(width=48, tok_cap=tok_cap, num_docs=len(ids), sort_cols=-(-max_len // 4))
    host = [torch.from_numpy(a) for a in (buf, ends, ids)]
    outs = [tdt.index_bytes_device(*(t.cuda() for t in host), **kw),
            tdt.index_bytes_device(*host, **kw)]
    num_long = int(outs[1]["counts"][4])
    assert num_long > 0
    pk = dict(nu=tok_cap, npairs=tok_cap, nlong=-(-num_long // 1024) * 1024, k=k,
              live=tdt.live_groups_for(kw["sort_cols"], 48), narrow=narrow)
    got, want = (tdt.fetch_pack(o, **pk) for o in outs)
    assert set(got) == set(want) == {"df", "post", "g0", "long_idx", "tail"}

    def flat(v):
        return [v] if isinstance(v, torch.Tensor) else [t for x in v for t in flat(x)]

    for name in want:
        for a, b in zip(flat(got[name]), flat(want[name]), strict=True):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("kw", [{}, {"device_tokenize_width": 16}])
def test_cuda_device_tokenize_build_matches_the_smoke_golden(kw, tmp_path, monkeypatch):
    _need_cuda()
    monkeypatch.chdir(SMOKE)
    tpkg.build_index(tpkg.read_manifest("manifest.txt"),
                     tpkg.IndexConfig(device_tokenize=True, **kw), output_dir=str(tmp_path))
    assert tfmt.letters_md5(tmp_path) == tfmt.letters_md5(SMOKE / "golden")


@pytest.mark.parametrize("width,fallback", [(48, False), (64, False), (8, True)])
def test_cuda_device_tokenize_build_matches_the_cpu_build(width, fallback, tmp_path):
    _need_cuda()
    docs = tsyn.zipf_corpus(num_docs=120, vocab_size=20_000, tokens_per_doc=400, seed=21)
    docs.append(b" ".join(b"w" * n + b"x" for n in range(12, 44)))
    paths = tsyn.write_corpus(tmp_path / "docs", docs)
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tpkg.read_manifest(tmp_path / "list.txt")
    stats = {}
    for device in ("cuda", "cpu"):
        stats[device] = tpkg.build_index(
            m, tpkg.IndexConfig(device=device, device_tokenize=True,
                                device_tokenize_width=width),
            output_dir=str(tmp_path / device))
    assert tfmt.letters_md5(tmp_path / "cuda") == tfmt.letters_md5(tmp_path / "cpu")
    assert ("device_tokenize_fallback" in stats["cuda"]) == fallback
    for key in ("unique_terms", "unique_pairs", "sort_cols", "fetched_bytes"):
        assert stats["cuda"].get(key) == stats["cpu"].get(key), key
