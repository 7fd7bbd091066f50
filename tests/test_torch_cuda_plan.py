"""The build plans' device side on the card: the pinned uploads, the
provisional-key sort and the one-shot prededuped sort, the streaming
accumulator, the all-device program and its fetch packing, and the
device stream engine (its snapshots, and a feed loop that never waits
for the card) against the same programs on the CPU; and whole builds of
every plan on the card, the overlap plan and a crash-resumed stream
included, against the golden and the CPU build.  Every test needs a CUDA device
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
    device_streaming as tds,
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


# -- the streaming all-device plan -------------------------------------------


def _stream_windows(n=5):
    """Seeded byte windows for the device stream engine, one of them
    whitespace only; the long-word doc of each window makes later
    windows widen the live groups."""
    out = []
    for w in range(n):
        if w == 2:
            out.append((np.full(4096, 0x20, np.uint8), np.array([4096], np.int32),
                        np.array([999], np.int32)))
            continue
        buf, ends, ids = _byte_window(30 + w, num_docs=60, long_words=w >= 3)
        out.append((buf, ends, ids + 100 * w))
    return out


def _feed(eng, windows, **kw):
    for buf, ends, ids in windows:
        count, max_len = tdt.host_token_stats(buf, ends)
        # fresh arrays per engine: the CPU engine shares their memory
        eng.feed(buf.copy(), ends.copy(), ids.copy(), tok_count=count, max_len=max_len, **kw)
    return eng


def _finalized(eng) -> dict:
    out = eng.finalize()
    flat = {k: out[k].cpu().numpy() for k in ("counts", "df", "postings")}
    for g, (hi, lo) in enumerate(out["unique_groups"]):
        flat[f"g{g}"] = np.stack([hi.cpu().numpy(), lo.cpu().numpy()])
    return flat


@pytest.mark.parametrize("initial_capacity", [4096, 1 << 16])
def test_cuda_device_stream_engine_matches_cpu(initial_capacity):
    _need_cuda()
    engines = [_feed(tds.DeviceStreamEngine(width=48, device=device, window_pad=4096,
                                            initial_capacity=initial_capacity),
                     _stream_windows())
               for device in ("cuda", "cpu")]
    outs = [_finalized(e) for e in engines]
    assert engines[0].windows_fed == engines[1].windows_fed == 4
    assert engines[0].capacity == engines[1].capacity
    assert engines[0].rows_curve == engines[1].rows_curve
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def test_cuda_device_stream_snapshot_and_restore():
    _need_cuda()
    windows = _stream_windows()
    live = _feed(tds.DeviceStreamEngine(width=48, device="cuda", window_pad=4096), windows[:3])
    cpu = _feed(tds.DeviceStreamEngine(width=48, device="cpu", window_pad=4096), windows[:3])
    nbytes = live.snapshot_nbytes
    assert nbytes == cpu.snapshot_nbytes
    snap, want = live.snapshot(), cpu.snapshot()
    assert snap["fetched_nbytes"] == nbytes
    for k in ("count", "cap", "live_groups", "max_word_len", "windows_fed", "rows_curve"):
        assert snap[k] == want[k], k
    for a, b in zip(snap["columns"], want["columns"], strict=True):
        np.testing.assert_array_equal(a, b)
    # a fresh card engine restored from the snapshot finishes the stream
    # exactly like the live one
    rest = tds.DeviceStreamEngine(width=48, device="cuda", window_pad=4096)
    rest.restore(snap)
    outs = [_finalized(_feed(e, windows[3:])) for e in (rest, live)]
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def test_cuda_device_stream_feed_never_waits_for_the_card():
    """The stream loop queues every window's program and merge without a
    synchronizing call: each count comes back through a pinned copy and
    an event, read two merges late."""
    _need_cuda()
    windows = _stream_windows(7)
    eng = tds.DeviceStreamEngine(width=48, device="cuda", window_pad=4096, initial_capacity=4096)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _feed(eng, windows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eng.windows_fed == 6 and eng.capacity > 4096
    assert len(eng.rows_curve) == 4
    _finalized(eng)


@pytest.mark.parametrize("chunk_docs", [7, 40])
def test_cuda_device_stream_build_matches_the_cpu_build(chunk_docs, tmp_path):
    _need_cuda()
    docs = tsyn.zipf_corpus(num_docs=80, vocab_size=20_000, tokens_per_doc=400, seed=23)
    docs.append(b" ".join(b"w" * n + b"x" for n in range(12, 44)))
    paths = tsyn.write_corpus(tmp_path / "docs", docs)
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tpkg.read_manifest(tmp_path / "list.txt")
    stats = {}
    for device in ("cuda", "cpu"):
        stats[device] = tpkg.build_index(
            m, tpkg.IndexConfig(device=device, device_tokenize=True,
                                stream_chunk_docs=chunk_docs),
            output_dir=str(tmp_path / device))
    assert tfmt.letters_md5(tmp_path / "cuda") == tfmt.letters_md5(tmp_path / "cpu")
    assert "device_tokenize_fallback" not in stats["cuda"]
    for key in ("stream_windows", "accumulator_capacity", "unique_rows_curve", "sort_cols",
                "unique_terms", "unique_pairs", "fetched_bytes"):
        assert stats["cuda"].get(key) == stats["cpu"].get(key), key


def test_cuda_device_stream_build_resumes_after_a_crash(tmp_path, monkeypatch):
    _need_cuda()
    monkeypatch.chdir(SMOKE)
    m = tpkg.read_manifest("manifest.txt")
    ckpt = tmp_path / "stream.ckpt.npz"
    cfg = tpkg.IndexConfig(device_tokenize=True, stream_chunk_docs=1,
                           stream_checkpoint=str(ckpt), stream_checkpoint_every=2)
    monkeypatch.setenv("MRI_TPU_STREAM_CRASH_AFTER_WINDOWS", "3")
    with pytest.raises(RuntimeError, match="injected stream crash"):
        tpkg.build_index(m, cfg, output_dir=str(tmp_path / "out"))
    assert ckpt.exists()
    monkeypatch.delenv("MRI_TPU_STREAM_CRASH_AFTER_WINDOWS")
    stats = tpkg.build_index(m, cfg, output_dir=str(tmp_path / "out"))
    assert stats["resumed_from_window"] == 2 and not ckpt.exists()
    assert tfmt.letters_md5(tmp_path / "out") == tfmt.letters_md5(SMOKE / "golden")


# -- the overlap plan ----------------------------------------------------------


@pytest.mark.parametrize("tail,windows", [(0.3, 2), (0.6, 1)])
def test_cuda_overlap_build_matches_the_cpu_build(tail, windows, tmp_path):
    _need_cuda()
    paths = tsyn.write_corpus(tmp_path / "docs", tsyn.zipf_corpus(
        num_docs=200, vocab_size=80_000, tokens_per_doc=800, seed=17))
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tpkg.read_manifest(tmp_path / "list.txt")
    stats = {}
    for device in ("cuda", "cpu"):
        stats[device] = tpkg.build_index(
            m, tpkg.IndexConfig(device=device, overlap_tail_fraction=tail,
                                overlap_device_windows=windows),
            output_dir=str(tmp_path / device))
    assert tfmt.letters_md5(tmp_path / "cuda") == tfmt.letters_md5(tmp_path / "cpu")
    assert stats["cuda"]["upload_windows"] == windows
    for key in ("device_pairs", "unique_pairs", "window_plan_bytes"):
        assert stats["cuda"][key] == stats["cpu"][key], key


def test_cuda_overlap_build_matches_the_smoke_golden(tmp_path, monkeypatch):
    _need_cuda()
    monkeypatch.chdir(SMOKE)
    tpkg.build_index(tpkg.read_manifest("manifest.txt"),
                     tpkg.IndexConfig(overlap_tail_fraction=0.4), output_dir=str(tmp_path))
    assert tfmt.letters_md5(tmp_path) == tfmt.letters_md5(SMOKE / "golden")
