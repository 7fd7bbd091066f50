"""The default build's device side on the card: the pinned uploads, the
provisional-key sort and the one-shot prededuped sort against the same
programs on the CPU, and whole builds on the card against the golden
and the CPU build.  Every test needs a CUDA device and skips without
one; none needs JAX, so on the card
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
    engine as te,
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
