"""The multi-shard builds on the card: N logical shards on one card (or
round-robin on several), each mesh plan at 4 shards against the
single-device build on the card and the oracle, the exchange programs
against the same programs on the CPU mesh, and the overflow retry.
Every test needs a CUDA device and skips without one; none needs JAX, so
on the card ``python -m pytest --noconftest tests/test_torch_cuda_mesh.py
-m cuda`` runs them."""

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
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
    dist_device_tokenizer as tddt,
    dist_engine as tdist,
    mesh as M,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
    formatter as tfmt,
)

INT32_MAX = 2**31 - 1

pytestmark = pytest.mark.cuda

MESH_LEGS = {
    "pipelined": dict(artifact=True),
    "letter": dict(emit_ownership="letter"),
    "one_shot_skew": dict(pipeline_chunk_docs=0, collect_skew_stats=True),
    "streaming": dict(stream_chunk_docs=9),
    "device_tokenize": dict(device_tokenize=True, artifact=True),
    "device_letter": dict(device_tokenize=True, emit_ownership="letter"),
    "device_stream": dict(device_tokenize=True, stream_chunk_docs=7),
}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cuda_mesh")
    docs = tsyn.zipf_corpus(num_docs=40, vocab_size=3000, tokens_per_doc=200, seed=23)
    docs.append(b"Pneumonoultramicroscopicsilicovolcanoconiosis floccinaucinihilipilification")
    tman.write_manifest(root / "list.txt", tsyn.write_corpus(root / "docs", docs))
    m = tpkg.read_manifest(root / "list.txt")
    tpkg.oracle_index(m, root / "oracle")
    return m, tfmt.letters_md5(root / "oracle")


@pytest.mark.parametrize("leg", sorted(MESH_LEGS))
def test_mesh_leg_on_the_card_matches_the_single_device_build(leg, corpus, tmp_path):
    _need_cuda()
    m, oracle_md5 = corpus
    kw = dict(MESH_LEGS[leg], pad_multiple=1024)
    st = tpkg.build_index(m, tpkg.IndexConfig(device_shards=4, **kw), output_dir=str(tmp_path / "m"))
    one_kw = dict(kw, emit_ownership="merged")
    tpkg.build_index(m, tpkg.IndexConfig(device_shards=1, **one_kw),
                     output_dir=str(tmp_path / "one"))
    assert st["device_shards"] == 4
    assert tfmt.letters_md5(tmp_path / "m") == tfmt.letters_md5(tmp_path / "one") == oracle_md5
    if kw.get("artifact"):
        assert ((tmp_path / "m" / "index.mri").read_bytes()
                == (tmp_path / "one" / "index.mri").read_bytes())


@pytest.mark.parametrize("factor", [2.0, 0.25])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dist_sort_prov_windows_on_the_card_matches_the_cpu_mesh(n, factor):
    _need_cuda()
    rng = np.random.default_rng(n)
    stride = 1002
    keys = np.unique(rng.integers(0, 5000 * stride, 200_000)).astype(np.int32)
    keys = keys[keys % stride > 0]
    rng.shuffle(keys)
    halves = np.array_split(keys, 2)
    host = []
    for h in halves:
        buf = np.full(-(-h.size // (1024 * n)) * 1024 * n, INT32_MAX, np.int32)
        buf[: h.size] = h
        host.append(buf)
    df = np.bincount(keys // stride, minlength=5000).astype(np.int64)
    offsets = np.cumsum(df) - df
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = M.make_mesh(n, dev)
        stats = {}
        out[dev] = (tdist.dist_sort_prov_windows(
            [M.shard(w, mesh) for w in host], stride=stride, mesh=mesh, offsets_prov=offsets,
            num_pairs=keys.size, capacity_factor=factor, stats=stats), stats)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1]
    one = te.sort_prov_chunks([torch.from_numpy(w).cuda() for w in host], stride=stride,
                              out_size=keys.size)
    np.testing.assert_array_equal(out["cuda"][0], te.host_u16(one.cpu().numpy()))


def test_mix32_on_the_card_matches_the_cpu():
    _need_cuda()
    rng = np.random.default_rng(1)
    cols = [torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 16, dtype=np.int64)
                             .astype(np.int32)) for _ in range(5)]
    got = tddt._mix32([c.cuda() for c in cols]).cpu()
    assert torch.equal(got, tddt._mix32(cols))


def test_mesh_cuda_placement():
    _need_cuda()
    mesh = M.make_mesh(4, "cuda")
    cards = torch.cuda.device_count()
    assert [d.index for d in mesh.devices] == [i % cards for i in range(4)]
    parts = M.shard(np.arange(4096, dtype=np.int32), mesh)
    assert all(p.device == d for p, d in zip(parts, mesh.devices))
    recv = M.all_to_all([p.reshape(4, -1) for p in parts], mesh)
    want = np.concatenate([np.arange(s * 1024 + 256, s * 1024 + 512) for s in range(4)])
    np.testing.assert_array_equal(recv[1].cpu().numpy(), want)
