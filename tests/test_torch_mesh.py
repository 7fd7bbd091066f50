"""The port's shard mesh (``parallel/mesh.py``, ``parallel/distributed.py``)
and the multi-shard config fields: the collectives against a numpy model
of ``lax.all_to_all(..., tiled=True)``, ``psum`` and ``pmax``; the shard
split and placement; ``runtime_info``'s keys against the JAX package's;
and every ``device_shards`` / ``emit_ownership`` config the JAX package
refuses, refused by the port too (the one deliberate difference,
``stream_checkpoint`` with ``device_shards=None``, has its own test)."""

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.parallel import (
    distributed as jdistributed,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
    inverted_index as tmodel,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
    distributed as tdistributed,
    mesh as M,
)

from conftest import read_letter_files

SIZES = [1, 2, 4, 8]


def _tiled_all_to_all(sends: list[np.ndarray]) -> list[np.ndarray]:
    """numpy model of ``lax.all_to_all(x, axis, 0, 0, tiled=True)`` over
    per-device ``(n, m)`` blocks: device d's result is row d of every
    source, stacked in source order."""
    n = len(sends)
    return [np.concatenate([sends[s][d] for s in range(n)]) for d in range(n)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("width", [1, 5])
def test_all_to_all_matches_the_tiled_model(n, width):
    rng = np.random.default_rng(100 * n + width)
    sends = [rng.integers(-2**31, 2**31 - 1, size=(n, width), dtype=np.int32) for _ in range(n)]
    mesh = M.make_mesh(n, "cpu")
    got = M.all_to_all([torch.from_numpy(s) for s in sends], mesh)
    want = _tiled_all_to_all(sends)
    assert len(got) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", SIZES)
def test_psum_and_pmax(n):
    rng = np.random.default_rng(n)
    parts = [rng.integers(-1000, 1000, size=7, dtype=np.int32) for _ in range(n)]
    mesh = M.make_mesh(n, "cpu")
    tparts = [torch.from_numpy(p) for p in parts]
    np.testing.assert_array_equal(M.psum(tparts, mesh).numpy(), np.sum(parts, axis=0))
    np.testing.assert_array_equal(M.pmax(tparts, mesh).numpy(), np.max(parts, axis=0))
    scalars = [torch.tensor(int(p[0]), dtype=torch.int32) for p in parts]
    assert int(M.psum(scalars, mesh)) == sum(int(p[0]) for p in parts)
    assert int(M.pmax(scalars, mesh)) == max(int(p[0]) for p in parts)
    np.testing.assert_array_equal(M.gather_host(tparts, mesh), np.stack(parts))


@pytest.mark.parametrize("n", SIZES)
def test_shard_is_the_contiguous_split_in_fresh_memory(n):
    host = np.arange(8 * n * 3, dtype=np.int32)
    mesh = M.make_mesh(n, "cpu")
    parts = M.shard(host, mesh)
    for got, want in zip(parts, np.split(host, n)):
        np.testing.assert_array_equal(got.numpy(), want)
    host[:] = -1  # a later write to the host array reaches no shard
    assert all(int(p.min()) >= 0 for p in parts)
    reps = M.replicate(host, mesh)
    assert len(reps) == n and all(np.array_equal(r.numpy(), host) for r in reps)


def test_shard_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="not divisible"):
        M.shard(np.arange(10, dtype=np.int32), M.make_mesh(4, "cpu"))
    with pytest.raises(ValueError):
        M.make_mesh(0, "cpu")


def test_placement_is_round_robin_over_the_cards(monkeypatch):
    assert M.make_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = M.make_mesh(5, "cuda")
    assert mesh.size == 5 and M.SHARD_AXIS == "shards"
    assert [d.index for d in mesh.devices] == [0, 1, 0, 1, 0]
    assert all(d.type == "cuda" for d in mesh.devices)


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmodel.DeviceUnavailable):
        M.make_mesh(2, "cuda")


def test_runtime_info_has_the_jax_keys():
    got = tdistributed.runtime_info()
    want = jdistributed.runtime_info()
    assert set(got) == set(want)
    assert got["process_index"] == 0 and got["process_count"] == 1
    assert got["platform"] in ("cpu", "gpu")


# -- config parity -------------------------------------------------------

# every multi-shard config the JAX package refuses (backend names mapped:
# the JAX "tpu" engine is the port's "cuda" one)
REFUSED = [
    dict(device_shards=0),
    dict(device_shards=-3),
    dict(emit_ownership="owner"),
    dict(emit_ownership="letter", backend="oracle"),
    dict(emit_ownership="letter", stream_chunk_docs=10),
    dict(emit_ownership="letter", pipeline_chunk_docs=0),
    dict(emit_ownership="letter", overlap_tail_fraction=0.3),
    dict(emit_ownership="letter", artifact=True),
    dict(emit_ownership="letter", device_tokenize=True, stream_chunk_docs=4),
    dict(device_shards=2, device_tokenize=True, stream_chunk_docs=4,
         stream_checkpoint="ck.npz"),
    dict(device_shards=4, stream_checkpoint="ck.npz"),
]


def _jax_kw(kw: dict) -> dict:
    out = dict(kw)
    out["backend"] = {"oracle": "oracle"}.get(kw.get("backend"), "tpu")
    return out


@pytest.mark.parametrize("kw", REFUSED, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        JaxConfig(**_jax_kw(kw))
    with pytest.raises(ValueError):
        tpkg.IndexConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(device_shards=4), dict(device_shards=1), dict(device_shards=3, emit_ownership="letter"),
    dict(device_shards=2, device_tokenize=True, emit_ownership="letter"),
    dict(device_shards=2, device_tokenize=True, stream_chunk_docs=5),
    dict(device_shards=1, device_tokenize=True, stream_chunk_docs=5, stream_checkpoint="c"),
])
def test_config_accepts_what_jax_accepts(kw):
    JaxConfig(**_jax_kw(kw))
    cfg = tpkg.IndexConfig(**kw)
    assert cfg.device_shards == kw["device_shards"]


def test_stream_checkpoint_with_auto_shards_is_refused_only_when_it_resolves_to_a_mesh(
        tmp_path, monkeypatch):
    """JAX refuses ``stream_checkpoint`` unless ``device_shards == 1`` is
    explicit; the port accepts ``None`` (its checkpoint tests and the
    smoke's resume leg pass none) and refuses at run time when ``None``
    resolves to more than one shard."""
    kw = dict(device_tokenize=True, stream_chunk_docs=3, stream_checkpoint=str(tmp_path / "c"))
    with pytest.raises(ValueError, match="device_shards"):
        JaxConfig(backend="tpu", **kw)
    cfg = tpkg.IndexConfig(device="cpu", pad_multiple=64, **kw)
    assert cfg.device_shards is None
    paths = tsyn.write_corpus(tmp_path / "docs", tsyn.zipf_corpus(
        num_docs=7, vocab_size=60, tokens_per_doc=12, seed=5))
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tpkg.read_manifest(tmp_path / "list.txt")
    # on the CPU None resolves to one shard: the checkpointed plan runs
    stats = tpkg.build_index(m, cfg, output_dir=str(tmp_path / "one"))
    assert stats["device_shards"] == 1 and stats["stream_windows"] == 3
    tpkg.oracle_index(m, tmp_path / "oracle")
    assert read_letter_files(tmp_path / "one") == read_letter_files(tmp_path / "oracle")
    # where None resolves to several shards (several cards), it is refused
    monkeypatch.setattr(tmodel.InvertedIndexModel, "_num_shards", lambda self: 2)
    with pytest.raises(ValueError, match="stream_checkpoint is single-device"):
        tpkg.build_index(m, cfg, output_dir=str(tmp_path / "two"))


def test_cli_passes_the_mesh_flags(monkeypatch, tmp_path):
    seen = {}

    def fake_build(manifest, config):
        seen["config"] = config
        return {"degradation": {"skipped_docs": []}}

    monkeypatch.setattr(tcli, "build_index", fake_build)
    tman.write_manifest(tmp_path / "list.txt",
                        tsyn.write_corpus(tmp_path / "docs", [b"alpha beta"]))
    assert tcli.main(["2", "2", str(tmp_path / "list.txt"), "--device", "cpu",
                      "--device-shards", "4", "--emit-ownership", "letter"]) == 0
    assert seen["config"].device_shards == 4
    assert seen["config"].emit_ownership == "letter"
    help_text = tcli.make_parser().format_help()
    assert "--device-shards" in help_text and "--emit-ownership" in help_text
