"""Whole multi-shard builds through ``build_index`` and the CLI on the
CPU: the six mesh rows of tests/test_engine_matrix.py ``ENGINES`` (mesh
host-scan, mesh streaming, mesh device-scan, letter emit, mesh device
letter-emit, mesh device-stream) and the one-shot ``dist_index`` plan,
at N = 2 and 4, against the JAX package's build at the same N: letter
files byte-equal, merged ``index.mri`` byte-equal, and the ``--stats``
keys ``device_shards``, ``dist_fetched_bytes``, ``dist_valid_pairs``,
``emit_ownership`` and ``letter_owners`` equal.  The mesh device-stream
row is held against ``oracle_index`` and the port's single-device build
instead (the JAX streaming build's window ring is flaky on its CPU
backend).  Then ``device_shards=None`` on the CPU, and the refusals."""

import json

import pytest

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import native as jnative
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native as tnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)

from conftest import read_letter_files

pytestmark = pytest.mark.skipif(
    not (tnative.available() and jnative.available()), reason="no C++ toolchain")

DIST_KEYS = ("device_shards", "dist_fetched_bytes", "dist_valid_pairs", "emit_ownership",
             "letter_owners", "exchange_retries", "exchange_capacity", "merge_retries",
             "accumulator_capacity_per_owner", "accumulator_mode", "stream_windows",
             "unique_terms", "unique_pairs", "lines_written")

# the mesh rows of ENGINES (tests/test_engine_matrix.py:33-43), and the
# one-shot dist_index plan; "artifact" marks the merged-emit rows
ROWS = {
    "mesh_host_scan": dict(artifact=True),
    "mesh_streaming": dict(stream_chunk_docs=7, artifact=True),
    "mesh_device_scan": dict(device_tokenize=True, artifact=True),
    "letter_emit": dict(emit_ownership="letter"),
    "mesh_device_letter_emit": dict(device_tokenize=True, emit_ownership="letter"),
    "mesh_one_shot": dict(pipeline_chunk_docs=0, artifact=True),
    "mesh_one_shot_skew": dict(pipeline_chunk_docs=0, collect_skew_stats=True),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_corpus")
    docs = tsyn.zipf_corpus(num_docs=31, vocab_size=700, tokens_per_doc=70, seed=17)
    docs.append(b"Supercalifragilisticexpialidocious antidisestablishmentarianism x")
    tman.write_manifest(root / "list.txt", tsyn.write_corpus(root / "docs", docs))
    tpkg.oracle_index(tpkg.read_manifest(root / "list.txt"), root / "oracle")
    return root / "list.txt", read_letter_files(root / "oracle")


def _port(list_path, out, **kw):
    kw.setdefault("pad_multiple", 64)
    return tpkg.build_index(tpkg.read_manifest(list_path), tpkg.IndexConfig(device="cpu", **kw),
                            output_dir=str(out))


def _jax(list_path, out, **kw):
    kw.setdefault("pad_multiple", 64)
    return jpkg.build_index(jpkg.read_manifest(list_path), jpkg.IndexConfig(backend="tpu", **kw),
                            output_dir=str(out))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("row", sorted(ROWS))
def test_mesh_row_matches_jax(row, n, corpus, tmp_path):
    list_path, golden = corpus
    kw = dict(ROWS[row], device_shards=n)
    st = _port(list_path, tmp_path / "torch", **kw)
    sj = _jax(list_path, tmp_path / "jax", **kw)
    assert read_letter_files(tmp_path / "torch") == read_letter_files(tmp_path / "jax") == golden
    assert {k: st.get(k) for k in DIST_KEYS} == {k: sj.get(k) for k in DIST_KEYS}
    assert st["device_shards"] == n
    if kw.get("artifact"):
        assert ((tmp_path / "torch" / "index.mri").read_bytes()
                == (tmp_path / "jax" / "index.mri").read_bytes())
    if kw.get("emit_ownership") == "letter":
        assert st["letter_owners"] == n and st["emit_ownership"] == "letter"
    elif kw.get("pipeline_chunk_docs") == 0:  # the one-shot dist_index plan
        assert st["engine"] == "dist" and "tokenize_feed" not in st["phases_ms"]
    else:
        assert "dist_fetched_bytes" in st


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_device_stream_row_matches_oracle_and_single_device(n, corpus, tmp_path):
    list_path, golden = corpus
    kw = dict(device_tokenize=True, stream_chunk_docs=6, artifact=True)
    st = _port(list_path, tmp_path / "mesh", device_shards=n, **kw)
    s1 = _port(list_path, tmp_path / "one", device_shards=1, **kw)
    assert read_letter_files(tmp_path / "mesh") == read_letter_files(tmp_path / "one") == golden
    assert ((tmp_path / "mesh" / "index.mri").read_bytes()
            == (tmp_path / "one" / "index.mri").read_bytes())
    assert st["device_shards"] == n and s1["device_shards"] == 1
    assert st["stream_windows"] == s1["stream_windows"] == 6
    assert (st["unique_terms"], st["unique_pairs"]) == (s1["unique_terms"], s1["unique_pairs"])
    assert st["dist_fetched_bytes"] > 0 and "accumulator_capacity_per_owner" in st


def test_auto_shards_on_the_cpu_is_the_single_device_build(corpus, tmp_path):
    list_path, golden = corpus
    for kw in (dict(), dict(device_tokenize=True), dict(stream_chunk_docs=7)):
        st = _port(list_path, tmp_path / "auto", **kw)
        s1 = _port(list_path, tmp_path / "one", device_shards=1, **kw)
        assert read_letter_files(tmp_path / "auto") == read_letter_files(tmp_path / "one") == golden
        assert st.get("device_shards") == s1.get("device_shards")
        assert "dist_fetched_bytes" not in st and sorted(st["phases_ms"]) == sorted(s1["phases_ms"])


def test_cli_mesh_build(corpus, tmp_path, capsys):
    list_path, golden = corpus
    for extra in ([], ["--emit-ownership", "letter"], ["--device-tokenize"]):
        out = tmp_path / "_".join(extra or ["merged"])
        rc = tcli.main(["4", "26", str(list_path), "--device", "cpu", "--device-shards", "4",
                        "--pad-multiple", "64", "--stats", "--output-dir", str(out), *extra])
        assert rc == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["device_shards"] == 4 and stats["dist_fetched_bytes"] > 0
        assert read_letter_files(out) == golden


@pytest.mark.parametrize("kw, match", [
    (dict(device_shards=1, emit_ownership="letter"), "multi-shard mesh"),
    (dict(device_shards=1, emit_ownership="letter", device_tokenize=True), "multi-shard mesh"),
    (dict(device_shards=2, emit_ownership="letter", collect_skew_stats=True), "pipelined path"),
    (dict(device_shards=2, overlap_tail_fraction=0.4), "single-device plan"),
])
def test_mesh_refusals_match_jax(kw, match, corpus, tmp_path):
    list_path, _ = corpus
    with pytest.raises(ValueError, match=match):
        _port(list_path, tmp_path / "torch", **kw)
    with pytest.raises(ValueError):
        _jax(list_path, tmp_path / "jax", **kw)


def test_letter_emit_refuses_the_key_overflow_restart(corpus, tmp_path, monkeypatch):
    list_path, _ = corpus

    def overflow(self, contents, doc_ids):
        raise tnative.KeyOverflow()

    monkeypatch.setattr(tnative.NativeKeyStream, "feed", overflow)
    with pytest.raises(ValueError, match="cannot fall back"):
        _port(list_path, tmp_path / "letter", device_shards=2, emit_ownership="letter")
    # the merged mesh build restarts on the one-shot dist_index plan
    st = _port(list_path, tmp_path / "merged", device_shards=2)
    assert st["pipelined_fallback"] == "key_overflow" and st["engine"] == "dist"
    assert read_letter_files(tmp_path / "merged") == corpus[1]


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("letter_range", [(0, 6), (18, 26), (0, 0), (0, 26)])
def test_letter_range_emit_matches_jax(backend, letter_range, tmp_path):
    """The per-owner emit writes only its letters' files, byte-equal to
    the JAX formatter with the same range, by either writer."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.text import (
        formatter as jfmt,
    )
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
        formatter as tfmt,
    )
    import numpy as np

    vocab = np.array(sorted({b"apple", b"axe", b"kiwi", b"melon", b"tomato", b"zebra", b"zoo"}))
    letters = np.array([w[0] - ord("a") for w in vocab], np.int64)
    df = np.array([2, 1, 1, 3, 2, 1, 2], np.int64)
    order = np.lexsort((np.arange(len(vocab)), -df, letters))
    offsets = np.cumsum(df) - df
    postings = np.array([1, 4, 2, 3, 1, 2, 5, 2, 3, 7, 1, 6], np.int32)
    kw = dict(vocab=vocab, letter_of_term=letters, order=order, df=df, offsets=offsets,
              postings=postings, max_doc_id=7, letter_range=letter_range)
    st = tfmt.emit_index(tmp_path / "t", backend=backend, **kw)
    sj = jfmt.emit_index(tmp_path / "j", backend=backend, **kw)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == [f"{chr(97 + i)}.txt" for i in range(*letter_range)]
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert st["lines_written"] == sj["lines_written"]
