"""The port's out-of-core build (``build/spill.py``, ``build/ooc.py``,
``MRI_BUILD_SPILL_BYTES``) against the JAX package's.

Arming the spill budget may change where the postings live while the
build runs, never a byte of what it emits: letter files and
``index.mri`` equal the in-memory route's, the oracle's and JAX's at
every (mappers, reducers, shards, budget) point.  The spill file format
is the JAX one, so a run file written by either package reads back in
the other.  A torn run degrades to quarantine and recorded skips; a
dead shard merger to a main-thread takeover; a SIGKILLed spill build
leaves only a stale scratch directory that the rerun sweeps."""

import logging
import os
import signal
import sys
import zlib

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import native as jnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.build import (
    ooc as jooc,
    spill as jspill,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import faults, native
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.build import (
    ooc,
    spill as spill_mod,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus.scheduler import (
    term_shard_balance,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text.tokenizer import (
    clean_token,
)

from conftest import REPO_ROOT, read_letter_files, run_child
from test_torch_cpu_backend import _disarm, build_both, corpus_pair  # noqa: F401

pytestmark = pytest.mark.spill

TINY = 4096       # forces several run flushes on the corpus
HUGE = 1 << 30    # never trips: the zero-spill fast path


def _env(budget=None, shards=None):
    env = {"MRI_CPU_WINDOW_BYTES": "512"}
    if budget is not None:
        env["MRI_BUILD_SPILL_BYTES"] = str(budget)
    if shards is not None:
        env["MRI_BUILD_SHARDS"] = str(shards)
    return env


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    root = tmp_path_factory.mktemp("spill")
    tm, jm, lst = corpus_pair(root)
    tpkg.oracle_index(tm, str(root / "oracle"))
    return tm, jm, lst, read_letter_files(root / "oracle")


def _no_spill_dirs(out):
    return not list(out.glob(".spill-*"))


# -- the spill container ----------------------------------------------------


def _sections():
    return {
        "vocab": np.arange(12, dtype=np.uint8).reshape(3, 4),
        "df": np.array([2, 1, 3], dtype=np.int64),
        "postings": np.array([1, 4, 2, 1, 3, 9], dtype=np.int32),
    }


@pytest.mark.parametrize("writer,reader", [(spill_mod, jspill), (jspill, spill_mod),
                                           (spill_mod, spill_mod)])
def test_container_reads_across_packages(writer, reader, tmp_path):
    path = tmp_path / "t.bin"
    sections = _sections()
    nbytes = writer.write_file(path, {"kind": "test", "n": 3}, sections)
    assert path.stat().st_size == nbytes
    with reader.SpillFile(path) as sf:
        assert sf.meta == {"kind": "test", "n": 3}
        for name, arr in sections.items():
            np.testing.assert_array_equal(sf.section(name), arr)
            want = f"{zlib.adler32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF:08x}"
            assert sf.sections[name]["adler32"] == want
        np.testing.assert_array_equal(sf.read_rows("vocab", 1, 3), sections["vocab"][1:3])
        np.testing.assert_array_equal(sf.read_rows("postings", 2, 5), sections["postings"][2:5])
    reader.verify_file(path)
    other = tmp_path / "u.bin"
    reader.write_file(other, {"kind": "test", "n": 3}, sections)
    assert other.read_bytes() == path.read_bytes()


def test_verify_catches_a_single_bit_flip(tmp_path):
    path = tmp_path / "t.bin"
    spill_mod.write_file(path, {"kind": "test"}, _sections())
    with spill_mod.SpillFile(path) as sf:
        at = sf.sections["postings"]["offset"]
    data = bytearray(path.read_bytes())
    data[at] ^= 0x40
    path.write_bytes(data)
    with pytest.raises(spill_mod.SpillError, match="postings"):
        spill_mod.verify_file(path)
    moved = spill_mod.quarantine(path)
    assert moved.name == "t.bin.corrupt" and moved.exists() and not path.exists()


def test_rejects_bad_magic_and_version(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(b"NOTSPILL" + b"\0" * 8)
    with pytest.raises(spill_mod.SpillError, match="magic"):
        spill_mod.SpillFile(path)
    spill_mod.write_file(path, {"kind": "test"}, _sections())
    data = bytearray(path.read_bytes())
    data[8] = 99  # version field
    path.write_bytes(data)
    with pytest.raises(spill_mod.SpillError, match="version"):
        spill_mod.SpillFile(path)


def test_clean_stale_dirs_sweeps_only_foreign_pids(tmp_path):
    stale = tmp_path / ".spill-424242"
    stale.mkdir()
    (stale / "run-w000-0000.bin").write_bytes(b"torn")
    own = spill_mod.spill_dir(tmp_path)
    own.mkdir()
    (own / "live.bin").write_bytes(b"live")
    assert spill_mod.clean_stale_dirs(tmp_path) == 1
    assert not stale.exists() and (own / "live.bin").exists()
    spill_mod.remove_dir(own)
    assert not own.exists()


def _runpack(mod, tm, shards=8):
    contents, ids = tman.load_documents(tm)
    with mod.HostIndexStream() as s:
        s.feed(contents, ids)
        return s.runpack(shards)


@pytest.mark.parametrize("writer,reader", [(spill_mod, jspill), (jspill, spill_mod)])
def test_run_file_written_by_one_package_reads_in_the_other(writer, reader, golden, tmp_path):
    """A worker's run file (``write_run`` over a native ``runpack``) is
    byte-equal across the packages and merges alike in either."""
    tm = golden[0]
    pack = _runpack(native, tm)
    jpack = _runpack(jnative, tm)
    for key in pack:
        np.testing.assert_array_equal(np.asarray(pack[key]), np.asarray(jpack[key]))
    windows = [(1, 0, len(tm))]
    for d in ("w", "r"):
        (tmp_path / d).mkdir()
    path, _ = writer.write_run(tmp_path / "w", 0, 0, pack, windows)
    again, _ = reader.write_run(tmp_path / "r", 0, 0, pack, windows)
    assert path.read_bytes() == again.read_bytes()
    reader.verify_file(path)
    width = pack["width"]
    merged = {}
    for name, (mod_ooc, mod_spill) in (("port", (ooc, spill_mod)), ("jax", (jooc, jspill))):
        with mod_spill.SpillFile(path) as f:
            merged[name] = [mod_ooc.merge_shard([f], s, width) for s in range(8)]
    for a, b in zip(merged["port"], merged["jax"]):
        for key in ("vocab", "df", "offsets", "postings", "tf"):
            np.testing.assert_array_equal(a[key], b[key])


# -- the ooc merge algebra --------------------------------------------------


def test_gather_pairs_letter_offsets_emit_order_equal_jax():
    src_off = np.array([0, 2, 3, 6], dtype=np.int64)
    order = np.array([2, 0, 1])
    idx, new_off = ooc.gather_pairs(order, src_off)
    assert new_off.tolist() == [0, 3, 5, 6] and idx.tolist() == [3, 4, 5, 0, 1, 2]
    for x, y in zip((idx, new_off), jooc.gather_pairs(order, src_off)):
        np.testing.assert_array_equal(x, y)
    terms = np.array([b"ab", b"ax", b"bz", b"da"], dtype="S2")
    off = ooc.letter_offsets(ooc.terms_to_u8(terms))
    np.testing.assert_array_equal(off, jooc.letter_offsets(jooc.terms_to_u8(terms)))
    assert (off[0], off[1], off[2], off[3], off[4], off[26]) == (0, 2, 3, 3, 4, 4)
    assert ooc.emit_order(np.array([3, 1, 3])).tolist() == [0, 2, 1]


def _write_run(path, terms, df, postings, tf):
    u8 = ooc.terms_to_u8(np.array(terms, dtype="S2"))
    spill_mod.write_file(path, {"kind": "run", "shard_term_off": [0, len(terms)],
                                "shard_pair_off": [0, len(postings)]},
                         {"vocab": u8, "df": np.array(df, dtype=np.int64),
                          "postings": np.array(postings, dtype=np.int32),
                          "tf": np.array(tf, dtype=np.int32)})
    return spill_mod.SpillFile(path)


@pytest.mark.native_san
def test_merge_shard_kway_disjoint_runs(tmp_path):
    r1 = _write_run(tmp_path / "r1.bin", [b"ab", b"cd"], [2, 1], [1, 3, 2], [1, 1, 4])
    r2 = _write_run(tmp_path / "r2.bin", [b"ab", b"bb"], [1, 1], [2, 5], [7, 1])
    try:
        merged = ooc.merge_shard([r1, r2], 0, 2)
        want = jooc.merge_shard([r1, r2], 0, 2)
    finally:
        r1.close()
        r2.close()
    assert ooc.as_terms(merged["vocab"], 2).tolist() == [b"ab", b"bb", b"cd"]
    assert merged["df"].tolist() == [3, 1, 1]
    assert merged["postings"].tolist() == [1, 2, 3, 5, 2]
    assert merged["tf"].tolist() == [1, 7, 1, 1, 4]
    assert merged["offsets"].tolist() == [0, 3, 4, 5]
    for key in merged:
        np.testing.assert_array_equal(merged[key], want[key])


@pytest.mark.native_san
def test_merge_shard_duplicate_pair_raises(tmp_path):
    r1 = _write_run(tmp_path / "r1.bin", [b"ab"], [1], [7], [1])
    r2 = _write_run(tmp_path / "r2.bin", [b"ab"], [1], [7], [2])
    try:
        with pytest.raises(ValueError, match="duplicate"):
            ooc.merge_shard([r1, r2], 0, 2)
    finally:
        r1.close()
        r2.close()


# -- byte identity --------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 8, 64])
@pytest.mark.parametrize("budget", [TINY, HUGE])
def test_spill_matrix_byte_identical(shards, budget, golden, tmp_path):
    tm, jm, _, want = golden
    ts, js = build_both(tm, jm, tmp_path, env=_env(budget, shards), num_mappers=3,
                        num_reducers=4, audit=True)
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax") == want
    sp = ts["spill"]
    assert sorted(sp) == sorted(js["spill"])
    if budget == TINY:
        assert sp["runs"] > 0 and sp["flushes"] >= sp["runs"]
        assert ts["build_shards"]["shards"] == shards
        assert sum(ts["build_shards"]["postings_per_shard"]) == ts["unique_pairs"]
        assert ts["build_shards"] == js["build_shards"]
    else:
        assert sp["runs"] == js["spill"]["runs"] == 0
    assert _no_spill_dirs(tmp_path / "port")


@pytest.mark.native_san
@pytest.mark.parametrize("mappers,reducers,shards", [(3, 4, 1), (3, 4, 8), (2, 64, 64)])
def test_port_spill_builds_match_the_oracle(mappers, reducers, shards, golden, tmp_path,
                                            monkeypatch):
    """The port's spill route alone: several run flushes a worker, the
    k-way shard merge, audited."""
    tm, _, _, want = golden
    for k, v in _env(TINY, shards).items():
        monkeypatch.setenv(k, v)
    ts = tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", num_mappers=mappers,
                                               num_reducers=reducers, audit=True),
                          output_dir=str(tmp_path / "port"))
    assert read_letter_files(tmp_path / "port") == want
    assert ts["spill"]["runs"] > 0 and ts["reduce_workers"] == reducers
    assert _no_spill_dirs(tmp_path / "port")


@pytest.mark.parametrize("mappers,reducers", [(1, 1), (2, 5), (4, 3), (2, 64)])
def test_spill_km_grid_byte_identical(mappers, reducers, golden, tmp_path):
    """Every (K, M) point, past 26 reducers too: the term-hash reduce has
    no 26-partition cap, so all M reducers do real work."""
    tm, jm, _, want = golden
    ts, _ = build_both(tm, jm, tmp_path, env=_env(TINY, 64 if reducers > 26 else 8),
                       num_mappers=mappers, num_reducers=reducers)
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax") == want
    assert ts["reduce_workers"] == reducers
    assert _no_spill_dirs(tmp_path / "port")


@pytest.mark.parametrize("fmt", ["1", "2", "3"])
def test_spill_artifact_equals_memory_and_jax(fmt, golden, tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SERVE_FORMAT", fmt)
    tm, jm, _, _ = golden
    build_both(tm, jm, tmp_path / "disk", env=_env(TINY, 8), num_mappers=3,
               num_reducers=4, artifact=True, audit=True)
    tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", num_mappers=3, num_reducers=4,
                                          artifact=True),
                     output_dir=str(tmp_path / "mem"))
    disk = (tmp_path / "disk" / "port" / "index.mri").read_bytes()
    assert disk == (tmp_path / "disk" / "jax" / "index.mri").read_bytes()
    assert disk == (tmp_path / "mem" / "index.mri").read_bytes()
    assert read_letter_files(tmp_path / "disk" / "port") == read_letter_files(tmp_path / "mem")


def test_spill_budget_bounds_worker_memory(tmp_path):
    budget = 16 << 10
    tm, jm, _ = corpus_pair(tmp_path, num_docs=200, seed=3)
    assert tm.total_bytes >= 4 * budget
    ts, _ = build_both(tm, jm, tmp_path, env=_env(budget, 8), num_mappers=3, num_reducers=4)
    sp = ts["spill"]
    assert sp["runs"] > 0
    assert 0 < sp["peak_worker_est_bytes"] <= budget
    assert sp["bytes_spilled"] > budget
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax")


def test_hash_shards_beat_letter_split_on_zipf(tmp_path):
    docs = tsyn.zipf_corpus(num_docs=64, vocab_size=800, tokens_per_doc=80, seed=7)
    tm, jm, _ = corpus_pair(tmp_path, docs)
    ts, _ = build_both(tm, jm, tmp_path, env=_env(TINY, 8), num_mappers=3, num_reducers=4)
    letter_pairs = [0] * 26
    for blob in docs:
        for word in {clean_token(r) for r in blob.split()} - {""}:
            letter_pairs[ord(word[0]) - ord("a")] += 1
    balance = ts["build_shards"]
    assert sum(letter_pairs) == sum(balance["postings_per_shard"])
    assert balance["max_over_mean"] < term_shard_balance(letter_pairs)["max_over_mean"]


# -- degradation ------------------------------------------------------------


def _armed(spec, tm, out, **cfg):
    faults.install(spec)
    faults.begin_run()
    env = _env(TINY, 8)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", num_mappers=2,
                                                     num_reducers=3, **cfg),
                                output_dir=str(out))
    finally:
        faults.install(None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.native_san
def test_spill_corrupt_quarantines_and_reports(golden, tmp_path):
    tm = golden[0]
    r = _armed("spill-corrupt:spill=1", tm, tmp_path / "out")
    assert r["spill"]["runs_quarantined"] == 1
    assert r["degradation"]["skipped_docs"]  # the loss is reported
    assert all((tmp_path / "out" / f"{chr(97 + i)}.txt").exists() for i in range(26))
    assert _no_spill_dirs(tmp_path / "out")


@pytest.mark.native_san
def test_merge_crash_takeover_byte_identical(golden, tmp_path):
    tm, _, _, want = golden
    r = _armed("merge-crash", tm, tmp_path / "out")
    assert r["degradation"]["reducer_takeovers"] >= 1
    assert not r["degradation"]["skipped_docs"]
    assert read_letter_files(tmp_path / "out") == want
    assert _no_spill_dirs(tmp_path / "out")


def test_sigkill_after_spill_write_rerun_byte_identical(golden, tmp_path, monkeypatch):
    """A real kill right after the second run file lands leaves only a
    stale ``.spill-<pid>`` directory; the rerun sweeps it and emits the
    oracle's bytes."""
    tm, _, lst, want = golden
    out = tmp_path / "out"
    argv = ["2", "2", lst, "--output-dir", str(out), "--backend", "cpu",
            "--io-prefetch", "2", "--resume", "auto"]
    env = {**os.environ, **_env(TINY), "MRI_SPILL_KILL_AFTER": "2",
           "PYTHONPATH": str(REPO_ROOT)}
    proc = run_child([sys.executable, "-m",
                      "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch", *argv],
                     cwd=str(REPO_ROOT), env=env, timeout=120)
    assert proc.returncode == -signal.SIGKILL
    assert list(out.glob(".spill-*"))          # the crash left its scratch
    assert not (out / "a.txt").exists()         # died before any emit
    for k, v in _env(TINY).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MRI_SPILL_KILL_AFTER", raising=False)
    assert main(argv) == 0
    assert read_letter_files(out) == want
    assert _no_spill_dirs(out)


def test_reducers_over_26_in_memory_path_warns_as_jax(golden, tmp_path, caplog):
    tm, jm, _, want = golden
    with caplog.at_level(logging.WARNING):
        ts, _ = build_both(tm, jm, tmp_path, env=_env(), num_mappers=2, num_reducers=30)
    assert ts["reduce_workers"] == 30
    warned = [r for r in caplog.records if "exceeds the 26 letter partitions" in r.message]
    assert {r.name for r in warned} == {"mri_torch.model", "mri_tpu.model"}
    assert read_letter_files(tmp_path / "port") == want
