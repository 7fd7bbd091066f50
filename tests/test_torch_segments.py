"""The port's live index (``segments/``, ``serve/multi_engine.py``)
against the JAX package's, on the same seeded documents.

One twin of each test of ``tests/test_segments.py``, run on the port:
manifests and tombstones, the append/delete/compact lifecycle, the three
segment fault kinds, the engine routing, the CLI and the daemon.  Every
live state is held against two others, exactly (BM25 floats and tie
order included): the port's host ``Engine`` over a from-scratch
``--backend cpu`` build of the live documents (ids mapped by rank) and
the JAX ``MultiSegmentEngine`` over the same directory.  Then the parity
cases, where the JAX package runs the same sequence itself:
one mutation sequence run by each package in its own directory gives
byte-equal manifests, segment artifacts, tombstone files and WAL; each
package serves the other's directory; the CLI's stdout and exit codes
equal the JAX CLI's.
"""

from __future__ import annotations

import json
import random
import socket

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import (
    cli as jcli,
    faults as jfaults,
    segments as jsegments,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.segments import (
    wal as jwal,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve import (
    engine as jengine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
    cli as tcli,
    faults,
    segments,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.audit import (
    verify_output_dir,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus.manifest import (
    write_manifest,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.segments import (
    tombstones as tomb_mod,
    wal as wal_mod,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.artifact import (
    ArtifactError,
    artifact_path,
    bm25_corpus,
    is_segment_managed,
    load_artifact,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.engine import (
    Engine,
    create_engine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.multi_engine import (
    MultiSegmentEngine,
)

from test_segments import _WORDS, doc_specs, make_docs

pytestmark = pytest.mark.segments

main = tcli.main


@pytest.fixture(autouse=True)
def _disarm():
    """Each package's injector is process-global: disarmed around every
    test, both of them."""
    for f in (faults, jfaults):
        f.install(None)
        f.begin_run()
    yield
    for f in (faults, jfaults):
        f.install(None)
        f.begin_run()


def build_reference(tmp_path, token_lists, name="ref"):
    """The port's from-scratch ``--backend cpu --artifact`` build of
    exactly these documents."""
    paths, _ = make_docs(tmp_path, token_lists, prefix=name)
    listfile = tmp_path / f"{name}-list.txt"
    write_manifest(listfile, paths)
    out = tmp_path / f"{name}-out"
    assert main(["1", "1", str(listfile), "--backend", "cpu",
                 "--output-dir", str(out), "--artifact"]) == 0
    return out


def answers(eng, vocab, remap=None) -> dict:
    """Every query surface of one engine over ``vocab``: df, postings,
    AND/OR of pairs, BM25 top-k at four depths and letter top-k; doc ids
    through ``remap`` when given."""
    m = (lambda g: g) if remap is None else remap.__getitem__
    b = eng.encode_batch(vocab)
    out = {"df": eng.df(b).tolist(),
           "postings": [[] if p is None else [m(g) for g in p.tolist()]
                        for p in eng.postings(b)]}
    for pair in ([vocab[0], vocab[-1]], vocab[:2], vocab[-2:]):
        for op in ("query_and", "query_or"):
            out[(op, *pair)] = [m(g) for g in
                                getattr(eng, op)(eng.encode_batch(pair)).tolist()]
    for q in ([vocab[0]], vocab[:3], [vocab[-1], vocab[1]]):
        for k in (1, 3, 10, 100):
            out[("bm25", k, *q)] = [(m(g), s) for g, s in
                                    eng.top_k_scored(eng.encode_batch(q), k)]
    for letter in sorted({w[0] for w in vocab}):
        out[("top", letter)] = eng.top_k(letter, 5)
    return out


def assert_state_identical(idx_dir, truth: dict, tmp_path, tag=""):
    """The port's multi-segment answers == the port's host engine over a
    from-scratch build of the live docs (ids mapped densely by rank) ==
    the JAX multi-segment engine over the same directory, exactly."""
    live = sorted(truth)
    remap = {gid: i + 1 for i, gid in enumerate(live)}
    ref = build_reference(tmp_path, [truth[g] for g in live],
                          name=f"ref{tag}{len(live)}")
    vocab = sorted({w for words in truth.values() for w in words})
    with create_engine(str(idx_dir), None) as em, Engine(artifact_path(ref)) as er, \
            jengine.create_engine(str(idx_dir), None) as ej:
        assert type(em) is MultiSegmentEngine
        got = answers(em, vocab, remap)
        want = answers(er, vocab)
        # letter top-k by df: equal wherever dfs differ; the packer's and
        # the build's order agree on ties here (both term-ascending)
        assert got == want
        assert answers(em, vocab) == answers(ej, vocab)
        assert em.bm25_stats() == ej.bm25_stats()


def _tree(root) -> dict:
    """Every file of a live directory by relative path (the segment
    layer's own files and segments/, not the batch build's letters)."""
    out = {}
    for p in sorted(root.rglob("*")):
        rel = p.relative_to(root)
        if p.is_file() and (rel.parts[0] == "segments"
                            or rel.name.startswith("segments.")):
            out[str(rel)] = p.read_bytes()
    return out


# -- manifest integrity -------------------------------------------------


def test_manifest_round_trip(tmp_path):
    e = segments.SegmentEntry(name="seg_1_0", doc_base=0, docs=4,
                              adler32="0abc1234", bytes=512)
    man = segments.SegmentManifest(generation=1, next_seg=1, entries=(e,))
    segments.save_manifest(tmp_path, man, op="seed")
    got = segments.load_manifest(tmp_path)
    assert got == man
    assert got.doc_span == 4
    assert segments.is_segmented(tmp_path)
    assert segments.load_manifest(tmp_path / "nowhere") is None
    # the JAX package writes the same bytes and reads the port's file
    jdir = tmp_path / "jax"
    jdir.mkdir()
    je = jsegments.SegmentEntry(name="seg_1_0", doc_base=0, docs=4,
                                adler32="0abc1234", bytes=512)
    jsegments.save_manifest(jdir, jsegments.SegmentManifest(1, 1, (je,)), op="seed")
    assert (jdir / segments.MANIFEST_NAME).read_bytes() == \
        (tmp_path / segments.MANIFEST_NAME).read_bytes()
    assert jsegments.load_manifest(tmp_path).to_json() == man.to_json()


def test_manifest_rejects_tampering(tmp_path):
    e = segments.SegmentEntry(name="seg_1_0", doc_base=0, docs=4,
                              adler32="0abc1234", bytes=512)
    segments.save_manifest(
        tmp_path, segments.SegmentManifest(1, 1, (e,)), op="seed")
    path = segments.manifest_path(tmp_path)
    doc = json.loads(path.read_text())
    doc["generation"] = 9  # body edit without checksum update
    path.write_text(json.dumps(doc))
    with pytest.raises(segments.SegmentError, match="checksum"):
        segments.load_manifest(tmp_path)
    with pytest.raises(jsegments.SegmentError) as jerr:
        jsegments.load_manifest(tmp_path)
    with pytest.raises(segments.SegmentError) as terr:
        segments.load_manifest(tmp_path)
    assert str(terr.value) == str(jerr.value)
    path.write_text(path.read_text()[: path.stat().st_size // 2])
    with pytest.raises(segments.SegmentError, match="torn"):
        segments.load_manifest(tmp_path)


def test_manifest_rejects_overlapping_ranges(tmp_path):
    es = (segments.SegmentEntry("a", 0, 5, "00", 1),
          segments.SegmentEntry("b", 3, 5, "00", 1))
    segments.save_manifest(
        tmp_path, segments.SegmentManifest(1, 2, es), op="seed")
    with pytest.raises(segments.SegmentError, match="overlap"):
        segments.load_manifest(tmp_path)
    with pytest.raises(jsegments.SegmentError, match="overlap"):
        jsegments.load_manifest(tmp_path)


def test_tombstone_round_trip_and_corruption(tmp_path):
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.segments import (
        tombstones as jtomb,
    )
    bits = np.zeros(37, dtype=bool)
    bits[[0, 5, 36]] = True
    p = tmp_path / "tombstones_3.bin"
    crc, size = tomb_mod.save(p, bits)
    assert p.stat().st_size == size
    assert tomb_mod.load(p, ndocs=37).tolist() == bits.tolist()
    assert tomb_mod.encode(bits) == jtomb.encode(bits)
    assert jtomb.load(p, ndocs=37).tolist() == bits.tolist()
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p.write_bytes(bytes(raw))
    with pytest.raises(segments.SegmentError):
        tomb_mod.load(p, ndocs=37)


# -- append / delete / compact lifecycle --------------------------------


def test_append_seeds_from_batch_artifact(tmp_path):
    rng = random.Random(3)
    base = doc_specs(rng, 5)
    out = build_reference(tmp_path, base, name="seed")
    paths, extra = make_docs(tmp_path, doc_specs(rng, 3), prefix="extra")
    res = segments.append_files(out, paths)
    # the batch-built docs keep ids 1..5; appends continue at 6
    assert res["doc_ids"] == [6, 7, 8]
    assert res["generation"] == 2 and res["segments"] == 2
    assert is_segment_managed(out)
    truth = {i + 1: w for i, w in enumerate(base + extra)}
    assert_state_identical(out, truth, tmp_path, tag="seed")
    ok, problems = verify_output_dir(out)
    assert ok, problems


def test_append_delete_compact_byte_identity(tmp_path):
    """The acceptance sequence: appends, deletes (incl. re-delete),
    compaction — identical to from-scratch at every step."""
    rng = random.Random(7)
    idx = tmp_path / "idx"
    truth: dict[int, list[str]] = {}
    gid = 1
    for batch in range(3):
        specs = doc_specs(rng, 4)
        paths, _ = make_docs(tmp_path, specs, prefix=f"b{batch}")
        res = segments.append_files(idx, paths)
        assert res["doc_base"] == gid - 1
        for w in specs:
            truth[gid] = w
            gid += 1
    assert_state_identical(idx, truth, tmp_path, tag="a")
    res = segments.delete_docs(idx, [2, 7, 11])
    assert res["newly_tombstoned"] == 3
    for g in (2, 7, 11):
        del truth[g]
    assert_state_identical(idx, truth, tmp_path, tag="d")
    # idempotent re-delete
    assert segments.delete_docs(idx, [7])["newly_tombstoned"] == 0
    res = segments.compact(idx, force=True)
    assert res["compacted"] and res["tombstones_dropped"] == 3
    man = segments.load_manifest(idx)
    assert len(man.entries) < 3  # a run was folded
    assert_state_identical(idx, truth, tmp_path, tag="c")
    ok, problems = verify_output_dir(idx)
    assert ok, problems


def test_block_boundary_dfs(tmp_path, monkeypatch):
    """A term whose merged posting list spans several v2 blocks (tiny
    block size) keeps exact parity across segments and compaction."""
    monkeypatch.setenv("MRI_SERVE_BLOCK_SIZE", "8")
    rng = random.Random(11)
    idx = tmp_path / "idx"
    truth, gid = {}, 1
    for batch in range(3):
        specs = [["awordqq"] * (1 + int(rng.randrange(3)))
                 + [_WORDS[rng.randrange(len(_WORDS))] for _ in range(6)]
                 for _ in range(10)]
        paths, _ = make_docs(tmp_path, specs, prefix=f"bb{batch}")
        segments.append_files(idx, paths)
        for w in specs:
            truth[gid] = w
            gid += 1
    with create_engine(str(idx), None) as em:
        assert em.df(em.encode_batch(["awordqq"])).tolist() == [30]
    assert_state_identical(idx, truth, tmp_path, tag="bb")
    segments.delete_docs(idx, [1, 8, 9, 16, 17, 24])  # block edges
    for g in (1, 8, 9, 16, 17, 24):
        del truth[g]
    assert_state_identical(idx, truth, tmp_path, tag="bbd")
    segments.compact(idx, force=True)
    assert_state_identical(idx, truth, tmp_path, tag="bbc")


def test_compact_preserves_global_ids(tmp_path):
    rng = random.Random(19)
    idx = tmp_path / "idx"
    for batch in range(3):
        paths, _ = make_docs(tmp_path, doc_specs(rng, 3), prefix=f"g{batch}")
        segments.append_files(idx, paths)
    segments.delete_docs(idx, [4])
    before = segments.load_manifest(idx)
    res = segments.compact(idx, force=True)
    after = segments.load_manifest(idx)
    assert after.generation == before.generation + 1
    assert after.doc_span == before.doc_span  # ids never renumber
    assert sum(e.tomb_count for e in after.entries) == 0
    paths, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix="g9")
    assert segments.append_files(idx, paths)["doc_ids"] == [10, 11]
    # retired inputs stay on disk for live readers until pruned
    retired = set(res["inputs"])
    names = {p.name for p in segments.segments_root(idx).iterdir()}
    assert retired <= names
    pruned = segments.prune_retired(idx)
    assert retired <= set(pruned)
    ok, problems = verify_output_dir(idx)
    assert ok, problems


def test_compact_trigger_and_force(tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SEGMENT_COMPACT_TRIGGER", "4")
    rng = random.Random(23)
    idx = tmp_path / "idx"
    for batch in range(2):
        paths, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix=f"t{batch}")
        segments.append_files(idx, paths)
    res = segments.compact(idx)  # 2 < trigger: no-op
    assert not res["compacted"] and "trigger" in res["reason"]
    assert res == jsegments.compact(idx)  # the JAX answer on the same dir
    assert segments.compact(idx, force=True)["compacted"]
    monkeypatch.setenv("MRI_SEGMENT_COMPACT_TRIGGER", "1")
    with pytest.raises(ValueError, match="MRI_SEGMENT_COMPACT_TRIGGER"):
        segments.should_compact(segments.load_manifest(idx))


def test_delete_validation(tmp_path):
    rng = random.Random(29)
    idx = tmp_path / "idx"
    paths, _ = make_docs(tmp_path, doc_specs(rng, 3), prefix="v")
    segments.append_files(idx, paths)
    with pytest.raises(segments.SegmentError, match="outside every"):
        segments.delete_docs(idx, [99])
    with pytest.raises(segments.SegmentError, match="at least one"):
        segments.delete_docs(idx, [])
    # a rejected delete leaves no WAL record behind
    assert not wal_mod.wal_path(idx).exists()


# -- fault kinds: the old generation keeps serving ----------------------


def _armed(kind):
    faults.install(kind)
    faults.begin_run()


def test_append_torn_manifest_keeps_old_generation(tmp_path):
    rng = random.Random(31)
    idx = tmp_path / "idx"
    paths, specs = make_docs(tmp_path, doc_specs(rng, 3), prefix="f0")
    segments.append_files(idx, paths)
    before = segments.load_manifest(idx)
    truth = {i + 1: w for i, w in enumerate(specs)}
    more, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix="f1")
    _armed("append-torn-manifest")
    try:
        with pytest.raises(segments.SegmentError, match="publish"):
            segments.append_files(idx, more)
    finally:
        faults.install(None)
    after = segments.load_manifest(idx)
    assert after == before  # generation unchanged, byte-intact
    names = {p.name for p in segments.segments_root(idx).iterdir()}
    assert names == {e.name for e in before.entries}  # no orphans
    ok, problems = verify_output_dir(idx)
    assert ok, problems
    assert_state_identical(idx, truth, tmp_path, tag="torn")
    assert segments.append_files(idx, more)["generation"] == 2


def test_tombstone_corrupt_rejected(tmp_path):
    rng = random.Random(37)
    idx = tmp_path / "idx"
    paths, _ = make_docs(tmp_path, doc_specs(rng, 3), prefix="tc")
    segments.append_files(idx, paths)
    before = segments.load_manifest(idx)
    _armed("tombstone-corrupt")
    try:
        with pytest.raises(segments.SegmentError):
            segments.delete_docs(idx, [1])
    finally:
        faults.install(None)
    after = segments.load_manifest(idx)
    assert after == before
    assert sum(e.tomb_count for e in after.entries) == 0
    ok, problems = verify_output_dir(idx)
    assert ok, problems
    assert segments.delete_docs(idx, [1])["newly_tombstoned"] == 1


def test_compact_crash_old_generation_intact(tmp_path):
    rng = random.Random(41)
    idx = tmp_path / "idx"
    for batch in range(2):
        paths, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix=f"cc{batch}")
        segments.append_files(idx, paths)
    before = segments.load_manifest(idx)
    _armed("compact-crash")
    try:
        with pytest.raises(faults.InjectedCompactCrash):
            segments.compact(idx, force=True)
    finally:
        faults.install(None)
    assert segments.load_manifest(idx) == before
    ok, problems = verify_output_dir(idx)
    assert ok, problems
    res = segments.compact(idx, force=True)
    assert res["compacted"]
    ok, problems = verify_output_dir(idx)
    assert ok, problems


# -- engine routing ------------------------------------------------------


@pytest.mark.parametrize("engine_env", [None, "host", "auto", "device"])
def test_engine_guards_and_routing(tmp_path, monkeypatch, engine_env):
    """No engine named (the port's default is the card), ``host`` or
    ``auto``: the multi-segment engine, as the JAX package routes a live
    directory; a named ``device`` (flag or ``$MRI_SERVE_ENGINE``) refuses
    with the JAX message."""
    rng = random.Random(43)
    base = doc_specs(rng, 4)
    out = build_reference(tmp_path, base, name="guard")
    paths, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix="guard2")
    segments.append_files(out, paths)
    # the root index.mri is now STALE: single-artifact engines refuse
    with pytest.raises(ArtifactError, match="segment-managed"):
        Engine(artifact_path(out))
    if engine_env is not None:
        monkeypatch.setenv("MRI_SERVE_ENGINE", engine_env)
    if engine_env == "device":
        with pytest.raises(ArtifactError) as terr:
            create_engine(str(out), None, device="cpu")
        with pytest.raises(Exception) as jerr:
            jengine.create_engine(str(out), "device")
        assert str(terr.value) == str(jerr.value)
        return
    for which in (None, engine_env):
        eng = create_engine(str(out), which, device="cpu")
        try:
            assert isinstance(eng, MultiSegmentEngine)
            assert eng.engine_name == "multi"
            d = eng.describe()
            assert d["generation"] == 2 and len(d["segments"]) == 2
        finally:
            eng.close()
    with pytest.raises(ArtifactError, match="device"):
        create_engine(str(out), "device")


def test_multi_engine_stats_parity(tmp_path):
    """Global (ndocs, avgdl) from summed per-segment stats equals the
    from-scratch corpus stats, bit for bit."""
    rng = random.Random(47)
    idx = tmp_path / "idx"
    truth, gid = {}, 1
    for batch in range(2):
        specs = doc_specs(rng, 3)
        paths, _ = make_docs(tmp_path, specs, prefix=f"s{batch}")
        segments.append_files(idx, paths)
        for w in specs:
            truth[gid] = w
            gid += 1
    segments.delete_docs(idx, [3])
    del truth[3]
    ref = build_reference(tmp_path, [truth[g] for g in sorted(truth)])
    with create_engine(str(idx), None) as em:
        ndocs, avgdl = em.bm25_stats()
        with load_artifact(artifact_path(ref)) as art:
            _dl, ref_ndocs, ref_avgdl = bm25_corpus(art)
        assert ndocs == ref_ndocs
        assert avgdl == ref_avgdl  # exact, not approx
        d = em.describe()
    with jengine.create_engine(str(idx), None) as ej:
        jd = ej.describe()
    for key in ("ops",):
        d.pop(key)
        jd.pop(key)
    assert d == jd


# -- CLI surface --------------------------------------------------------


def test_cli_append_delete_compact_verify(tmp_path, capsys):
    rng = random.Random(53)
    paths, _ = make_docs(tmp_path, doc_specs(rng, 3), prefix="cli")
    idx = tmp_path / "idx"
    assert main(["append", str(idx), "--add", *paths]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["generation"] == 1 and out["doc_ids"] == [1, 2, 3]
    assert main(["delete", str(idx), "--docs", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tombstoned_total"] == 1
    more, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix="cli2")
    assert main(["append", str(idx), "--add", *more]) == 0
    capsys.readouterr()
    assert main(["compact", str(idx), "--force", "--prune"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["compacted"]
    assert json.loads(lines[1])["pruned"]
    assert main(["--verify", str(idx)]) == 0
    capsys.readouterr()
    assert main(["delete", str(idx), "--docs", "99"]) == 2
    assert main(["append", str(idx), "--add", paths[0],
                 "--fault-spec", "append-torn-manifest"]) == 2
    assert main(["append", str(idx), "--add", paths[0],
                 "--fault-spec", "nonsense-kind"]) == 2
    assert main(["append", str(idx), "--add", str(tmp_path / "missing.txt")]) == 2
    capsys.readouterr()
    assert main(["--verify", str(idx)]) == 0


def test_cli_query_routes_multi_segment(tmp_path, capsys):
    rng = random.Random(59)
    paths, specs = make_docs(tmp_path, doc_specs(rng, 3), prefix="q")
    idx = tmp_path / "idx"
    assert main(["append", str(idx), "--add", *paths]) == 0
    capsys.readouterr()
    term = specs[0][0]
    # no --engine and no --device: the multi-segment engine on the host
    assert main(["query", str(idx), term]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = sorted(i + 1 for i, w in enumerate(specs) if term in w)
    assert out["term"] == term and out["postings"] == want
    for args in ([term, specs[1][0]], ["--op", "and", term, specs[0][1]],
                 ["--top-k", "3", "--score", "bm25", term, specs[1][0]],
                 ["--top-k", "2", "--letter", term[0]]):
        assert jcli.main(["query", str(idx), *args]) == 0
        want = capsys.readouterr().out
        assert main(["query", str(idx), *args]) == 0
        assert capsys.readouterr().out == want
    assert main(["query", str(idx), term, "--stats"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["engine"] == "multi"
    assert main(["query", str(idx), term, "--engine", "device", "--device", "cpu"]) == 2
    assert "device engine serves single artifacts only" in capsys.readouterr().err


# -- daemon admin surface -----------------------------------------------


def _rpc_conn(addr):
    sock = socket.create_connection(addr, timeout=30)
    f = sock.makefile("rwb")

    def rpc(**kw):
        f.write((json.dumps(kw) + "\n").encode())
        f.flush()
        return json.loads(f.readline())

    def close():
        f.close()
        sock.close()
    return rpc, close


@pytest.mark.daemon
def test_daemon_live_mutations(tmp_path):
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
        ServeDaemon,
    )
    rng = random.Random(61)
    paths, specs = make_docs(tmp_path, doc_specs(rng, 3), prefix="d")
    idx = tmp_path / "idx"
    segments.append_files(idx, paths)
    term = specs[0][0]
    base_df = sum(term in w for w in specs)
    d = ServeDaemon(str(idx), port=0)  # the default engine: multi
    d.start()
    try:
        rpc, close = _rpc_conn(d.address)
        try:
            assert rpc(id=1, op="df", terms=[term])["df"] == [base_df]
            more, _ = make_docs(tmp_path, [[term, "zz"]] * 2, prefix="d2")
            r = rpc(id=2, op="append", files=more)
            assert r["ok"] and r["result"]["doc_ids"] == [4, 5]
            assert rpc(id=3, op="df", terms=[term])["df"] == [base_df + 2]
            r = rpc(id=4, op="delete", docs=[4])
            assert r["ok"] and r["result"]["tombstoned_total"] == 1
            assert rpc(id=5, op="df", terms=[term])["df"] == [base_df + 1]
            r = rpc(id=6, op="compact")
            assert r["ok"] and r["result"]["compacted"]
            assert rpc(id=7, op="df", terms=[term])["df"] == [base_df + 1]
            r = rpc(id=8, op="append", files=["/nope/missing.txt"])
            assert r["error"] == "mutation_rejected"
            assert rpc(id=9, op="df", terms=[term])["df"] == [base_df + 1]
            st = rpc(id=10, op="stats")["stats"]
            assert st["counters"]["mutations"] == 3
            assert st["counters"]["mutation_rejected"] == 1
            assert st["engine"]["generation"] >= 4 and st["engine"]["engine"] == "multi"
            text = rpc(id=11, op="metrics")["text"]
            assert "mri_generation" in text
            assert "mri_serve_mutations_total 3" in text
            fams = [ln.split()[2] for ln in text.splitlines()
                    if ln.startswith("# TYPE ")]
            assert len(fams) == len(set(fams))
            assert rpc(id=12, op="append")["error"] == "bad_request"
            assert rpc(id=13, op="delete", docs=["x"])["error"] == "bad_request"
        finally:
            close()
    finally:
        d.drain()
    ok, problems = verify_output_dir(idx)
    assert ok, problems


@pytest.mark.daemon
def test_daemon_tombstone_flush_batching(tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SEGMENT_TOMBSTONE_FLUSH", "3")
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
        ServeDaemon,
    )
    rng = random.Random(67)
    paths, _ = make_docs(tmp_path, doc_specs(rng, 6), prefix="fl")
    idx = tmp_path / "idx"
    segments.append_files(idx, paths)
    d = ServeDaemon(str(idx), port=0, engine="host")
    d.start()
    try:
        rpc, close = _rpc_conn(d.address)
        try:
            assert rpc(id=1, op="delete", docs=[1])["result"]["buffered"]
            assert rpc(id=2, op="delete", docs=[2])["result"]["buffered"]
            r = rpc(id=3, op="delete", docs=[3])  # third op: flush
            assert r["result"]["deleted"] == [1, 2, 3]
            gen_after_flush = r["result"]["generation"]
            assert rpc(id=4, op="delete", docs=[4])["result"]["buffered"]
        finally:
            close()
    finally:
        d.drain()  # drain publishes the buffered remainder
    man = segments.load_manifest(idx)
    assert man.generation == gen_after_flush + 1
    assert sum(e.tomb_count for e in man.entries) == 4


# -- parity: one sequence, two packages, byte-equal files ---------------


def _sequence(pkg_segments, wal, idx, batches, seed_list=None):
    """Seed (optional), three appends, deletes with a re-delete, a
    compaction, a tombstone after it and two logged-but-unapplied WAL
    records; returns every result."""
    res = []
    if seed_list is not None:
        res.append(("seed", seed_list))
    for paths in batches:
        res.append(pkg_segments.append_files(idx, paths))
    res.append(pkg_segments.delete_docs(idx, [2, 9, 10]))
    res.append(pkg_segments.delete_docs(idx, [9]))
    c = dict(pkg_segments.compact(idx, force=True))
    c.pop("compact_ms")
    res.append(c)
    res.append(pkg_segments.delete_docs(idx, [1]))
    with pkg_segments.mutation_lock(idx):
        wal.log_mutation(idx, "delete", {"docs": [3]})
        wal.log_mutation(idx, "compact", {"force": True})
    return res


@pytest.mark.parametrize("seeded", [False, True])
def test_same_sequence_byte_equal_in_both_packages(tmp_path, seeded):
    rng = random.Random(71 + seeded)
    batches = [make_docs(tmp_path, doc_specs(rng, n), prefix=f"p{i}")[0]
               for i, n in enumerate((4, 5, 3))]
    dirs = {}
    for name, pkg, wal in (("jax", jsegments, jwal), ("port", segments, wal_mod)):
        idx = tmp_path / name
        if seeded:
            seed = build_reference(tmp_path, doc_specs(random.Random(5), 6), name=f"s{name}")
            seed.rename(idx)
        dirs[name] = (idx, _sequence(pkg, wal, idx, batches))
    (jdir, jres), (tdir, tres) = dirs["jax"], dirs["port"]
    assert tres == jres
    jt, tt = _tree(jdir), _tree(tdir)
    assert sorted(tt) == sorted(jt)
    assert "segments.wal" in tt and any(k.endswith(".bin") for k in tt)
    for k in jt:
        assert tt[k] == jt[k], k
    # the WAL tails replay to the same bytes in both packages
    jrec, trec = jsegments.recover(jdir), segments.recover(tdir)
    jrec.pop("swept")
    trec.pop("swept")
    assert trec == jrec and trec["replayed"] == 2
    jt, tt = _tree(jdir), _tree(tdir)
    assert tt == jt


def test_each_package_serves_the_others_directory(tmp_path):
    """A directory the JAX package mutated, served by the port, and the
    port's served by the JAX package: equal answers, exactly; then each
    mutates the other's directory onward."""
    rng = random.Random(79)
    batches = [make_docs(tmp_path, doc_specs(rng, n), prefix=f"x{i}")[0]
               for i, n in enumerate((5, 4))]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d, pkg in ((jdir, jsegments), (tdir, segments)):
        for paths in batches:
            pkg.append_files(d, paths)
        pkg.delete_docs(d, [1, 6])
    vocab = sorted(_WORDS)
    with create_engine(str(jdir), None) as tm, jengine.create_engine(str(tdir), None) as jm:
        assert answers(tm, vocab) == answers(jm, vocab)
    # cross-mutation: each package continues the other's directory
    more, _ = make_docs(tmp_path, doc_specs(rng, 3), prefix="x9")
    assert segments.append_files(jdir, more) == jsegments.append_files(tdir, more)
    segments.compact(jdir, force=True)
    jsegments.compact(tdir, force=True)
    assert _tree(jdir) == _tree(tdir)
    ok, problems = verify_output_dir(jdir)
    assert ok, problems


def test_cli_stdout_and_exit_codes_equal_jax(tmp_path, capsys):
    rng = random.Random(83)
    paths, _ = make_docs(tmp_path, doc_specs(rng, 4), prefix="c0")
    more, _ = make_docs(tmp_path, doc_specs(rng, 3), prefix="c1")
    seqs = [["append", "--add", *paths], ["append", "--add", *more],
            ["delete", "--docs", "2", "5"], ["delete", "--docs", "5"],
            ["delete", "--docs", "99"], ["compact"], ["compact", "--force"],
            ["compact", "--force", "--prune"], ["recover"],
            ["append", "--add", *more, "--fault-spec", "append-torn-manifest"],
            ["delete", "--docs", "3", "--fault-spec", "tombstone-corrupt"],
            ["delete", "--docs", "3", "--fault-spec", "wal-torn-record"],
            ["recover"], ["recover", "--fault-spec", "bad-kind"],
            ["append", "--add", str(tmp_path / "nowhere.txt")],
            ["replicate", "--from", "nohost"], ["replicate", "--from", "127.0.0.1:1"]]
    for argv in seqs:
        got = []
        for pkg_main, d in ((jcli.main, tmp_path / "jax"), (tcli.main, tmp_path / "port")):
            rc = pkg_main([argv[0], str(d), *argv[1:]])
            out, err = capsys.readouterr()
            lines = []
            for ln in out.splitlines():
                doc = json.loads(ln)
                doc.pop("compact_ms", None)
                doc.pop("seconds", None)
                lines.append(doc)
            got.append((rc, lines, err.replace(str(d), "DIR").count("\n")))
        assert got[1] == got[0], argv
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")
