"""The port's durable mutations (``segments/wal.py``,
``segments/replica.py``) against the JAX package's.

One twin of each test of ``tests/test_wal.py``, run on the port: the
checksummed WAL container and its torn-tail quarantine, the
``wal-torn-record`` fault, replay, the ``MRI_SEGMENT_WAL`` knob, the
``recover`` CLI, the SIGKILL of a ``serve`` child holding acknowledged
buffered deletes, the lease, segment shipping (byte-equal, a torn fetch
healed, a rollback refused), ``replicate``'s address rules and the
``min_generation`` fence.  Every recovered or replicated state is held
exactly (BM25 floats included) against the port's host ``Engine`` over
a from-scratch build and the JAX ``MultiSegmentEngine`` on the same
directory; the WAL bytes and the ``recover`` reports are held against
the JAX package's on the same records, and a JAX replica follows a port
primary (and the other way round) to the same bytes.
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from conftest import REPO_ROOT

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import (
    cli as jcli,
    faults as jfaults,
    segments as jsegments,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.segments import (
    wal as jwal,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.daemon import (
    ServeDaemon as JDaemon,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
    faults,
    segments,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.audit import (
    verify_output_dir,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import (
    main,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.segments import (
    replica as replica_mod,
    wal as wal_mod,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
    ServeDaemon,
)

from test_torch_segments import assert_state_identical
from test_wal import _WORDS, doc_specs, make_docs

pytestmark = pytest.mark.wal

PORT = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"


@pytest.fixture(autouse=True)
def _disarm():
    for f in (faults, jfaults):
        f.install(None)
        f.begin_run()
    yield
    for f in (faults, jfaults):
        f.install(None)
        f.begin_run()


def seed_segmented(tmp_path, rng, n=4, prefix="seed"):
    """A generation-1 segmented dir (built by the port) + its truth."""
    paths, specs = make_docs(tmp_path, doc_specs(rng, n), prefix=prefix)
    idx = tmp_path / f"{prefix}-idx"
    segments.append_files(idx, paths)
    return idx, {i + 1: w for i, w in enumerate(specs)}


# -- WAL container ------------------------------------------------------


def test_wal_container_round_trip(tmp_path):
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for w, d in ((wal_mod, tmp_path), (jwal, jdir)):
        s1 = w.log_mutation(d, "append", {"files": ["a.txt"]})
        s2 = w.log_mutation(d, "delete", {"docs": [3, 7]})
        s3 = w.log_mutation(d, "compact", {"force": True})
        assert (s1, s2, s3) == (1, 2, 3)
    # the same records, the same bytes, and each package reads the other's
    assert wal_mod.wal_path(tmp_path).read_bytes() == jwal.wal_path(jdir).read_bytes()
    assert jwal.read_records(tmp_path) == wal_mod.read_records(jdir)
    records, info = wal_mod.read_records(tmp_path)
    assert info == {}
    assert [r["op"] for r in records] == ["append", "delete", "compact"]
    assert records[1]["docs"] == [3, 7]
    assert wal_mod.tail(tmp_path, 1) == records[1:]
    assert wal_mod.tail(tmp_path, 3) == []
    wal_mod.discard(tmp_path, s2)
    assert [r["seq"] for r in wal_mod.read_records(tmp_path)[0]] == [1, 3]
    assert wal_mod.log_mutation(tmp_path, "append", {"files": []}) == 4


def test_wal_torn_tail_quarantined(tmp_path):
    wal_mod.log_mutation(tmp_path, "append", {"files": ["a.txt"]})
    wal_mod.log_mutation(tmp_path, "delete", {"docs": [1]})
    path = wal_mod.wal_path(tmp_path)
    whole = path.read_bytes()
    path.write_bytes(whole[:-7])
    records, info = wal_mod.read_records(tmp_path)
    assert [r["op"] for r in records] == ["append"]
    assert info["quarantined_bytes"] > 0
    assert wal_mod.corrupt_path(tmp_path).exists()
    assert wal_mod.read_records(tmp_path) == (records, {})
    bad = bytearray(whole)
    bad[-3] ^= 0xFF
    path.write_bytes(bytes(bad))
    records, info = wal_mod.read_records(tmp_path)
    assert [r["op"] for r in records] == ["append"]
    assert "checksum" in info["damage"]
    # the JAX reader repairs the same damage to the same bytes
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jwal.wal_path(jdir).write_bytes(bytes(bad))
    jrecords, jinfo = jwal.read_records(jdir)
    assert jrecords == records and jinfo["damage"] == info["damage"]
    assert jwal.wal_path(jdir).read_bytes() == path.read_bytes()


def test_wal_torn_record_fault_fails_unacked(tmp_path):
    rng = random.Random(11)
    idx, truth = seed_segmented(tmp_path, rng)
    gen = segments.load_manifest(idx).generation
    faults.install("wal-torn-record")
    faults.begin_run()
    try:
        with pytest.raises(segments.SegmentError):
            segments.delete_docs(idx, [1])
    finally:
        faults.install(None)
        faults.begin_run()
    assert segments.load_manifest(idx).generation == gen
    rep = segments.recover(idx)
    assert rep["replayed"] == 0
    assert wal_mod.corrupt_path(idx).exists()
    assert_state_identical(idx, truth, tmp_path, tag="torn")


def test_wal_replay_applies_unpublished_records(tmp_path):
    """A record logged but never applied (crash between fsync and
    publish) replays to the exact state the ack promised — in the port
    and, on a copy of the same directory, in the JAX package."""
    import shutil

    rng = random.Random(23)
    idx, truth = seed_segmented(tmp_path, rng, n=5)
    with segments.mutation_lock(idx):
        wal_mod.log_mutation(idx, "delete", {"docs": [2, 4]})
    jidx = tmp_path / "jax-idx"
    shutil.copytree(idx, jidx)
    rep = segments.replay(idx)
    jrep = jsegments.replay(jidx)
    assert rep["replayed"] == 1 and rep == jrep
    truth.pop(2)
    truth.pop(4)
    assert_state_identical(idx, truth, tmp_path, tag="replay")
    assert segments.replay(idx)["replayed"] == 0
    ok, problems = verify_output_dir(idx)
    assert ok, problems
    assert segments.load_manifest(idx).to_json() == jsegments.load_manifest(jidx).to_json()


def test_wal_disabled_by_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SEGMENT_WAL", "0")
    rng = random.Random(31)
    idx, truth = seed_segmented(tmp_path, rng)
    segments.delete_docs(idx, [1])
    assert not wal_mod.wal_path(idx).exists()
    truth.pop(1)
    assert_state_identical(idx, truth, tmp_path, tag="off")
    monkeypatch.setenv("MRI_SEGMENT_WAL", "2")
    with pytest.raises(ValueError, match="MRI_SEGMENT_WAL"):
        wal_mod.wal_enabled()


def test_recover_cli_reports_json(tmp_path, capsys):
    rng = random.Random(41)
    idx, _ = seed_segmented(tmp_path, rng)
    with segments.mutation_lock(idx):
        wal_mod.log_mutation(idx, "delete", {"docs": [1]})
    assert main(["recover", str(idx)]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["replayed"] == 1 and rep["segmented"]
    assert main(["recover", str(tmp_path / "nowhere")]) == 0
    out = capsys.readouterr().out
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep == {"generation": 0, "replayed": 0, "segmented": False,
                   "skipped": 0, "swept": [], "truncated": 0,
                   "wal_seq": 0}
    assert jcli.main(["recover", str(tmp_path / "nowhere")]) == 0
    assert capsys.readouterr().out == out


# -- SIGKILL during tombstone batch flush -------------------------------


@pytest.mark.daemon
def test_sigkill_during_tombstone_batch_flush(tmp_path):
    """``serve`` child at MRI_SEGMENT_TOMBSTONE_FLUSH=4, on its default
    engine (the multi-segment engine, no card needed): three acked
    buffered deletes, then SIGKILL — recovery replays every one."""
    rng = random.Random(53)
    idx, truth = seed_segmented(tmp_path, rng, n=6)
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT),
               MRI_SEGMENT_TOMBSTONE_FLUSH="4")
    env.pop("MRI_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", PORT, "serve", str(idx), "--listen", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=str(REPO_ROOT), text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["engine"] == "multi"
        sock = socket.create_connection((ready["host"], ready["port"]), timeout=30)
        f = sock.makefile("rwb")

        def rpc(**kw):
            f.write((json.dumps(kw) + "\n").encode())
            f.flush()
            return json.loads(f.readline())

        try:
            more, mspecs = make_docs(tmp_path, doc_specs(rng, 2), prefix="live")
            r = rpc(id=1, op="append", files=more)
            assert r["ok"], r
            for gid, words in zip(r["result"]["doc_ids"], mspecs):
                truth[gid] = words
            for i, victim in enumerate((1, 3, 7)):
                r = rpc(id=10 + i, op="delete", docs=[victim])
                assert r["ok"] and r["result"]["buffered"], r
                assert r["result"]["wal_seq"] > 0
                truth.pop(victim)
        finally:
            f.close()
            sock.close()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    assert sum(e.tomb_count for e in segments.load_manifest(idx).entries) == 0
    # the JAX reader sees the same three acked records
    assert [r["docs"] for r in jwal.read_records(idx)[0]] == [[1], [3], [7]]
    rep = segments.recover(idx)
    assert rep["replayed"] == 3, rep
    ok, problems = verify_output_dir(idx)
    assert ok, problems
    assert_state_identical(idx, truth, tmp_path, tag="kill")


# -- leases -------------------------------------------------------------


def test_lease_renew_reject_expire_release(tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SEGMENT_LEASE_TTL_S", "30")
    assert replica_mod.read_lease(tmp_path) is None
    lease = segments.renew_lease(tmp_path, "alice")
    assert lease["owner"] == "alice"
    segments.renew_lease(tmp_path, "alice")
    with pytest.raises(segments.LeaseError, match="lease_lost"):
        segments.renew_lease(tmp_path, "bob")
    # the JAX package honours the port's lease inside segments.lock
    with pytest.raises(jsegments.LeaseError, match="lease_lost"):
        jsegments.renew_lease(tmp_path, "bob")
    segments.renew_lease(tmp_path, "alice", ttl=0.05)
    time.sleep(0.1)
    assert segments.renew_lease(tmp_path, "bob")["owner"] == "bob"
    assert not segments.release_lease(tmp_path, "alice")
    assert segments.release_lease(tmp_path, "bob")
    assert replica_mod.read_lease(tmp_path) is None
    # the injected steal: the next renew is rejected
    faults.install("lease-steal")
    faults.begin_run()
    with pytest.raises(segments.LeaseError, match="lease_lost"):
        segments.renew_lease(tmp_path, "carol")
    assert replica_mod.read_lease(tmp_path)["owner"] == replica_mod.THIEF_OWNER


def test_lease_disabled_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("MRI_SEGMENT_LEASE_TTL_S", raising=False)
    assert segments.renew_lease(tmp_path, "anyone") is None
    assert not segments.release_lease(tmp_path, "anyone")
    monkeypatch.setenv("MRI_SEGMENT_LEASE_TTL_S", "-1")
    with pytest.raises(ValueError, match="MRI_SEGMENT_LEASE_TTL_S"):
        segments.renew_lease(tmp_path, "anyone")


# -- segment shipping ---------------------------------------------------


def _daemon(cls, idx, **kw):
    d = cls(str(idx), port=0, **kw)
    d.start()
    return d


def _tree_bytes(root: Path) -> dict:
    out = {"manifest": segments.manifest_path(root).read_bytes()}
    for p in sorted(segments.segments_root(root).rglob("*")):
        if p.is_file():
            out[str(p.relative_to(root))] = p.read_bytes()
    return out


@pytest.mark.daemon
@pytest.mark.parametrize("primary", ["port", "jax"])
def test_replicate_ships_segments_byte_equal(tmp_path, primary):
    """The port's replicate() against a port primary and a JAX primary:
    every shipped byte equal, a current replica a no-op, the delta only."""
    rng = random.Random(71)
    idx, truth = seed_segmented(tmp_path, rng, n=5)
    segments.delete_docs(idx, [2])
    truth.pop(2)
    d = _daemon(ServeDaemon if primary == "port" else JDaemon, idx)
    rep = tmp_path / "replica"
    try:
        res = segments.replicate(rep, d.address)
        assert res["generation"] == 2 and res["fetched"]
        assert _tree_bytes(rep) == _tree_bytes(idx)
        res2 = segments.replicate(rep, d.address)
        assert not res2["changed"] and res2["fetched"] == []
        more, mspecs = make_docs(tmp_path, doc_specs(rng, 2), prefix="m")
        r = segments.append_files(idx, more)
        for gid, words in zip(r["doc_ids"], mspecs):
            truth[gid] = words
        res3 = segments.replicate(rep, d.address)
        assert res3["behind"] >= 1 and res3["changed"]
        assert _tree_bytes(rep) == _tree_bytes(idx)
        # and the JAX client follows the port's primary the same way
        jrep = tmp_path / "jreplica"
        jsegments.replicate(jrep, d.address)
        assert _tree_bytes(jrep) == _tree_bytes(idx)
    finally:
        d.drain()
    assert_state_identical(rep, truth, tmp_path, tag="rep")
    ok, problems = verify_output_dir(rep)
    assert ok, problems


@pytest.mark.daemon
def test_replicate_rejects_torn_fetch_then_heals(tmp_path):
    rng = random.Random(83)
    idx, truth = seed_segmented(tmp_path, rng, n=4)
    d = _daemon(ServeDaemon, idx)
    rep = tmp_path / "replica"
    try:
        # the in-process daemon shares this injector: the tear fires
        # inside segment_file_payload on the serving side
        faults.install("fetch-partial")
        faults.begin_run()
        res = segments.replicate(rep, d.address)
        assert res["generation"] == 1
        assert _tree_bytes(rep) == _tree_bytes(idx)
    finally:
        d.drain()
    assert_state_identical(rep, truth, tmp_path, tag="heal")


@pytest.mark.daemon
def test_replicate_refuses_manifest_rollback(tmp_path):
    rng = random.Random(89)
    idx, _ = seed_segmented(tmp_path, rng, n=3)
    rep_idx, _ = seed_segmented(tmp_path, rng, n=3, prefix="rep")
    segments.delete_docs(rep_idx, [1])  # replica is at generation 2
    before = _tree_bytes(rep_idx)
    d = _daemon(ServeDaemon, idx)
    try:
        with pytest.raises(segments.ReplicaError, match="ahead"):
            segments.replicate(rep_idx, d.address)
        with pytest.raises(jsegments.ReplicaError, match="ahead"):
            jsegments.replicate(rep_idx, d.address)
    finally:
        d.drain()
    assert _tree_bytes(rep_idx) == before


def test_replicate_cli_and_parse_addr(tmp_path, capsys):
    assert replica_mod.parse_addr("host:99") == ("host", 99)
    for bad in ("nohost", "h:0", "h:notaport", ":7"):
        with pytest.raises(segments.ReplicaError):
            replica_mod.parse_addr(bad)
    assert main(["replicate", str(tmp_path / "r"), "--from", "127.0.0.1:1"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: cannot reach primary at 127.0.0.1:1")
    assert jcli.main(["replicate", str(tmp_path / "r"), "--from", "127.0.0.1:1"]) == 2
    assert capsys.readouterr().err == err


# -- read-your-writes fence ---------------------------------------------


@pytest.mark.daemon
def test_min_generation_fence(tmp_path):
    rng = random.Random(97)
    idx, _ = seed_segmented(tmp_path, rng, n=3)
    term = _WORDS[0]
    d = _daemon(ServeDaemon, idx)
    try:
        sock = socket.create_connection(d.address)
        f = sock.makefile("rwb")

        def rpc(**kw):
            f.write((json.dumps(kw) + "\n").encode())
            f.flush()
            return json.loads(f.readline())

        try:
            ok = rpc(id=1, op="df", terms=[term], min_generation=1)
            assert "error" not in ok
            stale = rpc(id=2, op="df", terms=[term], min_generation=99)
            assert stale["error"] == "stale_generation"
            assert stale["generation"] == 1
            bad = rpc(id=3, op="df", terms=[term], min_generation=-1)
            assert bad["error"] == "bad_request"
        finally:
            f.close()
            sock.close()
    finally:
        d.drain()
