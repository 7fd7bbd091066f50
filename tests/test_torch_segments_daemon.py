"""The port's daemon over a live index directory against the JAX
package's daemon, request line for request line.

Each parity test copies one seeded live directory (built by the port's
``segments.append_files``) twice, starts the JAX ``ServeDaemon`` on one
copy and the port's on the other, sends both the same lines and
compares the answers: mutation acks (``append``/``delete``/``compact``,
buffered deletes under ``MRI_SEGMENT_TOMBSTONE_FLUSH``), the
``stale_generation`` fence, ``mutation_rejected`` (a missing file, an
id outside every segment, a stolen lease, a read-only replica) and the
data ops around them; the two directories end byte-equal.  Dropped
before the comparison: ``trace_id`` and ``compact_ms`` (timings).  Then
the twins of the multi-segment and mutation cases of
``tests/test_attrib.py`` (attribution parity, the explain breakdown per
segment, the merged scrape, generation-stamped mutation spans, the trace
ring under concurrent mutations), the startup recovery of acknowledged
WAL records, a replica daemon following a primary, and the daemon's
engine routing on a live directory.
"""

from __future__ import annotations

import contextlib
import json
import random
import shutil
import socket
import threading
import time

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import (
    faults as jfaults,
    segments as jsegments,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.obs import (
    attribution as jattrib,
    metrics as jmetrics,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.artifact import (
    ArtifactError as JArtifactError,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.daemon import (
    ServeDaemon as JDaemon,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.engine import (
    create_engine as jcreate_engine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
    faults,
    segments,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.obs import (
    attribution as obs_attrib,
    metrics as tmetrics,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.segments import (
    wal as wal_mod,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.artifact import (
    ArtifactError,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
    ServeDaemon,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.engine import (
    create_engine,
)

from test_attrib import _registry_totals
from test_segments import _WORDS, doc_specs, make_docs
from test_torch_segments import _tree

pytestmark = [pytest.mark.daemon, pytest.mark.segments]

_LETTERS = "abcgkpz"


@pytest.fixture(autouse=True)
def _disarm():
    for f in (faults, jfaults):
        f.install(None)
        f.begin_run()
    yield
    for f in (faults, jfaults):
        f.install(None)
        f.begin_run()


@pytest.fixture(scope="module")
def seg_built(tmp_path_factory):
    """A two-segment live directory (two appends into an empty one)."""
    tmp = tmp_path_factory.mktemp("torch_segs")
    rng = random.Random(29)
    idx = tmp / "idx"
    p1, _ = make_docs(tmp, doc_specs(rng, 10), prefix="s1")
    p2, _ = make_docs(tmp, doc_specs(rng, 8), prefix="s2")
    segments.append_files(idx, p1)
    segments.append_files(idx, p2)
    return idx


@contextlib.contextmanager
def serving(cls, path, **kw):
    kw.setdefault("coalesce_us", 100)
    d = cls(str(path), port=0, **kw)
    d.start()
    try:
        yield d
    finally:
        d.drain()


class Client:
    def __init__(self, daemon, timeout=30.0):
        self.sock = socket.create_connection(daemon.address, timeout=timeout)
        self.f = self.sock.makefile("rb")

    def rpc(self, **obj):
        self.sock.sendall((json.dumps(obj) + "\n").encode())
        line = self.f.readline()
        assert line, "server closed the connection"
        return json.loads(line)

    def close(self):
        with contextlib.suppress(OSError):
            self.f.close()
        with contextlib.suppress(OSError):
            self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def strip(resp: dict, root=None) -> dict:
    """A response without its ids and timings, paths made relative."""
    resp = json.loads(json.dumps(resp))
    resp.pop("trace_id", None)
    if isinstance(resp.get("result"), dict):
        resp["result"].pop("compact_ms", None)
    if isinstance(resp.get("explain"), dict):
        resp["explain"].pop("stages_us", None)
    if root is not None and isinstance(resp.get("detail"), str):
        resp["detail"] = resp["detail"].replace(str(root), "DIR")
    return resp


def twin_dirs(src, tmp_path):
    """Two copies of one live directory: (JAX's, the port's)."""
    out = []
    for name in ("jax", "port"):
        d = tmp_path / name
        shutil.copytree(src, d)
        out.append(d)
    return out


def run_both(src, tmp_path, reqs, **kw):
    """The same request lines to a JAX daemon and a port daemon, each on
    its own copy of ``src``; returns both answer lists, stripped."""
    jdir, tdir = twin_dirs(src, tmp_path)
    got = []
    for cls, d in ((JDaemon, jdir), (ServeDaemon, tdir)):
        with serving(cls, d, **kw) as daemon, Client(daemon) as c:
            got.append([strip(c.rpc(**r), d) for r in reqs])
    return got, jdir, tdir


# -- mutation acks, fences and rejections equal the JAX daemon's --------


@pytest.mark.parametrize("flush", [1, 3])
def test_mutation_acks_match_jax(seg_built, tmp_path, monkeypatch, flush):
    monkeypatch.setenv("MRI_SEGMENT_TOMBSTONE_FLUSH", str(flush))
    rng = random.Random(101)
    more, _ = make_docs(tmp_path, doc_specs(rng, 3), prefix="m")
    w = _WORDS[:4]
    reqs = [{"id": 1, "op": "df", "terms": w, "min_generation": 2},
            {"id": 2, "op": "df", "terms": w, "min_generation": 3},
            {"id": 3, "op": "append", "files": more},
            {"id": 4, "op": "df", "terms": w, "min_generation": 3},
            {"id": 5, "op": "delete", "docs": [2, 11]},
            {"id": 6, "op": "delete", "docs": [2]},
            {"id": 7, "op": "postings", "terms": w},
            {"id": 8, "op": "delete", "docs": [999]},
            {"id": 9, "op": "append", "files": [str(tmp_path / "missing.txt")]},
            {"id": 10, "op": "delete", "docs": [20]},
            {"id": 11, "op": "compact", "force": False},
            {"id": 12, "op": "compact"},
            {"id": 13, "op": "and", "terms": w[:2]},
            {"id": 14, "op": "top_k", "score": "bm25", "k": 5, "terms": w[:3]},
            {"id": 15, "op": "top_k", "letter": "a", "k": 4},
            {"id": 16, "op": "snapshot"},
            {"id": 17, "op": "wal_tail", "after_seq": 0},
            {"id": 18, "op": "fetch_segment", "segment": "seg_1_0", "file": "index.mri"},
            {"id": 19, "op": "df", "terms": w, "min_generation": 99},
            {"id": 20, "op": "df", "terms": w, "min_generation": "x"}]
    (jgot, tgot), jdir, tdir = run_both(seg_built, tmp_path, reqs, engine="host")
    assert len(tgot) == len(jgot)
    for j, t in zip(jgot, tgot):
        assert t == j
    by_id = {r["id"]: r for r in tgot}
    assert by_id[2]["error"] == "stale_generation" and "error" not in by_id[4]
    assert by_id[8]["error"] == by_id[9]["error"] == "mutation_rejected"
    assert by_id[19]["error"] == "stale_generation"
    assert by_id[20]["error"] == "bad_request"
    assert by_id[6]["result"].get("newly_tombstoned", 0) == 0
    assert _tree(tdir) == _tree(jdir)


def test_mutations_on_a_replica_and_under_a_stolen_lease_match_jax(
        seg_built, tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SEGMENT_LEASE_TTL_S", "30")
    rng = random.Random(103)
    more, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix="l")
    reqs = [{"id": 1, "op": "delete", "docs": [1]},
            {"id": 2, "op": "append", "files": more},
            {"id": 3, "op": "df", "terms": _WORDS[:3]}]
    jdir, tdir = twin_dirs(seg_built, tmp_path)
    got = []
    for cls, d, f in ((JDaemon, jdir, jfaults), (ServeDaemon, tdir, faults)):
        with serving(cls, d, engine="host") as daemon, Client(daemon) as c:
            first = strip(c.rpc(**reqs[0]), d)
            f.install("lease-steal")
            f.begin_run()
            rest = [strip(c.rpc(**r), d) for r in reqs[1:]]
            f.install(None)
            got.append([first] + rest)
    assert got[1] == got[0]
    assert got[1][1]["error"] == "mutation_rejected"
    assert got[1][1]["detail"].startswith("lease_lost")
    # a replica is read-only: every mutation rejected, naming the primary
    rep = tmp_path / "replica"
    with serving(ServeDaemon, tdir, engine="host") as primary:
        addr = "%s:%d" % primary.address
        with serving(ServeDaemon, rep, engine="host", replica_of=addr) as r, \
                Client(r) as c:
            ans = c.rpc(id=1, op="delete", docs=[2])
    assert ans["error"] == "mutation_rejected"
    assert ans["detail"] == f"replica is read-only: mutations go to the primary at {addr}"


# -- startup recovery, drain flush, replica daemon ----------------------


def test_startup_recovery_replays_acked_records(seg_built, tmp_path):
    """Records acknowledged by a crashed daemon (logged, never
    published) are applied before the first engine opens — in the port
    as in the JAX package, to byte-equal directories."""
    jdir, tdir = twin_dirs(seg_built, tmp_path)
    for d, pkg in ((jdir, jsegments), (tdir, segments)):
        with pkg.mutation_lock(d):
            (jsegments.wal if pkg is jsegments else wal_mod).log_mutation(
                d, "delete", {"docs": [3, 12]})
    gens = []
    for cls, d in ((JDaemon, jdir), (ServeDaemon, tdir)):
        with serving(cls, d, engine="host") as daemon, Client(daemon) as c:
            gens.append((c.rpc(id=1, op="healthz")["generation"],
                         c.rpc(id=2, op="postings", terms=_WORDS[:6])["postings"]))
    assert gens[1] == gens[0] and gens[1][0] == 3
    assert _tree(tdir) == _tree(jdir)
    assert not wal_mod.wal_path(tdir).exists()


def test_replica_daemon_follows_the_primary(seg_built, tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_REPLICA_POLL_MS", "50")
    rng = random.Random(107)
    _, tdir = twin_dirs(seg_built, tmp_path)
    rep = tmp_path / "replica"
    with serving(ServeDaemon, tdir, engine="host") as primary, Client(primary) as pc:
        addr = "%s:%d" % primary.address
        with serving(ServeDaemon, rep, replica_of=addr) as r, Client(r) as rc:
            assert r._engine.engine_name == "multi"
            assert rc.rpc(id=1, op="healthz")["generation"] == 2
            more, _ = make_docs(tmp_path, doc_specs(rng, 3), prefix="r")
            ack = pc.rpc(id=2, op="append", files=more)
            gen = ack["result"]["generation"]
            deadline = time.monotonic() + 20
            while True:
                ans = rc.rpc(id=3, op="df", terms=_WORDS[:3], min_generation=gen)
                if "error" not in ans:
                    break
                assert ans["error"] == "stale_generation"
                assert time.monotonic() < deadline, "replica never converged"
                time.sleep(0.05)
            want = pc.rpc(id=4, op="df", terms=_WORDS[:3])
            assert ans["df"] == want["df"]
            h = rc.rpc(id=5, op="healthz")
            assert h["generation"] == gen and "replica_lagging" not in h["reasons"]
    def shipped(root):
        return {k: v for k, v in _tree(root).items() if k != "segments.lock"}
    assert shipped(rep) == shipped(tdir)


# -- the multi-segment and mutation cases of test_attrib ------------------

_SEG_VOCAB = _WORDS + ["qqabsent"]


def _drive(eng, attrib, rng, vocab, n) -> dict:
    sums = {}
    for _ in range(n):
        r = rng.random()
        terms = [vocab[rng.randrange(len(vocab))] for _ in range(rng.randrange(1, 4))]
        with attrib.collect() as coll:
            if r < 0.40:
                eng.top_k_scored(eng.encode_batch(terms), rng.choice((1, 5, 20)))
            elif r < 0.50:
                eng.top_k(rng.choice(_LETTERS), 5)
            elif r < 0.65:
                eng.query_and(eng.encode_batch(terms))
            elif r < 0.75:
                eng.query_or(eng.encode_batch(terms))
            elif r < 0.90:
                eng.df(eng.encode_batch(terms))
            else:
                eng.postings(eng.encode_batch(terms[:1]))
        for k, v in coll.totals().items():
            sums[k] = sums.get(k, 0) + v
    return sums


def test_attribution_parity_multi_segment(seg_built):
    """Per-request attribution totals equal the registry counters of the
    multi engine and its segment engines; the same requests give the
    JAX engine's totals, and per-segment children roll up."""
    eng = create_engine(str(seg_built), None)
    jeng = jcreate_engine(str(seg_built), None)
    try:
        assert type(eng).__name__ == "MultiSegmentEngine"
        regs = [eng.metrics] + [s.engine.metrics for s in eng._segs]
        base = _registry_totals(regs)
        sums = _drive(eng, obs_attrib, random.Random(11), _SEG_VOCAB, 4000)
        after = _registry_totals(regs)
        delta = {k: after[k] - base[k] for k in after}
        assert {k: sums.get(k, 0) for k in delta} == delta
        assert sums["bytes_decoded"] > 0 and sums["cache_hits"] > 0
        assert sums == _drive(jeng, jattrib, random.Random(11), _SEG_VOCAB, 4000)
        with obs_attrib.collect("top_k_scored") as coll:
            eng.top_k_scored(eng.encode_batch(_WORDS[:2]), 5)
        rep = coll.report()
        names = [s["segment"] for s in rep.get("segments", ())]
        assert len(names) == len(eng._segs) and len(set(names)) == 2
        for key in ("blocks_decoded", "bytes_decoded"):
            assert rep["totals"][key] == rep["engine"][key] + sum(
                s["totals"][key] for s in rep["segments"])
    finally:
        eng.close()
        jeng.close()


def test_daemon_explain_multi_segment_breakdown(seg_built, tmp_path):
    reqs = [{"id": 1, "op": "top_k", "score": "bm25", "k": 5,
             "terms": [_WORDS[0], _WORDS[1]], "explain": True},
            {"id": 2, "op": "and", "terms": [_WORDS[2], _WORDS[3]], "explain": True}]
    (jgot, tgot), _, _ = run_both(seg_built, tmp_path, reqs)
    assert tgot == jgot
    rep = tgot[0]["explain"]
    segs = rep.get("segments")
    assert segs and len(segs) == 2
    for key in ("blocks_decoded", "bytes_decoded"):
        assert rep["totals"][key] == rep["engine"][key] + sum(
            s["totals"][key] for s in segs)


def test_daemon_scrape_merges_three_registries_with_exemplars(seg_built, tmp_path):
    """Daemon registry + multi-engine registry + per-segment engine
    registries fold into ONE exposition, the JAX daemon's families."""
    fams = []
    for cls, d in zip((JDaemon, ServeDaemon), twin_dirs(seg_built, tmp_path)):
        with serving(cls, d) as daemon, Client(daemon) as c:
            assert c.rpc(id=1, op="top_k", score="bm25", k=3, terms=[_WORDS[0]])["ok"]
            text = c.rpc(id=2, op="metrics")["text"]
        f = [ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")]
        assert len(f) == len(set(f))
        assert "mri_generation" in f and "mri_segments_active" in f
        assert '# {trace_id="' in text
        fams.append(set(f))
    # families of each package's process-wide default registry (fed by
    # whatever ran before in this process) are left out of the comparison
    glob = set()
    for reg in (jmetrics.default_registry(), tmetrics.default_registry()):
        glob |= {ln.split()[2] for ln in reg.render_text().splitlines()
                 if ln.startswith("# TYPE ")}
    assert fams[1] - glob == fams[0] - glob


def test_mutation_trace_spans_carry_generation(tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SEGMENT_TOMBSTONE_FLUSH", "3")
    rng = random.Random(7)
    paths, _ = make_docs(tmp_path, doc_specs(rng, 4), prefix="m")
    idx = tmp_path / "idx"
    segments.append_files(idx, paths)
    more, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix="m2")
    views = []
    for cls, d in zip((JDaemon, ServeDaemon), twin_dirs(idx, tmp_path / "twins")):
        with serving(cls, d) as daemon, Client(daemon) as c:
            r = c.rpc(id=1, op="append", files=more)
            assert r["ok"]
            gen_append = r["result"]["generation"]
            r2 = c.rpc(id=2, op="delete", docs=[1])
            assert r2["ok"] and r2["result"]["buffered"]
            r3 = c.rpc(id=3, op="compact")
            assert r3["ok"]
            gen_compact = r3["result"]["generation"]
            traces = c.rpc(id=4, op="trace", n=32)["traces"]
        by_op = {}
        for t in traces:
            by_op.setdefault(t["op"], []).append(t)
        ap, dl, cp = by_op["append"][0], by_op["delete"][0], by_op["compact"][0]
        assert ap["generation"] == gen_append
        assert ap["spans"][0]["name"] == "append"
        assert ap["spans"][0]["generation"] == gen_append
        assert "generation" not in dl and "generation" not in dl["spans"][0]
        assert cp["generation"] == gen_compact
        assert cp["spans"][0]["generation"] == gen_compact
        views.append([(t["op"], t.get("generation"), t.get("status"))
                      for t in (ap, dl, cp)])
    assert views[1] == views[0]


def test_trace_ring_contiguity_under_concurrent_mutations(tmp_path, monkeypatch):
    """Query spans stay complete and contiguous while append/compact
    spans land in the same ring from another connection."""
    monkeypatch.setenv("MRI_OBS_TRACE_RING", "256")
    rng = random.Random(11)
    paths, _ = make_docs(tmp_path, doc_specs(rng, 6), prefix="c")
    idx = tmp_path / "idx"
    segments.append_files(idx, paths)
    batches = [make_docs(tmp_path, doc_specs(rng, 2), prefix=f"c{i}")[0] for i in range(3)]
    with serving(ServeDaemon, idx) as d:
        errs = []

        def mutator():
            try:
                with Client(d) as mc:
                    for i, files in enumerate(batches):
                        r = mc.rpc(id=100 + i, op="append", files=files)
                        assert r["ok"], r
                    assert mc.rpc(id=200, op="compact")["ok"]
            except Exception as e:  # surfaced on the main thread
                errs.append(e)

        mt = threading.Thread(target=mutator, name="test-mutator")
        mt.start()
        try:
            with Client(d) as qc:
                for i in range(60):
                    r = qc.rpc(id=i, op="and", terms=[_WORDS[0], _WORDS[1]],
                               trace_id=f"q{i:03d}")
                    assert r["ok"], r
        finally:
            mt.join(timeout=60.0)
        assert not errs
        with Client(d) as qc:
            traces = qc.rpc(op="trace", n=256)["traces"]
    qts = [t for t in traces if t["op"] == "and"]
    assert len(qts) >= 50
    engine_traces = 0
    for t in qts:
        names = [s["name"] for s in t["spans"]]
        if names == ["result_cache"]:
            assert t["spans"][0]["start_ms"] == 0.0
            continue
        engine_traces += 1
        assert names == ["queue_wait", "coalesce", "engine"]
        assert t["spans"][0]["start_ms"] == 0.0
        for a, b in zip(t["spans"], t["spans"][1:]):
            assert b["start_ms"] == pytest.approx(a["start_ms"] + a["dur_ms"], abs=2e-3)
    assert engine_traces >= 1
    mts = [t for t in traces if t["op"] in ("append", "compact")]
    assert len(mts) == 4
    for t in mts:
        assert isinstance(t["generation"], int)
        assert t["spans"][0]["generation"] == t["generation"]


# -- routing ---------------------------------------------------------------


@pytest.mark.parametrize("engine", [None, "host", "auto", "device"])
def test_daemon_engine_routing_on_a_live_dir(seg_built, tmp_path, engine):
    """No engine, host or auto: the daemon serves the multi-segment
    engine (``stats()["engine"]["engine"] == "multi"``); a named device
    refuses at construction with the JAX daemon's message."""
    jdir, tdir = twin_dirs(seg_built, tmp_path)
    if engine == "device":
        with pytest.raises(JArtifactError) as jerr:
            JDaemon(str(jdir), engine="device")
        with pytest.raises(ArtifactError) as terr:
            ServeDaemon(str(tdir), engine="device", device="cpu")
        assert str(terr.value) == str(jerr.value).replace(str(jdir), str(tdir))
        return
    with serving(ServeDaemon, tdir, engine=engine) as d, Client(d) as c:
        st = c.rpc(id=1, op="stats")["stats"]
    assert st["engine"]["engine"] == "multi" and st["engine"]["generation"] == 2


# -- the ranked result cache keeps the term order ---------------------------


def test_ranked_cache_hit_keeps_the_term_order(tmp_path):
    """BM25 adds contributions in the query's term order, so a
    permutation of the same words can score a document one ulp apart.
    The port's result cache keys ranked ``top_k`` on the term tuple as
    given, so every answer equals the engine's own for that order; the
    JAX daemon keys the sorted terms and answers the second order with
    the first one's bytes (ROADMAP §C)."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
        manifest as tman,
        synthetic as tsyn,
    )
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        Engine,
    )
    docs = tsyn.zipf_corpus(num_docs=40, vocab_size=300, tokens_per_doc=30, seed=3)
    tman.write_manifest(tmp_path / "l.txt", tsyn.write_corpus(tmp_path / "docs", docs))
    out = tmp_path / "out"
    assert cli.main(["1", "1", str(tmp_path / "l.txt"), "--backend", "cpu", "--artifact",
                     "--output-dir", str(out)]) == 0
    first, second = ["cegeuwpbc", "lqmg", "rta"], ["cegeuwpbc", "rta", "lqmg"]
    with Engine(out) as e:
        want = [[[d, s] for d, s in e.top_k_scored(e.encode_batch(q), 5)]
                for q in (first, second)]
    assert want[0] != want[1]  # the same words, another sum order
    got = {}
    for name, cls in (("jax", JDaemon), ("port", ServeDaemon)):
        with serving(cls, out, engine="host") as d, Client(d) as c:
            got[name] = [c.rpc(id=i, op="top_k", score="bm25", k=5, terms=q)["docs"]
                         for i, q in enumerate((first, second))]
    assert got["port"] == want
    assert got["jax"] == [want[0], want[0]]  # the JAX cache's hit


# -- an index.mri path names its directory --------------------------------


def test_daemon_on_an_index_mri_path_uses_its_directory(tmp_path):
    """``serve DIR`` takes the directory or its ``index.mri``.  The JAX
    daemon's startup recovery reads ``<file>/segments.manifest.json`` and
    refuses any file path; the port's segment layer works on the file's
    directory, so the artifact serves and a live append converts that
    directory, which ``create_engine`` then opens through either path
    (ROADMAP §C)."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
        manifest as tman,
    )
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.multi_engine import (
        MultiSegmentEngine,
    )
    rng = random.Random(113)
    paths, specs = make_docs(tmp_path, doc_specs(rng, 6), prefix="f")
    tman.write_manifest(tmp_path / "l.txt", paths)
    out = tmp_path / "out"
    assert cli.main(["1", "1", str(tmp_path / "l.txt"), "--backend", "cpu", "--artifact",
                     "--output-dir", str(out)]) == 0
    art = out / "index.mri"
    with pytest.raises(jsegments.SegmentError, match="Not a directory"):
        JDaemon(str(art), engine="host")
    more, _ = make_docs(tmp_path, doc_specs(rng, 2), prefix="g")
    term = specs[0][0]
    with serving(ServeDaemon, art, engine="host") as d, Client(d) as c:
        before = c.rpc(id=1, op="df", terms=[term])["df"]
        ack = c.rpc(id=2, op="append", files=more)
        assert ack["ok"] and ack["result"]["doc_ids"] == [7, 8]
        assert c.rpc(id=3, op="stats")["stats"]["engine"]["engine"] == "multi"
        after = c.rpc(id=4, op="df", terms=[term])["df"]
    assert before == [sum(term in w for w in specs)]
    assert after[0] >= before[0]
    assert segments.load_manifest(out).generation == 2
    for p in (out, art):
        with create_engine(str(p), "host") as e:
            assert type(e) is MultiSegmentEngine and e.df(e.encode_batch([term])).tolist() == after
