"""The port's doc-sharded cluster (``cluster/``) against the JAX package's
on the same seeded Zipf corpus, on the CPU (host code in both packages).

* partition — ``assign`` equals JAX's in both modes at D in {1, 2, 4, 8};
  both packages ``partition`` one list at D in {1, 2, 4} into cluster
  directories whose ``docs.list``, ``index.mri``, ``cluster_shard.json``
  and ``cluster.json`` are byte-equal; ``verify`` catches the same
  corruptions with the same messages;
* shard engine — the port's ``ShardEngine`` answers as JAX's, and its
  merged BM25 equals the monolith host ``Engine`` bit for bit;
* router — the port's router over the port's shard daemons answers as
  the JAX router over the JAX shard daemons and as the monolith (df,
  postings, AND/OR, BM25 floats, letter ``top_k`` with its threshold
  refinement, ``k`` spanning shards); each package's router serves the
  other package's shard daemons; ``trace_id`` and ``explain`` travel
  through; the admin surface has the JAX router's keys and families;
* the one logged disagreement: the router's result cache keeps the term
  order of a ranked query (the JAX router answers a permutation with the
  first order's bytes, ROADMAP §C);
* a shard daemon groups a same-k ranked burst through
  ``top_k_scored_batch``.

Daemon tests carry the ``daemon`` marker, so the conftest leak guard
checks that every router and shard daemon joined its threads and closed
its sockets at drain.
"""

import contextlib
import json
import random
import socket
import time
from pathlib import Path

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import (
    faults as jfaults,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cluster import (
    partition as jpart,
    shard as jshard,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cluster.router import (
    RouterDaemon as JRouter,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.daemon import (
    ServeDaemon as JDaemon,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
    cli as tcli,
    faults as tfaults,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cluster import (
    partition as tpart,
    shard as tshard,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cluster.router import (
    RouterDaemon as TRouter,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    Engine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
    ServeDaemon as TDaemon,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.multi_engine import (
    merge_ranked,
)

pytestmark = [pytest.mark.cluster, pytest.mark.serve]

daemonized = pytest.mark.daemon

#: the JAX cluster suite's corpus, generated by the port (same bytes)
DOCS = tsyn.zipf_corpus(num_docs=48, vocab_size=600, tokens_per_doc=60, seed=23)

#: the daemon and router class of each package
PKGS = {"jax": (JDaemon, JRouter), "port": (TDaemon, TRouter)}


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.install(None)
    tfaults.install(None)
    yield
    jfaults.install(None)
    tfaults.install(None)


def write_list(root: Path, docs) -> Path:
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    return root / "list.txt"


def build_mono(root: Path, src: Path) -> Path:
    """The monolith: the host backend's ``--artifact`` build of ``src``
    with a shard build's argv (one mapper, two reducers)."""
    out = root / "mono"
    assert tcli.main(["1", "2", str(src), "--backend", "cpu", "--artifact",
                      "--output-dir", str(out)]) == 0
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The corpus list, its monolith, and both packages' cluster
    directories at D in {1, 2, 4}: ``(src, mono, {D: (jax, port)})``."""
    root = tmp_path_factory.mktemp("tcluster")
    src = write_list(root, DOCS)
    dirs = {}
    for d in (1, 2, 4):
        pair = (root / f"jax_d{d}", root / f"port_d{d}")
        jpart.partition(src, d, pair[0])
        tpart.partition(src, d, pair[1])
        dirs[d] = pair
    return src, build_mono(root, src), dirs


@pytest.fixture(scope="module")
def vocab():
    words = sorted({w.decode() for doc in DOCS for w in doc.split()})
    assert len(words) > 100
    return words


@contextlib.contextmanager
def cluster_up(cl_dir, shards, *, replicas=1, daemon_cls=TDaemon, router_cls=TRouter,
               **router_kw):
    """Start ``replicas`` shard daemons of ``daemon_cls`` per shard over
    ``cl_dir`` and a router of ``router_cls`` over them; yields
    ``(router, daemons)`` and drains everything on the way out."""
    daemons = []
    addrs = []
    try:
        for s in range(shards):
            reps = []
            for _ in range(replicas):
                d = daemon_cls(str(Path(cl_dir) / f"shard-{s}"), engine="host",
                               coalesce_us=100)
                d.start()
                daemons.append(d)
                reps.append(d.address)
            addrs.append(reps)
        router_kw.setdefault("hedge_ms", 0.0)
        router_kw.setdefault("health_ms", 100)
        router = router_cls(addrs, "127.0.0.1", 0, **router_kw)
        router.start()
        try:
            yield router, daemons
        finally:
            router.drain()
    finally:
        for d in daemons:
            with contextlib.suppress(Exception):
                d.drain()


class Client:
    def __init__(self, target, timeout=15.0):
        addr = target.address if hasattr(target, "address") else target
        self.sock = socket.create_connection(addr, timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.f = self.sock.makefile("rb")

    def send(self, **obj):
        self.sock.sendall((json.dumps(obj) + "\n").encode())

    def recv(self):
        line = self.f.readline()
        assert line, "connection closed unexpectedly"
        return json.loads(line)

    def rpc(self, **obj):
        self.send(**obj)
        return self.recv()

    def close(self):
        with contextlib.suppress(OSError):
            self.f.close()
        with contextlib.suppress(OSError):
            self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def mono_answers(eng, req: dict):
    """The monolith host engine's answer to one data request, in the
    wire's shape."""
    op = req["op"]
    if op == "top_k" and req.get("letter") is not None:
        return [[t.decode("ascii"), int(df)] for t, df in eng.top_k(req["letter"], req["k"])]
    batch = eng.encode_batch(req["terms"])
    if op == "df":
        return eng.df(batch).tolist()
    if op == "postings":
        return [None if p is None else p.tolist() for p in eng.postings(batch)]
    if op == "and":
        return eng.query_and(batch).tolist()
    if op == "or":
        return eng.query_or(batch).tolist()
    return [[d, s] for d, s in eng.top_k_scored(batch, req["k"])]


def no_trace(resp: dict) -> dict:
    """A response without its (generated) ``trace_id``."""
    return {k: v for k, v in resp.items() if k != "trace_id"}


def answer_of(resp: dict):
    assert resp.get("ok"), resp
    for key in ("df", "postings", "docs", "top"):
        if key in resp:
            return resp[key]
    raise AssertionError(resp)


def fuzz_requests(vocab, seed: int, n: int = 25) -> list[dict]:
    """Every data op on random term sets (BM25 ``k`` up to 12), then a
    letter ``top_k`` per letter of ``abcdefg``."""
    rng = random.Random(seed)
    reqs = []
    for _ in range(n):
        terms = rng.sample(vocab, rng.randint(1, 4))
        for op in ("df", "postings", "and", "or"):
            reqs.append({"op": op, "terms": terms})
        reqs.append({"op": "top_k", "terms": terms, "k": rng.randint(1, 12), "score": "bm25"})
    reqs += [{"op": "top_k", "letter": ch, "k": 5} for ch in "abcdefg"]
    return [dict(r, id=i) for i, r in enumerate(reqs)]


# -- partition ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["round-robin", "size-balanced"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_assign_matches_jax(built, mode, d):
    src, _, _ = built
    paths = list(tman.read_manifest(str(src)).paths)
    got = tpart.assign(paths, d, mode)
    assert got == jpart.assign(paths, d, mode)
    assert sorted(g for m in got for g in m) == list(range(1, len(paths) + 1))
    assert all(m == sorted(m) for m in got)


def test_assign_refusals_match_jax(built):
    src, _, _ = built
    paths = list(tman.read_manifest(str(src)).paths)
    for args in ((paths, 0), (paths, len(paths) + 1), (paths, 1, "nope"), ([], 1)):
        with pytest.raises(tpart.PartitionError) as te:
            tpart.assign(*args)
        with pytest.raises(jpart.PartitionError) as je:
            jpart.assign(*args)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_partition_byte_equal_to_jax(built, d):
    src, mono, dirs = built
    jdir, tdir = dirs[d]
    assert (tdir / "cluster.json").read_bytes() == (jdir / "cluster.json").read_bytes()
    cluster = json.loads((tdir / "cluster.json").read_text())
    assert cluster["shards"] == d and cluster["total_docs"] == len(DOCS)
    for s in range(d):
        for name in ("docs.list", "index.mri", "cluster_shard.json"):
            assert (tdir / f"shard-{s}" / name).read_bytes() == \
                (jdir / f"shard-{s}" / name).read_bytes(), (s, name)
    # the global stats every shard scores with are the monolith's, bit-equal
    with Engine(mono) as eng:
        _, ndocs, avgdl = eng._bm25_corpus()
    for s in range(d):
        side = json.loads((tdir / f"shard-{s}" / "cluster_shard.json").read_text())
        assert (side["ndocs"], side["avgdl"]) == (ndocs, avgdl)
    assert tpart.verify(src, tdir) == jpart.verify(src, jdir) == {
        "shards": d, "docs": len(DOCS), "mode": "round-robin", "verified": True}


def _corrupt(root: Path, how: str) -> None:
    if how == "docs_list":
        p = root / "shard-1" / "docs.list"
        b = bytearray(p.read_bytes())
        b[-2] ^= 1
        p.write_bytes(bytes(b))
    elif how == "gids":
        p = root / "shard-0" / "cluster_shard.json"
        side = json.loads(p.read_text())
        side["gids"] = side["gids"][:-1]
        p.write_text(json.dumps(side))
    elif how == "no_manifest":
        (root / "cluster.json").unlink()
    elif how == "no_sidecar":
        (root / "shard-1" / "cluster_shard.json").unlink()


@pytest.mark.parametrize("how", ["docs_list", "gids", "no_manifest", "no_sidecar"])
def test_verify_catches_corruption_as_jax(built, tmp_path, how):
    src, _, dirs = built
    msgs = []
    for name, part, root in (("jax", jpart, dirs[2][0]), ("port", tpart, dirs[2][1])):
        copy = tmp_path / name
        for f in root.rglob("*"):
            if f.is_file():
                dst = copy / f.relative_to(root)
                dst.parent.mkdir(parents=True, exist_ok=True)
                dst.write_bytes(f.read_bytes())
        _corrupt(copy, how)
        with pytest.raises(part.PartitionError) as e:
            part.verify(src, copy)
        msgs.append(str(e.value).replace(str(copy), "CL"))
    assert msgs[0] == msgs[1]
    assert {"docs_list": "shard 1: docs.list does not byte-match",
            "gids": "shard 0: sidecar gid map drifted",
            "no_manifest": "CL: cannot read cluster.json",
            "no_sidecar": "shard 1: bad sidecar"}[how] in msgs[1]


def test_shard_cli_matches_jax(built, tmp_path, capsys):
    """The ``shard`` subcommand's JSON event lines equal the JAX CLI's
    (paths aside), and ``--verify-only`` over a flipped ``docs.list``
    exits 2 naming the shard."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli
    src, _, _ = built
    outs = []
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        cl = tmp_path / name
        assert main(["shard", str(src), "--shards", "2", "--out", str(cl),
                     "--mode", "size-balanced", "--verify"]) == 0
        outs.append(capsys.readouterr().out)
        _corrupt(cl, "docs_list")
        assert main(["shard", str(src), "--out", str(cl), "--shards", "2",
                     "--verify-only"]) == 2
        outs.append(capsys.readouterr().err)
    assert outs[2] == outs[0] and outs[3] == outs[1]
    lines = [json.loads(x) for x in outs[2].splitlines()]
    assert [x["event"] for x in lines] == ["progress", "progress", "partitioned", "verified"]
    assert lines[2]["mode"] == "size-balanced" and lines[3]["verified"] is True
    assert outs[3] == "error: shard 1: docs.list does not byte-match the recomputed " \
        "assignment (corrupt or hand-edited)\n"


# -- shard engine ------------------------------------------------------------


def test_shard_engine_matches_jax_and_monolith(built, vocab):
    """Each of the 4 shards' engines answers as JAX's (global doc ids,
    local df and letter top-k, the ``cluster`` block); the ranked answers
    of the 4 merged equal the monolith's, BM25 floats bit for bit."""
    _, mono, dirs = built
    jdir, tdir = dirs[4]
    rng = random.Random(7)
    queries = [rng.sample(vocab, rng.randint(1, 4)) for _ in range(20)]
    tengs = [tshard.ShardEngine(tdir / f"shard-{s}") for s in range(4)]
    jengs = [jshard.ShardEngine(str(jdir / f"shard-{s}")) for s in range(4)]
    try:
        for te, je in zip(tengs, jengs):
            assert te.describe()["cluster"] == je.describe()["cluster"]
            assert te.describe()["engine"] == "shard"
            assert te.bm25_stats() == je.bm25_stats()
            for q in queries:
                tb, jb = te.encode_batch(q), je.encode_batch(q)
                assert te.df(tb).tolist() == je.df(jb).tolist()
                assert [None if p is None else p.tolist() for p in te.postings(tb)] == \
                    [None if p is None else p.tolist() for p in je.postings(jb)]
                assert te.query_and(tb).tolist() == je.query_and(jb).tolist()
                assert te.query_or(tb).tolist() == je.query_or(jb).tolist()
                assert te.top_k_scored(tb, 6) == je.top_k_scored(jb, 6)
            batches = [te.encode_batch(q) for q in queries]
            assert te.top_k_scored_batch(batches, 5) == \
                je.top_k_scored_batch([je.encode_batch(q) for q in queries], 5)
            assert te.top_k("c", 5) == je.top_k("c", 5)
        with Engine(mono) as eng:
            for q in queries:
                for k in (1, 5, len(DOCS)):
                    parts = [[(-s, d) for d, s in e.top_k_scored(e.encode_batch(q), k)]
                             for e in tengs]
                    assert merge_ranked(parts, k) == eng.top_k_scored(eng.encode_batch(q), k)
    finally:
        for e in tengs + jengs:
            e.close()


def test_shard_engine_refusals_match_jax(built, tmp_path):
    """A malformed sidecar, a gid map that is not ascending and a map
    shorter than the artifact raise ``ArtifactError`` with JAX's words
    (the rebuild hint names this package's CLI)."""
    _, _, dirs = built
    src_shard = dirs[2][1] / "shard-0"
    side = json.loads((src_shard / "cluster_shard.json").read_text())
    cases = {"malformed": {k: v for k, v in side.items() if k != "avgdl"},
             "descending": dict(side, gids=side["gids"][::-1]),
             "short": dict(side, gids=side["gids"][:3])}
    for name, doc in cases.items():
        d = tmp_path / name
        d.mkdir()
        (d / "index.mri").write_bytes((src_shard / "index.mri").read_bytes())
        (d / "cluster_shard.json").write_text(json.dumps(doc))
        with pytest.raises(Exception) as te:
            tshard.ShardEngine(d)
        with pytest.raises(Exception) as je:
            jshard.ShardEngine(str(d))
        assert type(te.value).__name__ == type(je.value).__name__ == "ArtifactError"
        assert str(te.value) == str(je.value).replace("(mri shard)", "(mri-torch shard)"), name


# -- router ------------------------------------------------------------------


@daemonized
@pytest.mark.parametrize("d", [1, 2, 4])
def test_router_matches_jax_and_monolith_fuzz(built, vocab, d):
    """Every data op through the port's router over D port shard daemons
    equals the JAX router over D JAX shard daemons and the monolith host
    engine, BM25 floats included."""
    _, mono, dirs = built
    reqs = fuzz_requests(vocab, 100 + d)
    got = {}
    for name, cl in (("jax", dirs[d][0]), ("port", dirs[d][1])):
        dcls, rcls = PKGS[name]
        with cluster_up(cl, d, daemon_cls=dcls, router_cls=rcls) as (router, _), \
                Client(router) as c:
            got[name] = [no_trace(c.rpc(**r)) for r in reqs]
    with Engine(mono) as eng:
        want = [mono_answers(eng, r) for r in reqs]
    assert [answer_of(r) for r in got["port"]] == want
    assert got["port"] == got["jax"]
    assert any(w for w in want[-7:])  # the letter rounds found terms


@daemonized
def test_router_ranked_k_spans_shards(built, vocab):
    """``k`` past the corpus: every shard contributes everything and the
    heap merge returns the whole global ranking."""
    _, mono, dirs = built
    terms = sorted(vocab, key=lambda w: -sum(w.encode() in d.split() for d in DOCS))[:3]
    with Engine(mono) as eng:
        want = [[d, s] for d, s in eng.top_k_scored(eng.encode_batch(terms), len(DOCS))]
    with cluster_up(dirs[4][1], 4) as (router, _), Client(router) as c:
        r = c.rpc(id=1, op="top_k", terms=terms, k=len(DOCS), score="bm25")
    assert r["docs"] == want and len(want) > len(DOCS) // 2


@daemonized
@pytest.mark.parametrize("router_pkg", ["jax", "port"])
def test_router_serves_the_other_packages_shards(built, vocab, router_pkg):
    """The port's router over the JAX package's shard daemons, and the
    JAX router over the port's, answer as the monolith."""
    _, mono, dirs = built
    shard_pkg = "port" if router_pkg == "jax" else "jax"
    cl = dirs[2][0 if shard_pkg == "jax" else 1]
    reqs = fuzz_requests(vocab, 31, n=10)
    with cluster_up(cl, 2, daemon_cls=PKGS[shard_pkg][0],
                    router_cls=PKGS[router_pkg][1]) as (router, _), Client(router) as c:
        got = [answer_of(c.rpc(**r)) for r in reqs]
    with Engine(mono) as eng:
        assert got == [mono_answers(eng, r) for r in reqs]


def _families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")}


@daemonized
def test_router_trace_id_and_admin_surface_match_jax(built, vocab):
    """``trace_id`` is echoed and ``explain`` carries ``router`` and
    ``per_shard``; ``healthz`` is JAX's, ``stats`` has its keys (and
    ``stats.cluster`` its keys), the scrape has the JAX router's families
    with per-shard labelled rows, ``slo`` its objectives, and a
    shard-local admin op is a ``bad_request`` naming the shard primary."""
    _, _, dirs = built
    seen = {}
    for name in ("jax", "port"):
        dcls, rcls = PKGS[name]
        cl = dirs[2][0 if name == "jax" else 1]
        with cluster_up(cl, 2, daemon_cls=dcls, router_cls=rcls) as (router, _), \
                Client(router) as c:
            r1 = c.rpc(id=1, op="df", terms=[vocab[3]], trace_id="cafe01")
            r2 = c.rpc(id=2, op="top_k", terms=[vocab[3]], k=3, score="bm25", explain=True)
            healthz = c.rpc(id=3, op="healthz")
            # a writer counts a response just after its send: wait for the
            # three answers so far, so both stats answers see one tally
            deadline = time.monotonic() + 10
            while router._counts["responses"].value < 3:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            seen[name] = {
                "trace": (r1["trace_id"], r1["id"]),
                "explain": (sorted(r2["explain"]), r2["explain"]["router"]["shards"],
                            sorted(r2["explain"]["per_shard"])),
                "healthz": healthz,
                "stats": c.rpc(id=4, op="stats")["stats"],
                "metrics": c.rpc(id=5, op="metrics")["text"],
                "slo": c.rpc(id=6, op="slo")["slo"],
                "reload": c.rpc(id=7, op="reload"),
            }
    j, t = seen["jax"], seen["port"]
    assert t["trace"] == j["trace"] == ("cafe01", 1)
    assert t["explain"] == j["explain"] == (["per_shard", "router"], 2, ["0", "1"])
    assert t["healthz"] == j["healthz"] and t["healthz"]["ready"]
    assert set(t["stats"]) == set(j["stats"])
    assert set(t["stats"]["cluster"]) == set(j["stats"]["cluster"])
    assert t["stats"]["counters"] == j["stats"]["counters"]
    assert [set(sh) for sh in t["stats"]["cluster"]["shards"]] == \
        [set(sh) for sh in j["stats"]["cluster"]["shards"]]
    assert t["stats"]["cluster"]["docs"] == j["stats"]["cluster"]["docs"] == \
        {"per_shard": [24, 24], "total": len(DOCS)}
    router_families = {f for f in _families(j["metrics"])
                       if f.startswith(("mri_cluster_", "mri_router_", "mri_serve_"))}
    assert router_families and router_families <= _families(t["metrics"])
    assert "mri_cluster_shards 2" in t["metrics"]
    assert 'shard="0"' in t["metrics"] and 'shard="1"' in t["metrics"]
    assert set(t["slo"]) == set(j["slo"]) == {"availability", "latency"}
    assert t["reload"] == j["reload"] and t["reload"]["error"] == "bad_request"


# -- the ranked result cache keeps the term order ----------------------------


@daemonized
def test_router_cache_keeps_the_term_order(tmp_path):
    """BM25 adds contributions in the query's term order, so two orders
    of the same words can score a document one ulp apart.  The port's
    router caches a ranked ``top_k`` under the terms as given (a key of
    the sorted terms would answer the second order with the first's
    bytes, and this test would fail); the JAX router does just that
    (ROADMAP §C)."""
    docs = tsyn.zipf_corpus(num_docs=40, vocab_size=300, tokens_per_doc=30, seed=3)
    src = write_list(tmp_path, docs)
    mono = build_mono(tmp_path, src)
    first, second = ["cegeuwpbc", "lqmg", "rta"], ["cegeuwpbc", "rta", "lqmg"]
    with Engine(mono) as e:
        want = [[[d, s] for d, s in e.top_k_scored(e.encode_batch(q), 5)]
                for q in (first, second)]
    assert want[0] != want[1]  # the same words, another sum order
    got = {}
    for name, part in (("jax", jpart), ("port", tpart)):
        part.partition(src, 2, tmp_path / name)
        dcls, rcls = PKGS[name]
        with cluster_up(tmp_path / name, 2, daemon_cls=dcls, router_cls=rcls) as (router, _), \
                Client(router) as c:
            got[name] = [c.rpc(id=i, op="top_k", score="bm25", k=5, terms=q)["docs"]
                         for i, q in enumerate((first, second))]
            hits = router.stats()["result_cache"]
        got[name + "_hits"] = hits["hits"]
    assert got["port"] == want and got["port_hits"] == 0
    assert got["jax"] == [want[0], want[0]] and got["jax_hits"] == 1  # the JAX cache's hit


# -- shard daemons group the router's same-k ranked bursts -------------------


@daemonized
def test_shard_daemon_groups_same_k_ranked_burst(built, vocab, monkeypatch):
    """A pipelined burst of same-k BM25 queries on a shard daemon runs
    through ``ShardEngine.top_k_scored_batch`` in groups, with the solo
    path's answers."""
    _, _, dirs = built
    shard = dirs[2][1] / "shard-0"
    groups = []
    real = tshard.ShardEngine.top_k_scored_batch

    def counting(self, batches, k):
        groups.append(len(batches))
        return real(self, batches, k)

    with tshard.ShardEngine(shard) as eng:
        want = {t: [[d, s] for d, s in eng.top_k_scored(eng.encode_batch([t]), 4)]
                for t in vocab[:12]}
    monkeypatch.setattr(tshard.ShardEngine, "top_k_scored_batch", counting)
    daemon = TDaemon(str(shard), engine="host", coalesce_us=20000)
    daemon.start()
    try:
        with Client(daemon) as c:
            c.sock.sendall(b"".join(
                (json.dumps({"id": i, "op": "top_k", "terms": [t], "k": 4,
                             "score": "bm25"}) + "\n").encode()
                for i, t in enumerate(vocab[:12])))
            got = {r["id"]: r["docs"] for r in (c.recv() for _ in range(12))}
    finally:
        daemon.drain()
    assert got == {i: want[t] for i, t in enumerate(vocab[:12])}
    assert groups and max(groups) >= 2 and sum(groups) <= 12
