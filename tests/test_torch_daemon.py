"""The port's resident ``ServeDaemon`` against the JAX package's, request
line for request line, on the same seeded corpus (both packages build
its ``index.mri``; the two files are byte-equal).

Each test starts one JAX daemon and one port daemon over the same engine
kind — ``host`` on both, or the port's ``DeviceEngine`` on the CPU
against the JAX ``DeviceEngine`` on its 8 virtual devices — sends them
the same lines and compares the answers key by key.  Dropped before the
comparison, because they hold timings or ids: ``trace_id``, the
explain report's ``stages_us``, the ``stats`` blocks ``engine`` (the
engines' ``describe()``, compared elsewhere), ``rolling`` and ``slo``
(windowed by the sampler's clock) and each tenant's ``p95_ms`` and
``burn_1m``, and the trace ring's durations.  BM25 scores of the two
device engines agree within rel 1e-4 (float32 on both, summed in other
orders); everything else is equal.  Answers are also held against the
brute-force ``naive_index``.  Every test is ``daemon``-marked, so the
conftest leak guard checks that each drain joined every thread and
closed every socket.
"""

import contextlib
import json
import math
import socket
import time
from pathlib import Path

import pytest
import torch

from test_serve import naive_index

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import (
    cli as jcli,
    faults as jfaults,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.daemon import (
    ServeDaemon as JDaemon,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
    cli as tcli,
    faults as tfaults,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models.inverted_index import (
    DeviceUnavailable,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
    ServeDaemon as TDaemon,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    daemon as tdaemon_mod,
)

pytestmark = [pytest.mark.daemon, pytest.mark.serve]

#: a seeded Zipf corpus plus the JAX daemon suite's five documents
DOCS = tsyn.zipf_corpus(num_docs=240, vocab_size=1200, tokens_per_doc=40, seed=11) + [
    b"the cat sat on the mat", b"the dog ran far", b"cat and dog nap",
    b"a quiet zebra naps", b"dog dog dog barks the most"]

#: constructor arguments per engine kind: (JAX daemon, port daemon)
ENGINES = {"host": ({"engine": "host"}, {"engine": "host"}),
           "device": ({"engine": "device"}, {"engine": "device", "device": "cpu"})}
PLANNERS = ("exhaustive", "bmw", "maxscore", "auto")


def build_pair(root: Path):
    """The corpus built by both packages with ``--artifact``: (JAX dir,
    port dir), their ``index.mri`` files byte-equal."""
    paths = tsyn.write_corpus(root / "docs", DOCS)
    tman.write_manifest(root / "list.txt", paths)
    lst = str(root / "list.txt")
    assert jcli.main(["1", "1", lst, "--backend", "tpu", "--device-shards", "1",
                      "--artifact", "--output-dir", str(root / "jax")]) == 0
    assert tcli.main(["1", "1", lst, "--device", "cpu", "--artifact",
                      "--output-dir", str(root / "port")]) == 0
    assert (root / "jax" / "index.mri").read_bytes() == (root / "port" / "index.mri").read_bytes()
    return root / "jax", root / "port"


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    jdir, tdir = build_pair(tmp_path_factory.mktemp("torch_daemon"))
    return jdir, tdir, naive_index(DOCS)


@pytest.fixture(autouse=True)
def _disarm():
    """Each package's injector is process-global: disarmed around every
    test, both of them."""
    jfaults.install(None)
    tfaults.install(None)
    yield
    jfaults.install(None)
    tfaults.install(None)


@contextlib.contextmanager
def serving(cls, out, **kw):
    kw.setdefault("coalesce_us", 100)
    daemon = cls(str(out), **kw)
    daemon.start()
    try:
        yield daemon
    finally:
        daemon.drain()


@contextlib.contextmanager
def pair(built, kind, **kw):
    """A JAX daemon and a port daemon over the same engine kind."""
    jdir, tdir, _ = built
    jkw, tkw = ENGINES[kind]
    with serving(JDaemon, jdir, **jkw, **kw) as jd, serving(TDaemon, tdir, **tkw, **kw) as td:
        yield jd, td


class Client:
    """One protocol connection: line-at-a-time JSON."""

    def __init__(self, daemon, timeout=15.0):
        self.sock = socket.create_connection(daemon.address, timeout=timeout)
        self.f = self.sock.makefile("rb")

    def send(self, **obj):
        self.sock.sendall((json.dumps(obj) + "\n").encode())

    def send_raw(self, data: bytes):
        self.sock.sendall(data)

    def recv(self):
        line = self.f.readline()
        assert line, "server closed the connection unexpectedly"
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


def strip(resp: dict) -> dict:
    """A response without the keys that hold ids or timings."""
    resp = dict(resp)
    resp.pop("trace_id", None)
    if isinstance(resp.get("explain"), dict):
        resp["explain"] = {k: v for k, v in resp["explain"].items() if k != "stages_us"}
    return resp


def same_docs(got, want, rel: float) -> bool:
    """BM25 ``docs`` lists: equal ids, scores within ``rel``."""
    return [d for d, _ in got] == [d for d, _ in want] and all(
        math.isclose(a, b, rel_tol=rel) for (_, a), (_, b) in zip(got, want))


def exchange(daemon, requests) -> list[dict]:
    with Client(daemon) as c:
        return [c.rpc(**r) for r in requests]


def assert_same(jgot, tgot, kind):
    """Response lists equal but for ids/timings; device BM25 scores
    within rel 1e-4."""
    assert len(jgot) == len(tgot)
    for j, t in zip(jgot, tgot):
        j, t = strip(j), strip(t)
        if kind == "device" and "docs" in j and j["docs"] and isinstance(j["docs"][0], list):
            assert same_docs(t.pop("docs"), j.pop("docs"), 1e-4), (j, t)
        assert t == j


def data_requests(naive) -> list[dict]:
    vocab = sorted(naive)
    hot = sorted(naive, key=lambda w: -len(naive[w]))[:6]
    reqs = [{"id": 1, "op": "df", "terms": vocab[:300] + ["nosuchword"]},
            {"id": 2, "op": "postings", "terms": vocab[::7] + ["zzzz"]},
            {"id": 3, "op": "and", "terms": hot[:2]},
            {"id": 4, "op": "and", "terms": hot[1:4]},
            {"id": 5, "op": "or", "terms": [hot[4], "zebra", "nosuchword"]},
            {"id": 6, "op": "and", "terms": ["cat", "nosuchword"]}]
    letters = sorted({w[0] for w in vocab})
    reqs += [{"id": 10 + i, "op": "top_k", "letter": ch, "k": 5} for i, ch in enumerate(letters)]
    return reqs


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_data_ops_match_jax_and_oracle(built, kind):
    _, _, naive = built
    reqs = data_requests(naive)
    with pair(built, kind) as (jd, td):
        jgot, tgot = exchange(jd, reqs), exchange(td, reqs)
    assert_same(jgot, tgot, kind)
    by_id = {r["id"]: r for r in tgot}
    assert by_id[1]["df"] == [len(naive.get(t, [])) for t in reqs[0]["terms"]]
    assert by_id[2]["postings"] == [naive.get(t) for t in reqs[1]["terms"]]
    a, b = reqs[2]["terms"]
    assert by_id[3]["docs"] == sorted(set(naive[a]) & set(naive[b]))
    terms = reqs[4]["terms"]
    assert by_id[5]["docs"] == sorted(set().union(*(naive.get(t, []) for t in terms)))
    assert by_id[6]["docs"] == []
    for r in reqs[6:]:
        want = sorted((w for w in naive if w[0] == r["letter"]),
                      key=lambda w: (-len(naive[w]), w))[:5]
        assert [t for t, _ in by_id[r["id"]]["top"]] == want


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_bm25_top_k_per_planner_matches_jax(built, kind, monkeypatch):
    """Each planner in turn on one pair of daemons: the planner reads
    ``MRI_SERVE_PLANNER`` at every call, in both packages."""
    _, _, naive = built
    hot = sorted(naive, key=lambda w: -len(naive[w]))
    queries = [hot[:3], hot[2:4] + ["zebra"], [hot[10], hot[10], hot[40]], ["nosuchword"],
               [hot[0]]]
    reqs = [{"id": i, "op": "top_k", "score": "bm25", "k": k, "terms": q}
            for i, (q, k) in enumerate(zip(queries, (10, 3, 7, 5, 1)))]
    with pair(built, kind, coalesce_us=0) as (jd, td):
        for planner in PLANNERS:
            monkeypatch.setenv("MRI_SERVE_PLANNER", planner)
            # a fresh k per planner: no answer comes from the result cache
            asked = [dict(r, k=r["k"] + 20 * PLANNERS.index(planner)) for r in reqs]
            jgot, tgot = exchange(jd, asked), exchange(td, asked)
            assert_same(jgot, tgot, kind)
            for r, q in zip(tgot, queries):
                hits = set().union(*(naive.get(t, []) for t in q))
                assert {d for d, _ in r["docs"]} <= hits
        mode = [d.stats()["engine"]["planner"] for d in (jd, td)]
    assert mode[1]["ranked"] == mode[0]["ranked"]


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_explain_reports_match_jax(built, kind):
    _, _, naive = built
    hot = sorted(naive, key=lambda w: -len(naive[w]))
    reqs = [{"id": 1, "op": "df", "terms": hot[:4] + ["nosuchword"], "explain": True},
            {"id": 2, "op": "postings", "terms": hot[3:6], "explain": True},
            {"id": 3, "op": "and", "terms": hot[:2], "explain": True},
            {"id": 4, "op": "or", "terms": hot[5:8], "explain": True},
            {"id": 5, "op": "top_k", "score": "bm25", "k": 5, "terms": hot[:3], "explain": True},
            {"id": 6, "op": "top_k", "score": "bm25", "k": 5, "terms": hot[:3], "explain": True}]
    with pair(built, kind) as (jd, td):
        jgot, tgot = exchange(jd, reqs), exchange(td, reqs)
        # a request enters the flight ring just after its answer is queued
        for d in (jd, td):
            deadline = time.monotonic() + 10
            while len(d.flight) < len(reqs):
                assert time.monotonic() < deadline
                time.sleep(0.005)
        jflight, tflight = (exchange(d, [{"id": 9, "op": "flightdump"}])[0] for d in (jd, td))
    assert_same(jgot, tgot, kind)
    for r in tgot:
        rep = r["explain"]
        assert set(rep["stages_us"]) == {"queue", "coalesce", "engine"}
        paths = {t["path"] for t in rep["terms"]}
        assert paths == {"device"} if kind == "device" else "device" not in paths
    if kind == "device":
        assert tgot[4]["explain"]["totals"]["blocks_decoded"] > 0
    # the flight recorder holds the explain reports, newest first
    t_reqs, j_reqs = tflight["flight"]["requests"], jflight["flight"]["requests"]
    assert [e["trace"]["id"] for e in t_reqs] == [e["trace"]["id"] for e in j_reqs]
    assert all(e["report"] is not None for e in t_reqs)
    assert tflight["flight"]["capacity"] == jflight["flight"]["capacity"]


def _counter_lines(text: str) -> dict:
    return {line.split()[0]: line.split()[1] for line in text.splitlines()
            if line and not line.startswith("#") and "{" not in line}


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_admin_ops_match_jax(built, kind, monkeypatch):
    _, _, naive = built
    # the watchdog's stall family appears on a daemon's first stall only:
    # a threshold no run reaches keeps a slow first compile on a loaded
    # machine from adding it to one scrape and not the other
    monkeypatch.setenv("MRI_OBS_STALL_MS", "600000")
    reqs = data_requests(naive)[:6] + [{"id": 50, "op": "df", "terms": "notalist"},
                                       {"id": 51, "op": "nosuchop"}]
    admin = [{"id": 90, "op": "healthz"}, {"id": 91, "op": "stats"},
             {"id": 92, "op": "trace", "n": 4}, {"id": 93, "op": "metrics"},
             {"id": 94, "op": "slo"}]
    with pair(built, kind) as (jd, td):
        out = {}
        for name, d in (("jax", jd), ("port", td)):
            with Client(d) as c:
                for r in reqs:
                    c.rpc(**r)
                c.send_raw(b"this is not json\n")
                c.recv()
                # a trace enters the ring just after its answer is queued
                deadline = time.monotonic() + 10
                while len(d._trace_ring) < 6:
                    assert time.monotonic() < deadline
                    time.sleep(0.005)
                out[name] = []
                for r in admin:
                    # a writer counts a response just after its send: wait
                    # for every answer so far to be counted, so each
                    # admin answer sees the same tally on both daemons
                    _settle(d, len(reqs) + 1 + len(out[name]))
                    out[name].append(c.rpc(**r))
        jh, js, jt, jm, jslo = out["jax"]
        th, ts, tt, tm, tslo = out["port"]
    assert th == jh and th["ready"] and th["generation"] == 0
    keep = ("config", "codel", "result_cache", "queue_depth", "inflight", "draining")
    assert {k: ts["stats"][k] for k in keep} == {k: js["stats"][k] for k in keep}
    assert ts["stats"]["counters"] == js["stats"]["counters"]
    assert ts["stats"]["counters"]["responses"] == len(reqs) + 2
    assert ts["stats"]["counters"]["bad_request"] == 3
    assert set(ts["stats"]) == set(js["stats"])
    assert set(tslo["slo"]) == set(jslo["slo"]) == {"availability", "latency"}
    shape = [[(t["op"], t["status"], t["id"], [s["name"] for s in t["spans"]])
              for t in r["traces"]] for r in (jt, tt)]
    assert shape[0] == shape[1]
    assert {name for _, _, _, spans in shape[1] for name in spans} == {
        "queue_wait", "coalesce", "engine"}
    # the scrape text: every stats counter, and the daemon's own family
    # names equal to the JAX daemon's
    lines = _counter_lines(tm["text"])
    counters = ts["stats"]["counters"]
    for key, name in tdaemon_mod._COUNTER_NAMES:
        if key == "responses":  # the stats and trace answers went out since
            assert int(lines[name]) == counters[key] + 2
        else:
            assert lines[name] == str(counters[key]), name
    types = [{ln.split()[2] for ln in r["text"].splitlines() if ln.startswith("# TYPE ")}
             for r in (jm, tm)]
    daemon_families = {n for n in types[0] if n.startswith(("mri_serve_", "mri_slo_",
                                                            "mri_watchdog_", "mri_replica_"))
                       and "_tenant_" not in n}
    assert daemon_families and daemon_families <= types[1]
    assert '_bucket{le="+Inf"}' in tm["text"] and "# {trace_id=" in tm["text"]


def _settle(d, n: int) -> None:
    """Wait until daemon ``d`` has counted ``n`` responses."""
    deadline = time.monotonic() + 10
    while d._counts["responses"].value < n:
        assert time.monotonic() < deadline
        time.sleep(0.002)


@pytest.mark.qos
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_tenants_and_result_cache_match_jax(built, kind, monkeypatch):
    _, _, naive = built
    monkeypatch.setenv("MRI_SERVE_TENANT_WEIGHTS", "gold=3,*=1")
    monkeypatch.setenv("MRI_SERVE_TENANT_RATE", "slow=0.001:1")
    hot = sorted(naive, key=lambda w: -len(naive[w]))
    reqs = []
    for i in range(3):  # repeats: hits from the second round on
        reqs += [{"id": 10 * i, "op": "df", "terms": hot[:5], "tenant": "gold"},
                 {"id": 10 * i + 1, "op": "postings", "terms": hot[5:8], "tenant": "bronze"},
                 {"id": 10 * i + 2, "op": "and", "terms": [hot[1], hot[0]]},
                 {"id": 10 * i + 3, "op": "and", "terms": [hot[0], hot[1], hot[0]]},
                 # a new k each round: misses the cache, meets the bucket
                 {"id": 10 * i + 4, "op": "top_k", "letter": "c", "k": 3 + i, "tenant": "slow"}]
    with pair(built, kind) as (jd, td):
        jgot, tgot = exchange(jd, reqs), exchange(td, reqs)
        jst, tst = (exchange(d, [{"id": 99, "op": "stats"}])[0]["stats"] for d in (jd, td))
    assert_same(jgot, tgot, kind)
    assert [r.get("error") for r in tgot if r["id"] % 10 == 4] == [None, "overloaded", "overloaded"]
    assert tst["result_cache"] == jst["result_cache"] and tst["result_cache"]["hits"] > 0
    keep = ("weight", "rate_rps", "requests", "shed", "deadline_expired", "errors",
            "cache_hits", "queue_depth")
    view = [{name: {k: t[k] for k in keep} for name, t in st["tenants"].items()}
            for st in (jst, tst)]
    assert view[1] == view[0]
    assert view[1]["gold"]["weight"] == 3 and view[1]["gold"]["cache_hits"] == 2


def test_segment_surface_refused_as_jax_answers_a_plain_dir(built, tmp_path):
    """The segment ops on a plain artifact directory answer as the JAX
    daemon's do there: a delete (nothing to tombstone yet) and an append
    of a missing file are ``mutation_rejected`` with the JAX detail,
    ``compact`` a counted no-op, the replication ops ``bad_request``."""
    jdir, tdir, _ = built
    reqs = [{"id": 1, "op": "delete", "docs": [1, 2]}, {"id": 2, "op": "compact"},
            {"id": 3, "op": "snapshot"}, {"id": 4, "op": "wal_tail", "after_seq": 0},
            {"id": 5, "op": "wal_tail", "after_seq": -1},
            {"id": 6, "op": "fetch_segment", "segment": "nope", "file": "index.mri"},
            {"id": 7, "op": "fetch_segment", "segment": "seg_1_1", "file": "x.bin"},
            {"id": 8, "op": "fetch_segment", "segment": "seg_1_1", "file": "index.mri"},
            {"id": 9, "op": "delete", "docs": "x"},
            {"id": 10, "op": "df", "terms": ["cat"], "min_generation": 1},
            {"id": 11, "op": "append", "files": ["d.txt"]}]
    with pair(built, "host") as (jd, td):
        jgot, tgot = exchange(jd, reqs), exchange(td, reqs)
        jc, tc = (exchange(d, [{"id": 12, "op": "stats"}])[0]["stats"]["counters"]
                  for d in (jd, td))
    for j, t in zip(jgot, tgot):
        detail = j.get("detail")
        if detail is not None:
            j = dict(j, detail=detail.replace(str(jdir), str(tdir)))
        assert strip(t) == strip(j)
    assert tgot[0]["error"] == "mutation_rejected" and "append first" in tgot[0]["detail"]
    assert tgot[1]["result"]["compacted"] is False  # nothing to compact
    assert tgot[10]["error"] == "mutation_rejected" and "d.txt" in tgot[10]["detail"]
    for key in ("mutation_rejected", "bad_request", "stale_generation", "mutations"):
        assert tc[key] == jc[key], key
    assert not (tdir / "segments.manifest.json").exists()
    # a replica whose primary is down starts lagging over its own
    # artifact, as the JAX one does
    with serving(JDaemon, jdir, engine="host", replica_of="127.0.0.1:1") as jr, \
            serving(TDaemon, tdir, engine="host", replica_of="127.0.0.1:1") as tr:
        jh, th = (exchange(d, [{"id": 1, "op": "healthz"}])[0] for d in (jr, tr))
    assert th["reasons"] == jh["reasons"] and "replica_lagging" in th["reasons"]
    # a torn manifest refuses at construction with the JAX message; a
    # torn WAL is quarantined by the startup recovery and the artifact serves
    for name in ("segments.manifest.json", "segments.wal"):
        errs = []
        for pkg, cls in (("jax", JDaemon), ("port", TDaemon)):
            d = tmp_path / pkg / name.replace(".", "_")
            d.mkdir(parents=True)
            (d / "index.mri").write_bytes((tdir / "index.mri").read_bytes())
            (d / name).write_text("{}")
            try:
                with serving(cls, d, engine="host"):
                    errs.append(None)
            except Exception as e:  # noqa: BLE001 - the two packages' raises compared
                errs.append((type(e).__name__, str(e).replace(str(d), "DIR")))
            if name == "segments.wal":
                assert (d / "segments.wal.corrupt").read_text() == "{}"
        assert errs[1] == errs[0]
        assert (errs[0] is None) == (name == "segments.wal")


def test_default_engine_is_the_card(built):
    """No engine and no device: the card's device engine, or a raise —
    never the host in silence."""
    _, tdir, _ = built
    if torch.cuda.is_available():
        with serving(TDaemon, tdir) as d:
            assert d.stats()["engine"]["engine"] == "device"
    else:
        with pytest.raises(DeviceUnavailable):
            TDaemon(str(tdir))
        with pytest.raises(DeviceUnavailable):
            TDaemon(str(tdir), engine="auto")


def test_reload_frees_the_old_engine_and_keeps_answers(built):
    _, tdir, naive = built
    with serving(TDaemon, tdir, engine="device", device="cpu") as d, Client(d) as c:
        want = c.rpc(id=1, op="postings", terms=["cat", "dog"])["postings"]
        first = d._engine
        for i in range(5):
            assert c.rpc(id=10 + i, op="reload")["reloaded"]
            got = c.rpc(id=20 + i, op="postings", terms=["cat", "dog"])
            assert got["postings"] == want == [naive["cat"], naive["dog"]]
        # the swapped-out engine dropped its columns
        assert d._engine is not first and first._decode_cols == ()
        assert d.stats()["counters"]["reload_ok"] == 5
