"""The port's host ``Engine`` against the JAX package's host ``Engine`` on
the same ``index.mri`` (the JAX package's cpu-backend builds, formats v1,
v2 and v2.1): every answer exactly equal (``==``, BM25 float64 scores
included) — lookup, df, postings, AND, OR, top-k by df, ``top_k_scored``
and ``top_k_scored_batch`` under each planner, with the native serve
kernels off and required (``MRI_SERVE_NATIVE`` 0 and 1; v1 is numpy
only), ``set_corpus_override`` — and the ``describe()`` blocks.  Then the
port's ``LRUCache``: LRU order, eviction counts and a thread hammer; and
the op timer's histogram.  Query terms are drawn from a seed."""

import random
import threading

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.obs import (
    attribution as jattrib,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve import (
    artifact as jartifact,
    cache as jcache,
    engine as jengine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    ArtifactError,
    Engine,
    artifact_path,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.obs import (
    attribution as tattrib,
    metrics as tmetrics,
    timing as ttiming,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.cache import (
    LRUCache,
)

from test_torch_serve_device import FORMATS, _build, _naive

pytestmark = pytest.mark.serve

PLANNERS = ("exhaustive", "bmw", "maxscore", "auto")
#: (format, MRI_SERVE_NATIVE): the native kernels take v2 and v2.1 only
LEGS = [("1", "0"), ("2", "0"), ("2", "1"), ("3", "0"), ("3", "1")]
JUNK = ["", "zzzznope", "Aardvark!!", "x1y2z3q4", "a" * 40, "THE"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    docs = tsyn.zipf_corpus(num_docs=90, vocab_size=1200, tokens_per_doc=160, seed=23)
    docs.append(b"zebra zebra zebra apple apple quokka " * 30)  # tf > 1
    docs.append(b"apple " * 400 + b"zebra")                     # a long doc
    return _build(tmp_path_factory.mktemp("thost"), docs), _naive(docs)


def _open(cls, out, native, monkeypatch, **kw):
    """An engine opened under ``MRI_SERVE_NATIVE=native`` (resolved at
    construction, so the two packages' engines can run side by side)."""
    monkeypatch.setenv("MRI_SERVE_NATIVE", native)
    eng = cls(artifact_path(out), **kw)
    monkeypatch.delenv("MRI_SERVE_NATIVE")
    return eng


@pytest.fixture
def pair(built, request, monkeypatch):
    fmt, native = request.param
    outs, naive = built
    port = _open(Engine, outs[fmt], native, monkeypatch)
    jax_ = _open(jengine.Engine, outs[fmt], native, monkeypatch)
    yield port, jax_, naive
    port.close()
    jax_.close()


def _draw(naive, n, seed):
    vocab = sorted(naive)
    rng = random.Random(seed)
    return [vocab[rng.randrange(len(vocab))] if rng.random() < 0.85
            else JUNK[rng.randrange(len(JUNK))] for _ in range(n)]


def _bm25_queries(naive):
    by_df = sorted(naive, key=lambda t: (-len(naive[t]), t))
    rng = random.Random(31)
    qs = [by_df[:2], by_df[:3], [by_df[0], by_df[0]], ["zebra", "apple", "quokka"],
          [by_df[4], "notthere"], ["notthere"], [by_df[1], by_df[7], by_df[1]]]
    for n in (1, 2, 3, 5):
        for _ in range(5):
            qs.append(rng.sample(by_df[:300], n))
    return qs


@pytest.mark.parametrize("pair", LEGS, indirect=True, ids=lambda p: f"v{p[0]}-native{p[1]}")
def test_single_term_parity(pair):
    port, jax_, naive = pair
    for n, seed in ((1, 1), (7, 2), (32, 3), (1024, 4), (7, 2)):  # the repeat: memo arm
        terms = _draw(naive, n, seed)
        b = port.encode_batch(terms)
        assert (b == jax_.encode_batch(terms)).all()
        idx, found = port.lookup(b)
        jidx, jfound = jax_.lookup(b)
        assert idx.dtype == jidx.dtype and found.tolist() == jfound.tolist()
        assert idx.tolist() == jidx.tolist()
        d = port.df(b)
        assert d.dtype == np.int64 and d.tolist() == jax_.df(b).tolist()
        for t, p, j in zip(terms, port.postings(b), jax_.postings(b)):
            if j is None:
                assert p is None and naive.get(t) is None or t == "", t
                continue
            assert p.dtype == j.dtype and p.tolist() == j.tolist() == naive[t], t


@pytest.mark.parametrize("pair", LEGS, indirect=True, ids=lambda p: f"v{p[0]}-native{p[1]}")
def test_compound_parity(pair):
    port, jax_, naive = pair
    vocab = sorted(naive)
    rng = random.Random(5)
    for _ in range(60):
        k = rng.choice((1, 2, 2, 3, 4, 5))
        terms = rng.sample(vocab, k=k)
        if rng.random() < 0.2:
            terms[rng.randrange(k)] = "notinthecorpusxyz"
        b = port.encode_batch(terms)
        got = {}
        for op in ("query_and", "query_or"):
            got[op], want = getattr(port, op)(b), getattr(jax_, op)(b)
            assert got[op].dtype == want.dtype == np.int32
            assert got[op].tolist() == want.tolist(), (op, terms)
        sets = [set(naive.get(t, ())) for t in terms]
        assert got["query_and"].tolist() == (sorted(set.intersection(*sets))
                                             if all(sets) else [])
    for li in range(26):
        for k in (0, 1, 3, 1000):
            assert port.top_k(li, k) == jax_.top_k(li, k)
    assert port.top_k("q", 4) == jax_.top_k(b"q", 4)
    with pytest.raises(ValueError):
        port.top_k("1", 3)
    assert port.describe()["planner"]["and"] == jax_.describe()["planner"]["and"]


@pytest.mark.parametrize("planner", PLANNERS)
@pytest.mark.parametrize("pair", LEGS, indirect=True, ids=lambda p: f"v{p[0]}-native{p[1]}")
def test_ranked_parity(pair, planner, monkeypatch):
    """``top_k_scored`` exactly equal, float bits included, then the
    coalesced ``top_k_scored_batch`` equal to the serial answers, cold
    and warm, at several group sizes."""
    port, jax_, naive = pair
    monkeypatch.setenv("MRI_SERVE_PLANNER", planner)
    qs = _bm25_queries(naive)
    for k in (1, 10, 60):
        serial = []
        for q in qs:
            got = port.top_k_scored(port.encode_batch(q), k)
            want = jax_.top_k_scored(jax_.encode_batch(q), k)
            assert got == want, (planner, q, k)
            assert [np.float64(s).tobytes() for _, s in got] == \
                [np.float64(s).tobytes() for _, s in want]
            serial.append(got)
        for size in (1, 4, len(qs)):
            for eng in (port, jax_):
                encs = [eng.encode_batch(q) for q in qs]
                got = []
                for i in range(0, len(encs), size):
                    got.extend(eng.top_k_scored_batch(encs[i:i + size], k))
                assert got == serial, (eng, planner, k, size)
    dp, dj = port.describe(), jax_.describe()
    assert dp["planner"]["ranked"] == dj["planner"]["ranked"]
    assert dp["native"]["active"] == dj["native"]["active"]
    assert dp["native"]["fallbacks"] == dj["native"]["fallbacks"] == 0


@pytest.mark.parametrize("pair", [("2", "1"), ("3", "0"), ("3", "1")], indirect=True,
                         ids=lambda p: f"v{p[0]}-native{p[1]}")
def test_corpus_override_parity(pair, monkeypatch):
    """Scored as one segment of a larger corpus: the injected ndocs,
    avgdl and df give the same float64 scores in both packages."""
    port, jax_, naive = pair
    qs = _bm25_queries(naive)
    for q in qs[:6]:  # warm the memos the override must clear
        port.top_k_scored(port.encode_batch(q), 10)
    for eng in (port, jax_):
        df = eng.artifact.df
        eng.set_corpus_override(5000, 61.25, lambda i, df=df: int(df[i]) * 7 + 3)
    for planner in ("exhaustive", "bmw", "maxscore"):
        monkeypatch.setenv("MRI_SERVE_PLANNER", planner)
        for q in qs:
            got = port.top_k_scored(port.encode_batch(q), 10)
            assert got == jax_.top_k_scored(jax_.encode_batch(q), 10), (planner, q)
    assert port._bm25_corpus()[1:] == (5000, 61.25)


@pytest.mark.parametrize("pair", LEGS, indirect=True, ids=lambda p: f"v{p[0]}-native{p[1]}")
def test_describe_parity(pair):
    """The same keys and counters as the JAX engine after the same ops;
    only the op timings' values differ (no port-only keys on the host
    engine)."""
    port, jax_, naive = pair
    terms = _draw(naive, 40, 9)
    for eng in (port, jax_):
        b = eng.encode_batch(terms)
        eng.df(b)
        eng.postings(b)
        eng.query_and(eng.encode_batch(terms[:3]))
        eng.query_or(eng.encode_batch(terms[:3]))
        eng.top_k("s", 5)
        eng.top_k_scored(eng.encode_batch(terms[:4]), 10)
    got, want = port.describe(), jax_.describe()
    assert set(got) == set(want)
    for key in ("engine", "format", "vocab", "artifact_bytes", "cache", "decode",
                "planner", "native"):
        assert got[key] == want[key], key
    assert {op: v["calls"] for op, v in got["ops"].items()} == \
        {op: v["calls"] for op, v in want["ops"].items()}
    assert set(got["native"]) == {"mode", "active", "error", "ops", "fallbacks"}


@pytest.mark.parametrize("pair", [("1", "0"), ("3", "0"), ("3", "1")], indirect=True,
                         ids=lambda p: f"v{p[0]}-native{p[1]}")
def test_attribution_reports_parity(pair, monkeypatch):
    """A request-scoped collector installed around each op gets the same
    cost report from both packages' engines (terms and their resolution
    path, cache events, blocks decoded/skipped, the planner's arms and
    decision), and its totals match the registry counters' movement."""
    port, jax_, naive = pair
    monkeypatch.setenv("MRI_SERVE_PLANNER", "auto")
    by_df = sorted(naive, key=lambda t: (-len(naive[t]), t))
    ops = [("df", [by_df[3], "nope", by_df[40]]), ("postings", [by_df[3], by_df[900]]),
           ("query_and", by_df[:3]), ("query_and", [by_df[0], by_df[500]]),
           ("query_or", by_df[5:8]), ("top_k_scored", by_df[:3]),
           ("top_k_scored", [by_df[2], by_df[60]]), ("top_k_scored", by_df[:3])]
    for op, terms in ops:
        reports = []
        for eng, attrib in ((port, tattrib), (jax_, jattrib)):
            before = eng.decode_stats()
            args = (eng.encode_batch(terms), 10) if op == "top_k_scored" \
                else (eng.encode_batch(terms),)
            with attrib.collect(op) as coll:
                getattr(eng, op)(*args)
            rep = coll.report()
            after = eng.decode_stats()
            assert rep["totals"]["blocks_decoded"] == \
                after["blocks_decoded"] - before["blocks_decoded"]
            assert rep["totals"]["blocks_skipped"] == \
                after["blocks_skipped"] - before["blocks_skipped"]
            reports.append(rep)
        assert reports[0] == reports[1], (op, terms)
    assert tattrib.active() is None


def test_engine_refusals(built, tmp_path, monkeypatch):
    outs, _ = built
    (tmp_path / "segments.manifest.json").write_text("{}")
    with pytest.raises(jartifact.ArtifactError) as jerr:
        jengine.Engine(tmp_path)
    with pytest.raises(ArtifactError) as terr:
        Engine(tmp_path)
    # the JAX text: the root artifact may be stale, create_engine routes
    assert str(terr.value) == str(jerr.value) and "create_engine" in str(terr.value)
    with pytest.raises(ArtifactError, match="cannot open"):
        Engine(tmp_path / "nowhere")
    monkeypatch.setenv("MRI_SERVE_NATIVE", "yes")
    with pytest.raises(ValueError, match="MRI_SERVE_NATIVE"):
        Engine(outs["3"])
    # required native on v1 fails loudly, up front
    monkeypatch.setenv("MRI_SERVE_NATIVE", "1")
    with pytest.raises(RuntimeError, match="MRI_SERVE_NATIVE=1"):
        Engine(outs["1"])


def test_lru_cache_semantics(built):
    outs, naive = built
    vocab = sorted(naive)
    with Engine(artifact_path(outs["3"]), cache_terms=4) as engine:
        terms = vocab[:6]
        engine.postings(engine.encode_batch(terms))       # 6 misses, 2 evictions
        stats = engine.cache_stats()
        assert stats["misses"] == 6 and stats["entries"] == 4 and stats["evictions"] == 2
        engine.postings(engine.encode_batch(terms[-4:]))  # all resident
        assert engine.cache_stats()["hits"] == 4
        engine.postings(engine.encode_batch(terms[:1]))   # evicted -> miss
        assert engine.cache_stats()["misses"] == 7
        engine.cache.clear()
        assert engine.cache_stats()["entries"] == 0
        for t, p in zip(terms, engine.postings(engine.encode_batch(terms))):
            assert p.tolist() == naive[t]


def test_lru_cache_put_peek_purge_bytes():
    """Recency, eviction, peek without accounting, purge keeping the
    tallies; the stats keys are the JAX cache's (its byte bound, which
    no engine sets, reads 0)."""
    cache = LRUCache(3)
    for i in range(3):
        cache.put(i, f"v{i}")
    assert cache.peek(0) == "v0" and cache.hits == 0 and cache.misses == 0
    assert cache.get(0) == "v0"            # 0 is now the most recent
    cache.put(3, "v3")                     # over capacity: evicts 1
    assert 1 not in cache and 0 in cache and cache.evictions == 1
    cache.put(0, "v0b")                    # replace: no eviction
    assert cache.get(0) == "v0b" and len(cache) == 3 and cache.evictions == 1
    assert cache.get("nope") is None and cache.misses == 1
    assert cache.purge() == 3 and len(cache) == 0
    assert cache.hits == 2 and cache.evictions == 1  # history survives a purge
    want = jcache.LRUCache(3).stats()
    cache.clear()
    assert cache.stats() == want == {"capacity": 3, "entries": 0, "bytes": 0,
                                     "max_bytes": 0, "hits": 0, "misses": 0,
                                     "evictions": 0, "hit_rate": 0.0}
    zero = LRUCache(0)
    zero.put("k", 1)
    assert len(zero) == 0
    with pytest.raises(ValueError):
        LRUCache(-1)


def test_lru_cache_thread_hammer():
    """Eight threads on one small cache: no exception, never over
    capacity, no value under the wrong key, coherent counters."""
    cache = LRUCache(capacity=8)
    keys = [f"k{i}" for i in range(32)]
    errors: list[BaseException] = []
    gets_per_thread, n_threads = 2000, 8
    start = threading.Barrier(n_threads)

    def hammer(seed: int) -> None:
        rng = random.Random(seed)
        try:
            start.wait()
            for _ in range(gets_per_thread):
                k = rng.choice(keys)
                v = cache.get(k)
                if v is None:
                    cache.put(k, ("payload", k))
                else:
                    assert v == ("payload", k), f"corrupt value for {k}: {v}"
                if rng.random() < 0.01:
                    cache.stats()
                    len(cache)
        except BaseException as e:  # surfaced below; a thread would swallow it
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, f"cache raced: {errors[:3]}"
    stats = cache.stats()
    assert stats["entries"] <= 8 and len(cache) <= 8
    assert stats["hits"] + stats["misses"] == n_threads * gets_per_thread


def test_op_timer_histogram_is_the_registry_series():
    """The histogram a hot path observes directly is the registry's
    series that the op stats read."""
    reg = tmetrics.Registry()
    timer = ttiming.OpTimer(registry=reg)
    h = timer.histogram("df")
    assert h is reg.histogram("mri_engine_op_df_seconds") and h is timer.histogram("df")
    vals = np.random.default_rng(2).exponential(1e-3, 101)
    for v in vals:
        h.observe(v)
    with timer.time("df"):
        pass
    assert h.count == 102 and h.sum == pytest.approx(vals.sum(), abs=1e-3)
    assert timer.stats()["df"]["calls"] == 102
