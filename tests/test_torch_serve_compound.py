"""Compound queries of the port's torch ``DeviceEngine`` on the CPU
against the JAX package's ``DeviceEngine`` and host ``Engine`` on the
same artifacts (v1, v2, v2.1): AND and OR byte-equal (and equal to set
algebra over a naive index); BM25 docs equal, in order, and scores
within rel 1e-4 (the JAX suite's own bound) under the exhaustive, bmw
and maxscore planners, with the same planner decisions and the same
answer when a query is run twice."""

import random

import numpy as np
import pytest

from test_torch_serve_device import FORMATS, zipf  # noqa: F401  (zipf: fixture)

pytestmark = pytest.mark.serve


@pytest.mark.parametrize("fmt", FORMATS)
def test_boolean_parity(zipf, fmt):
    trios, naive = zipf
    trio = trios[fmt]
    vocab = sorted(naive)
    rng = random.Random(5)
    for _ in range(40):
        k = rng.choice((1, 2, 2, 3, 4, 5))
        terms = rng.sample(vocab, k=k)
        if rng.random() < 0.25:
            terms[rng.randrange(k)] = "notinthecorpusxyz"
        b = trio.port.encode_batch(terms)
        for op in ("query_and", "query_or"):
            got = getattr(trio.port, op)(b)
            assert got.dtype == np.int32
            assert got.tolist() == getattr(trio.jdev, op)(b).tolist() \
                == getattr(trio.host, op)(b).tolist(), (op, terms)
        sets = [set(naive.get(t, ())) for t in terms]
        assert trio.port.query_and(b).tolist() == (
            sorted(set.intersection(*sets)) if all(sets) else [])


def _bm25_queries(naive):
    vocab = sorted(naive, key=lambda t: (-len(naive[t]), t))
    rng = random.Random(3)
    qs = [vocab[:2], vocab[:3], [vocab[0], vocab[0]], ["zebra", "apple", "quokka"],
          [vocab[5], "notthere"], ["notthere"]]
    for n in (1, 2, 3, 5):
        for _ in range(4):
            qs.append(rng.sample(vocab[:200], n))
    return qs


@pytest.mark.parametrize("planner", ["exhaustive", "bmw", "maxscore"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_bm25_parity(zipf, fmt, planner, monkeypatch):
    monkeypatch.setenv("MRI_SERVE_PLANNER", planner)
    trios, naive = zipf
    trio = trios[fmt]
    before = trio.port.planner.describe()["ranked"]
    jbefore = trio.jdev.planner.describe()["ranked"]
    for q in _bm25_queries(naive):
        b = trio.port.encode_batch(q)
        for k in ((1, 10, 1000) if len(q) == 2 else (10,)):
            got = trio.port.top_k_scored(b, k)
            for ref in (trio.jdev, trio.host):
                want = ref.top_k_scored(b, k)
                assert [d for d, _ in got] == [d for d, _ in want], (q, k)
                for (_, gs), (_, ws) in zip(got, want):
                    assert gs == pytest.approx(ws, rel=1e-4), (q, k)
            assert got == trio.port.top_k_scored(b, k)
    after = trio.port.planner.describe()["ranked"]
    jafter = trio.jdev.planner.describe()["ranked"]
    # the same decisions, each port query run twice (the repeat above)
    assert {m: after[m] - before[m] for m in after} == \
        {m: 2 * (jafter[m] - jbefore[m]) for m in jafter}


@pytest.mark.parametrize("planner", ["exhaustive", "bmw", "maxscore"])
def test_bm25_idf_of_a_term_in_nearly_every_doc(tmp_path, planner, monkeypatch):
    """A term in all but one of 20,000 documents has idf = log1p(x) with
    x = 1.5 / 19999.5; float32 log(1 + x) would keep few bits of x
    (2e-3 relative).  The port stays within rel 1e-4 of float64."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        DeviceEngine, artifact as TA)

    monkeypatch.setenv("MRI_SERVE_PLANNER", planner)
    rng = np.random.default_rng(8)
    N = 20_000
    runs = {b"common": np.delete(np.arange(1, N + 1), 777),
            b"mid": np.sort(rng.choice(np.arange(1, N + 1), 3000, replace=False)),
            b"rare": np.sort(rng.choice(np.arange(1, N + 1), 40, replace=False))}
    words = sorted(runs)
    df = np.array([len(runs[w]) for w in words])
    flat = np.concatenate([runs[w] for w in words]).astype(np.int32)
    tf = rng.integers(1, 4, len(flat)).astype(np.int32)
    TA.pack_v2(tmp_path / "a.mri", term_blob=np.frombuffer(b"".join(words), np.uint8),
               term_offsets=np.cumsum([0] + [len(w) for w in words]),
               df=df, post_offsets=np.cumsum(np.concatenate([[0], df])), postings=flat,
               df_order=np.arange(3), max_doc_id=N, fmt=3, tf=tf)
    doc_lens = np.bincount(flat, weights=tf, minlength=N + 1)
    ndocs, avgdl = np.count_nonzero(doc_lens), doc_lens[doc_lens > 0].mean()
    with DeviceEngine(tmp_path / "a.mri", device="cpu") as eng:
        for q in (["common"], ["common", "rare"], ["common", "mid", "common"]):
            scores = np.zeros(N + 1)
            start = 0
            for w, d in zip(words, df):
                if w.decode() in q:
                    docs, t = flat[start:start + d], tf[start:start + d].astype(np.float64)
                    idf = np.log(1.0 + (ndocs - d + 0.5) / (d + 0.5))
                    scores[docs] += q.count(w.decode()) * idf * t * 2.2 / (
                        t + 1.2 * (0.25 + 0.75 * doc_lens[docs] / avgdl))
                start += d
            hit = np.nonzero(scores > 0)[0]
            want = hit[np.lexsort((hit, -scores[hit]))][:10]
            got = eng.top_k_scored(eng.encode_batch(q), 10)
            assert [d for d, _ in got] == want.tolist(), q
            for (_, s), d in zip(got, want):
                assert s == pytest.approx(scores[d], rel=1e-4), q
