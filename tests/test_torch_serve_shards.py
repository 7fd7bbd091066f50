"""Batch sharding of the port's ``DeviceEngine`` (``shards=N``, the JAX
engine's 1-D batch mesh on logical shards): at N = 1, 2, 4 and 8 on the
CPU it answers df, postings and BM25 byte-equal to the JAX
``DeviceEngine`` (its mesh over the 8 virtual CPU devices) and to the
JAX host ``Engine``, at batches 1, 7, 64 and 1024, on formats v1, v2
and v2.1 (BM25: equal docs; scores within rel 1e-4 of the JAX device
engine's float32 and equal to themselves at every N).  Then
``create_engine``/``AutoEngine`` pass ``shards`` through and the
default is one shard on the CPU (every visible card on ``cuda``)."""

import random

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve import Engine as JHost
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.device_engine import (
    DeviceEngine as JDevice,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    DeviceEngine,
    artifact_path,
    create_engine,
)

from test_torch_serve_device import FORMATS, _build, _naive

pytestmark = [pytest.mark.serve, pytest.mark.device_serve]

SHARDS = (1, 2, 4, 8)
BATCHES = (1, 7, 64, 1024)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Per format: the artifact path and the JAX engines' answers to
    every batch and ranked query (computed once, shared by every N)."""
    docs = tsyn.zipf_corpus(num_docs=120, vocab_size=1500, tokens_per_doc=80, seed=23)
    docs.append(b"zebra zebra apple apple apple quokka " * 20)  # tf > 1
    outs = _build(tmp_path_factory.mktemp("tserve_shards"), docs)
    naive = _naive(docs)
    vocab = sorted(naive)
    rng = random.Random(3)
    junk = ["", "zzzznope", "x1y2z3q4", "a" * 40]
    batches = {b: [vocab[rng.randrange(len(vocab))] if rng.random() < 0.85
                   else junk[rng.randrange(len(junk))] for _ in range(b)] for b in BATCHES}
    hot = sorted(naive, key=lambda w: (-len(naive[w]), w))
    ranked = [hot[:3], [hot[0], hot[0], hot[50]], ["zebra", "apple", "nosuchword"], [hot[7]]]
    want = {}
    for fmt in FORMATS:
        path = artifact_path(outs[fmt])
        with JDevice(path) as jdev, JHost(path) as host:
            assert jdev.describe()["device"]["shards"] == 8
            got = {}
            for b, terms in batches.items():
                batch = host.encode_batch(terms)
                df = host.df(batch).tolist()
                assert jdev.df(batch).tolist() == df
                posts = [None if r is None else r.tolist() for r in host.postings(batch)]
                assert [None if r is None else r.tolist() for r in jdev.postings(batch)] == posts
                got[b] = (df, posts)
            got["bm25"] = [jdev.top_k_scored(jdev.encode_batch(q), 10) for q in ranked]
            got["bm25_host"] = [host.top_k_scored(host.encode_batch(q), 10) for q in ranked]
        want[fmt] = (path, got)
    return want, batches, ranked, naive


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_sharded_engine_matches_jax_and_host(corpus, fmt, shards):
    want, batches, ranked, naive = corpus
    path, jax = want[fmt]
    with DeviceEngine(path, device="cpu", shards=shards) as eng:
        dev = eng.describe()["device"]
        assert dev["shards"] == shards and dev["devices"] == ["cpu"] * shards
        for b, terms in batches.items():
            batch = eng.encode_batch(terms)
            df, posts = jax[b]
            assert eng.df(batch).tolist() == df
            got = eng.postings(batch)
            assert [None if r is None else r.tolist() for r in got] == posts
            assert all(r is None or r.dtype == np.int32 for r in got)
            for t, r in zip(terms, posts):
                assert r == naive.get(t) or (r is None and t not in naive)
        for q, jtop, htop in zip(ranked, jax["bm25"], jax["bm25_host"]):
            top = eng.top_k_scored(eng.encode_batch(q), 10)
            assert [d for d, _ in top] == [d for d, _ in jtop] == [d for d, _ in htop]
            assert np.allclose([s for _, s in top], [s for _, s in jtop], rtol=1e-4)
            # the ranked tail runs on the first shard: the same bits at every N
            with DeviceEngine(path, device="cpu", shards=1) as one:
                assert top == one.top_k_scored(one.encode_batch(q), 10)


def test_create_engine_passes_shards(corpus, monkeypatch):
    want, *_ = corpus
    path = want["3"][0]
    for which in ("device", "auto"):
        monkeypatch.setenv("MRI_SERVE_CROSSOVER", "1")  # auto: every batch on the device
        with create_engine(path, which, device="cpu", shards=4) as eng:
            eng.df(eng.encode_batch(["apple"]))
            dev = eng if which == "device" else eng.device_engine
            assert dev.describe()["device"]["shards"] == 4
    monkeypatch.delenv("MRI_SERVE_SHARDS", raising=False)
    with DeviceEngine(path, device="cpu") as eng:
        assert eng.describe()["device"]["shards"] == 1
    monkeypatch.setenv("MRI_SERVE_SHARDS", "3")
    with DeviceEngine(path, device="cpu") as eng:
        assert eng.describe()["device"]["shards"] == 3
    with DeviceEngine(path, device="cpu", shards=2) as eng:  # the argument wins
        assert eng.describe()["device"]["shards"] == 2


def test_sharded_engine_refuses_a_named_card(corpus):
    """A mesh spreads from the first card on, so a device with an index
    takes one shard only: more raises, and never moves to another card."""
    path = corpus[0]["3"][0]
    with pytest.raises(ValueError, match="names one card"):
        DeviceEngine(path, device="cpu:0", shards=2)
    with DeviceEngine(path, device="cpu:0", shards=1) as eng:
        assert eng.describe()["device"]["shards"] == 1
