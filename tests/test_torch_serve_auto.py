"""The port's engine selection and crossover router on the CPU:
``resolve_engine`` (default ``device``, the environment, the flag over
the environment, a bad value), ``AutoEngine`` with its device engine on
the CPU (small batches on the host, one probe at the first batch of
8192, ``MRI_SERVE_CROSSOVER`` 0 and N, compound and ranked queries on
the host, answers equal to the host engine's), a device engine that
fails to build raising instead of being replaced by the host, and
``create_engine``'s engines and routes (a cluster shard opens the host
shard engine and a segment-managed directory the multi-segment engine,
unless ``device`` is named)."""

import json
import random

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models.inverted_index import (
    DeviceUnavailable,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cluster.shard import (
    ShardEngine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    ArtifactError,
    artifact as artifact_mod,
    AutoEngine,
    DeviceEngine,
    Engine,
    create_engine,
    device_engine as dev_mod,
    engine as eng_mod,
)

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
    segments as tsegments,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.multi_engine import (
    MultiSegmentEngine,
)

from test_torch_serve_device import _build, _naive

pytestmark = pytest.mark.serve


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    docs = tsyn.zipf_corpus(num_docs=50, vocab_size=700, tokens_per_doc=120, seed=29)
    return _build(tmp_path_factory.mktemp("tauto"), docs), _naive(docs)


@pytest.fixture(autouse=True)
def _no_engine_env(monkeypatch):
    for name in ("MRI_SERVE_ENGINE", "MRI_SERVE_CROSSOVER", "MRI_SERVE_NATIVE"):
        monkeypatch.delenv(name, raising=False)


def _words(naive, n, seed):
    vocab = sorted(naive)
    rng = random.Random(seed)
    return [vocab[rng.randrange(len(vocab))] if rng.random() < 0.9 else "nope"
            for _ in range(n)]


def _device_calls(auto):
    dev = auto.device_engine
    return 0 if dev is None else sum(v["calls"] for v in dev.op_stats().values())


def test_resolve_engine(monkeypatch):
    assert eng_mod.resolve_engine() == "device"
    assert eng_mod.resolve_engine("host") == "host"
    monkeypatch.setenv("MRI_SERVE_ENGINE", "auto")
    assert eng_mod.resolve_engine() == "auto"
    assert eng_mod.resolve_engine("host") == "host"  # the flag beats the env
    with pytest.raises(ValueError, match="unknown engine"):
        eng_mod.resolve_engine("tpu")
    monkeypatch.setenv("MRI_SERVE_ENGINE", "gpu")
    with pytest.raises(ValueError, match="unknown engine 'gpu'"):
        eng_mod.resolve_engine()
    assert eng_mod.ENGINE_CHOICES == ("host", "device", "auto")
    assert eng_mod.PROBE_BATCH_MIN == 8192


@pytest.mark.parametrize("fmt", ["1", "3"])
def test_auto_routes_small_batches_to_host_then_probes_once(built, fmt):
    outs, naive = built
    with AutoEngine(outs[fmt], device="cpu") as auto, Engine(outs[fmt]) as host:
        assert auto.describe()["auto"] == {"crossover": None, "probe": None,
                                           "device_ready": False}
        for n in (1, 32, 1024, 8191):
            b = auto.encode_batch(_words(naive, n, n))
            assert auto.df(b).tolist() == host.df(b).tolist()
            idx, found = auto.lookup(b)
            hidx, hfound = host.lookup(b)
            assert found.tolist() == hfound.tolist() and idx.tolist() == hidx.tolist()
        assert auto.device_engine is None
        b = auto.encode_batch(_words(naive, 8192, 5))
        assert auto.df(b).tolist() == host.df(b).tolist()
        probe = auto.describe()["auto"]["probe"]
        assert probe["batch"] == 8192 and probe["winner"] in ("host", "device")
        assert probe["host_s"] > 0 and probe["device_s"] > 0
        assert auto.device_engine is not None
        calls = _device_calls(auto)
        assert calls >= 4  # the warm-up and the best-of-3
        for p, h in zip(auto.postings(b[:300]), host.postings(b[:300])):
            assert (p is None and h is None) or p.tolist() == h.tolist()
        auto.df(b)  # a second large batch: no second probe
        assert auto.describe()["auto"]["probe"] == probe
        want = 8192 if probe["winner"] == "device" else 1 << 62
        assert auto.describe()["auto"]["crossover"] == want
        assert _device_calls(auto) == calls + (1 if probe["winner"] == "device" else 0)


def test_auto_compound_and_ranked_stay_on_host(built):
    outs, naive = built
    vocab = sorted(naive, key=lambda t: -len(naive[t]))
    with AutoEngine(outs["3"], device="cpu") as auto, Engine(outs["3"]) as host:
        rng = random.Random(8)
        for _ in range(20):
            q = rng.sample(vocab[:100], rng.randint(1, 4))
            b = auto.encode_batch(q)
            assert auto.query_and(b).tolist() == host.query_and(b).tolist()
            assert auto.query_or(b).tolist() == host.query_or(b).tolist()
            assert auto.top_k_scored(b, 10) == host.top_k_scored(b, 10)
        encs = [auto.encode_batch(vocab[i:i + 2]) for i in range(6)]
        assert auto.top_k_scored_batch(encs, 5) == host.top_k_scored_batch(encs, 5)
        assert auto.top_k("t", 4) == host.top_k("t", 4)
        d = auto.describe()
        assert d["engine"] == "auto" and d["auto"]["device_ready"] is False
        assert {"native", "planner", "cache", "decode"} <= set(d)
        assert auto.vocab_size == host.vocab_size and auto.cache is not None
        assert auto.artifact.vocab == host.artifact.vocab


@pytest.mark.parametrize("fmt", ["1", "2"])
def test_crossover_knob(built, fmt, monkeypatch):
    outs, naive = built
    monkeypatch.setenv("MRI_SERVE_CROSSOVER", "1")
    with AutoEngine(outs[fmt], device="cpu") as auto, Engine(outs[fmt]) as host:
        for n in (1, 3, 40):
            b = auto.encode_batch(_words(naive, n, n + 1))
            before = _device_calls(auto)
            assert auto.df(b).tolist() == host.df(b).tolist()
            for p, h in zip(auto.postings(b), host.postings(b)):
                assert (p is None and h is None) or p.tolist() == h.tolist()
            assert _device_calls(auto) == before + 2  # both went to the device
        assert auto.describe()["auto"]["crossover"] == 1
        assert auto.describe()["auto"]["probe"] is None
    monkeypatch.setenv("MRI_SERVE_CROSSOVER", "0")
    with AutoEngine(outs[fmt]) as auto:  # pins the host: no device needed
        big = auto.encode_batch(_words(naive, 8192, 4))
        assert auto.df(big).shape == (8192,)
        d = auto.describe()["auto"]
        assert d["device_ready"] is False and d["crossover"] == 0 and d["probe"] is None
    monkeypatch.setenv("MRI_SERVE_CROSSOVER", "-3")
    with pytest.raises(ValueError, match="MRI_SERVE_CROSSOVER"):
        AutoEngine(outs[fmt], device="cpu")
    monkeypatch.setenv("MRI_SERVE_CROSSOVER", "many")
    with pytest.raises(ValueError, match="MRI_SERVE_CROSSOVER"):
        AutoEngine(outs[fmt], device="cpu")


def test_device_failure_raises_not_pinned_to_host(built, monkeypatch):
    outs, naive = built
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable):
            AutoEngine(outs["3"])
        with pytest.raises(DeviceUnavailable):
            create_engine(outs["3"], "auto")

    def broken(*a, **kw):
        raise RuntimeError("device engine build failed")

    monkeypatch.setattr(dev_mod, "DeviceEngine", broken)
    with AutoEngine(outs["3"], device="cpu") as auto:
        small = auto.encode_batch(_words(naive, 10, 1))
        auto.df(small)  # the host answers small batches
        big = auto.encode_batch(_words(naive, 8192, 2))
        for _ in range(2):  # every large batch raises again: nothing is pinned
            with pytest.raises(RuntimeError, match="device engine build failed"):
                auto.df(big)
            assert auto.describe()["auto"]["device_ready"] is False
    monkeypatch.setenv("MRI_SERVE_CROSSOVER", "5")
    with AutoEngine(outs["3"], device="cpu") as auto:
        with pytest.raises(RuntimeError, match="device engine build failed"):
            auto.postings(auto.encode_batch(_words(naive, 6, 3)))


def test_create_engine_kinds(built, monkeypatch):
    outs, _ = built
    with create_engine(outs["3"], "host") as e:
        assert type(e) is Engine and e.describe()["engine"] == "host"
    with create_engine(outs["3"], "device", device="cpu") as e:
        assert type(e) is DeviceEngine and e.describe()["engine"] == "device"
    with create_engine(outs["3"], "auto", device="cpu") as e:
        assert type(e) is AutoEngine and e.describe()["engine"] == "auto"
    with create_engine(outs["3"], device="cpu") as e:  # no flag, no env: device
        assert type(e) is DeviceEngine
    monkeypatch.setenv("MRI_SERVE_ENGINE", "host")
    with create_engine(outs["3"]) as e:
        assert type(e) is Engine
    with create_engine(outs["3"], "auto", device="cpu") as e:
        assert type(e) is AutoEngine
    monkeypatch.delenv("MRI_SERVE_ENGINE")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable):
            create_engine(outs["3"])


def _write_one_shard_sidecar(shard, art_dir):
    """The sidecar of shard 0 of a one-shard cluster over ``art_dir``'s
    artifact (identity gid map, the artifact's own stats), as
    ``cluster.partition`` writes it."""
    art = artifact_mod.load_artifact(art_dir)
    try:
        _, ndocs, avgdl = artifact_mod.bm25_corpus(art)
        df = art.df
        sidecar = {"shard": 0, "shards": 1, "mode": "round-robin",
                   "total_docs": int(art.max_doc_id), "ndocs": ndocs, "avgdl": avgdl,
                   "gids": list(range(1, int(art.max_doc_id) + 1)),
                   "global_df": {art.term(i).decode("ascii"): int(df[i])
                                 for i in range(art.vocab)}}
    finally:
        art.close()
    (shard / "cluster_shard.json").write_text(json.dumps(sidecar))


@pytest.mark.parametrize("which", ["host", "device", "auto"])
def test_create_engine_routes_sidecar_dirs(built, tmp_path, which):
    """A cluster shard opens the host ``ShardEngine`` under ``host``,
    ``auto`` or no engine named; a named ``device`` raises the JAX
    message; a malformed sidecar raises ``ArtifactError`` as the JAX
    ``load_sidecar`` does."""
    outs, naive = built
    shard = tmp_path / "shard"
    shard.mkdir()
    (shard / "index.mri").write_bytes((outs["3"] / "index.mri").read_bytes())
    _write_one_shard_sidecar(shard, outs["3"])
    if which == "device":
        for target in (shard, shard / "index.mri"):
            with pytest.raises(ArtifactError, match="cluster shard .cluster_shard.json "
                                                    "present.: the device engine serves "
                                                    "plain artifacts only"):
                create_engine(target, which, device="cpu")
    else:
        terms = _words(naive, 6, 3)
        with Engine(outs["3"]) as mono:
            b = mono.encode_batch(terms)
            want = (mono.df(b).tolist(), mono.top_k_scored(b, 7), mono.top_k("c", 4))
        for target, named in ((shard, which), (shard / "index.mri", which), (shard, None)):
            with create_engine(target, named, device="cpu") as e:
                assert type(e) is ShardEngine and e.describe()["engine"] == "shard"
                assert e.describe()["cluster"]["local_docs"] == e.artifact.max_doc_id
                b = e.encode_batch(terms)
                assert (e.df(b).tolist(), e.top_k_scored(b, 7), e.top_k("c", 4)) == want
    (shard / "cluster_shard.json").write_text("{}")
    if which == "device":
        with pytest.raises(ArtifactError, match="the device engine serves plain artifacts"):
            create_engine(shard, which, device="cpu")
    else:
        with pytest.raises(ArtifactError, match="malformed shard sidecar"):
            create_engine(shard, which, device="cpu")
    # a live directory (generation 1 seeded from the artifact by a
    # delete): host and auto open the multi-segment engine, a named
    # device refuses with the JAX message
    seg = tmp_path / "seg"
    seg.mkdir()
    (seg / "index.mri").write_bytes((outs["3"] / "index.mri").read_bytes())
    tsegments.delete_docs(seg, [1])
    if which == "device":
        with pytest.raises(ArtifactError, match="segment-managed: the device engine serves "
                                                "single artifacts only"):
            create_engine(seg, which, device="cpu")
    else:
        with create_engine(seg, which, device="cpu") as e:
            assert type(e) is MultiSegmentEngine and e.describe()["engine"] == "multi"
            assert e.describe()["tombstoned_docs"] == 1


def test_answers_equal_across_engines(built):
    """df, postings, AND, OR and top-k by df the same from all three."""
    outs, naive = built
    engines = [create_engine(outs["2"], w, device="cpu") for w in ("host", "device", "auto")]
    try:
        terms = _words(naive, 200, 12)
        outs_ = []
        for e in engines:
            b = e.encode_batch(terms)
            q = e.encode_batch(terms[:3])
            outs_.append((e.df(b).tolist(),
                          [None if p is None else p.tolist() for p in e.postings(b)],
                          e.query_and(q).tolist(), e.query_or(q).tolist(), e.top_k("c", 5)))
        assert outs_[0] == outs_[1] == outs_[2]
        assert np.asarray(outs_[0][0]).sum() > 0
    finally:
        for e in engines:
            e.close()
