"""The torch ``DeviceEngine`` on the card against the same engine on the
CPU (its plain version), on artifacts of formats v1, v2 and v2.1 (one
v2.1 file with term frequencies above 1 and 16-bit score columns):
df, postings, AND, OR and top-k equal at batches 1 to 8192; BM25 docs
equal and scores within rel 1e-5 under each planner; BM25 bit-equal from
run to run on the card; and every public op under
``torch.cuda.set_sync_debug_mode("error")``, so none waits for the card
beyond its explicit fetches.  Then the router on the card: ``auto``
with its device engine on ``cuda`` (small batches on the host, one probe
at 8192, ``MRI_SERVE_CROSSOVER`` 1 and 0), ``create_engine``'s default
and the ``query`` CLI's three engines printing the same bytes.  Every
test needs a CUDA device and skips without one; none needs JAX:
``python -m pytest --noconftest tests/test_torch_cuda_serve.py -m cuda``."""

import random

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    AutoEngine,
    DeviceEngine,
    Engine,
    artifact as TA,
    create_engine,
)

pytestmark = [pytest.mark.cuda, pytest.mark.serve]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _tf_artifact(path, seed=4):
    """A v2.1 artifact with 16-bit score columns and tf up to 300, from
    seeded lex-order arrays."""
    rng = np.random.default_rng(seed)
    words = sorted({bytes(rng.integers(97, 123, rng.integers(1, 12)).tolist())
                    for _ in range(500)})
    V, max_doc = len(words), 3000
    df = rng.integers(1, 1500, V)
    term_offsets = np.zeros(V + 1, np.int64)
    np.cumsum([len(w) for w in words], out=term_offsets[1:])
    post_offsets = np.zeros(V + 1, np.int64)
    np.cumsum(df, out=post_offsets[1:])
    flat = np.concatenate([np.sort(rng.choice(np.arange(1, max_doc + 1), d, replace=False))
                           for d in df]).astype(np.int32)
    letters = np.frombuffer(b"".join(w[:1] for w in words), np.uint8)
    TA.pack_v2(path, term_blob=np.frombuffer(b"".join(words), np.uint8),
               term_offsets=term_offsets, df=df, post_offsets=post_offsets, postings=flat,
               df_order=np.lexsort((-df, letters)), max_doc_id=max_doc, fmt=3,
               score_bits=16, tf=rng.integers(1, 301, len(flat)).astype(np.int32))
    return [w.decode() for w in words]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Port ``--artifact`` builds (v1, v2, v2.1) of a seeded Zipf corpus
    on the CPU, and the tf-carrying v2.1 file."""
    root = tmp_path_factory.mktemp("cuda_serve")
    docs = tsyn.zipf_corpus(num_docs=300, vocab_size=2000, tokens_per_doc=200, seed=13)
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for fmt in ("1", "2", "3"):
            mp.setenv("MRI_SERVE_FORMAT", fmt)
            assert tcli.main(["1", "1", str(root / "list.txt"), "--device", "cpu",
                              "--artifact", "--output-dir", str(root / f"v{fmt}")]) == 0
            out[fmt] = root / f"v{fmt}"
    finally:
        mp.undo()
    vocab = sorted({w.decode() for d in docs for w in d.split()})
    out["tf"] = root / "tf.mri"
    tf_vocab = _tf_artifact(out["tf"])
    return out, {"1": vocab, "2": vocab, "3": vocab, "tf": tf_vocab}


KINDS = ["1", "2", "3", "tf"]


def _pair(artifacts, kind):
    paths, vocabs = artifacts
    return (DeviceEngine(paths[kind], device="cuda"), DeviceEngine(paths[kind], device="cpu"),
            vocabs[kind])


def _terms(vocab, n, seed):
    rng = random.Random(seed)
    junk = ["", "zzzznope", "Aardvark!!", "x1y2", "a" * 60, "THE"]
    return [vocab[rng.randrange(len(vocab))] if rng.random() < 0.85
            else junk[rng.randrange(len(junk))] for _ in range(n)]


def _queries(vocab, seed):
    rng = random.Random(seed)
    return [rng.sample(vocab[:400], n) for n in (1, 2, 2, 3, 5)] + [[vocab[0], vocab[0]]]


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_engine_matches_cpu_engine(artifacts, kind):
    _need_cuda()
    gpu, cpu, vocab = _pair(artifacts, kind)
    try:
        for n in (1, 32, 1024, 8192):
            b = gpu.encode_batch(_terms(vocab, n, n))
            assert gpu.df(b).tolist() == cpu.df(b).tolist()
            gi, gf = gpu.lookup(b)
            ci, cf = cpu.lookup(b)
            assert gf.tolist() == cf.tolist() and gi[gf].tolist() == ci[cf].tolist()
            for g, c in zip(gpu.postings(b), cpu.postings(b)):
                assert (g is None and c is None) or np.array_equal(g, c)
        for q in _queries(vocab, 1):
            b = gpu.encode_batch(q)
            assert gpu.query_and(b).tolist() == cpu.query_and(b).tolist()
            assert gpu.query_or(b).tolist() == cpu.query_or(b).tolist()
        for li in range(26):
            assert gpu.top_k(li, 7) == cpu.top_k(li, 7)
        assert gpu.describe()["device"]["platform"] == "cuda"
    finally:
        gpu.close()
        cpu.close()


@pytest.mark.parametrize("planner", ["exhaustive", "bmw", "maxscore"])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_bm25_matches_cpu_and_repeats_bit_equal(artifacts, kind, planner, monkeypatch):
    _need_cuda()
    monkeypatch.setenv("MRI_SERVE_PLANNER", planner)
    gpu, cpu, vocab = _pair(artifacts, kind)
    try:
        for q in _queries(vocab, 2):
            b = gpu.encode_batch(q)
            for k in (1, 10, 100):
                got = gpu.top_k_scored(b, k)
                want = cpu.top_k_scored(b, k)
                assert [d for d, _ in got] == [d for d, _ in want], (q, k)
                for (_, gs), (_, ws) in zip(got, want):
                    assert gs == pytest.approx(ws, rel=1e-5), (q, k)
                for _ in range(2):
                    again = gpu.top_k_scored(b, k)
                    assert [(d, np.float32(s).tobytes()) for d, s in again] == \
                        [(d, np.float32(s).tobytes()) for d, s in got], (q, k)
    finally:
        gpu.close()
        cpu.close()


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_ops_never_wait_for_the_card(artifacts, kind, monkeypatch):
    """Every public op runs under sync-debug "error": the uploads are
    pinned and non-blocking, and the only waits are the explicit result
    fetches (pinned copies and an event)."""
    _need_cuda()
    paths, vocabs = artifacts
    vocab = vocabs[kind]
    eng = DeviceEngine(paths[kind], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = eng.encode_batch(_terms(vocab, 1024, 3))
        eng.df(b)
        eng.lookup(b)
        eng.postings(b)
        q = eng.encode_batch(vocab[:3])
        eng.query_and(q)
        eng.query_or(q)
        eng.top_k("a", 5)
        for planner in ("exhaustive", "bmw", "maxscore"):
            monkeypatch.setenv("MRI_SERVE_PLANNER", planner)
            eng.top_k_scored(q, 10)
        eng.describe()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        eng.close()


def _device_calls(auto):
    dev = auto.device_engine
    return 0 if dev is None else sum(v["calls"] for v in dev.op_stats().values())


@pytest.mark.parametrize("kind", ["1", "3"])
def test_cuda_auto_probe_and_routing(artifacts, kind, monkeypatch):
    _need_cuda()
    monkeypatch.delenv("MRI_SERVE_CROSSOVER", raising=False)
    paths, vocabs = artifacts
    vocab = vocabs[kind]
    with AutoEngine(paths[kind]) as auto, Engine(paths[kind]) as host:
        for n in (1, 32, 1024):
            b = auto.encode_batch(_terms(vocab, n, n))
            assert auto.df(b).tolist() == host.df(b).tolist()
        assert auto.device_engine is None
        b = auto.encode_batch(_terms(vocab, 8192, 9))
        assert auto.df(b).tolist() == host.df(b).tolist()
        d = auto.describe()["auto"]
        assert d["device_ready"]
        assert d["probe"]["batch"] == 8192 and d["probe"]["winner"] in ("host", "device")
        assert auto.device_engine.describe()["device"]["platform"] == "cuda"
        for g, h in zip(auto.postings(b[:500]), host.postings(b[:500])):
            assert (g is None and h is None) or np.array_equal(g, h)
        q = auto.encode_batch(vocab[:3])
        assert auto.query_and(q).tolist() == host.query_and(q).tolist()
        assert auto.top_k_scored(q, 10) == host.top_k_scored(q, 10)


@pytest.mark.parametrize("kind", ["2", "3"])
def test_cuda_auto_crossover_knob(artifacts, kind, monkeypatch):
    _need_cuda()
    paths, vocabs = artifacts
    vocab = vocabs[kind]
    monkeypatch.setenv("MRI_SERVE_CROSSOVER", "1")
    with AutoEngine(paths[kind]) as auto, Engine(paths[kind]) as host:
        for n in (1, 7, 64):
            b = auto.encode_batch(_terms(vocab, n, n + 2))
            before = _device_calls(auto)
            assert auto.df(b).tolist() == host.df(b).tolist()
            for g, h in zip(auto.postings(b), host.postings(b)):
                assert (g is None and h is None) or np.array_equal(g, h)
            assert _device_calls(auto) == before + 2
    monkeypatch.setenv("MRI_SERVE_CROSSOVER", "0")
    with AutoEngine(paths[kind]) as auto:
        auto.df(auto.encode_batch(_terms(vocab, 8192, 1)))
        assert auto.describe()["auto"]["device_ready"] is False


def test_cuda_create_engine_default_is_the_card(artifacts, monkeypatch):
    _need_cuda()
    monkeypatch.delenv("MRI_SERVE_ENGINE", raising=False)
    with create_engine(artifacts[0]["3"]) as eng:
        assert type(eng) is DeviceEngine
        assert eng.describe()["device"]["platform"] == "cuda"


@pytest.mark.parametrize("kind", ["1", "2", "3"])
def test_cuda_query_cli_engines_print_the_same(artifacts, kind, monkeypatch):
    _need_cuda()
    import contextlib
    import io

    monkeypatch.delenv("MRI_SERVE_ENGINE", raising=False)
    paths, vocabs = artifacts
    vocab = vocabs[kind]
    words = [vocab[3], "Zebra", "nope", vocab[-1], "x1y2", vocab[40], vocab[3]]

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tcli.main(argv)
        return rc, out.getvalue()

    for extra in ([], ["--op", "and"], ["--op", "or"], ["--top-k", "5", "--letter", "b"]):
        got = {e: run(["query", str(paths[kind]), "--engine", e, *words, *extra])
               for e in ("host", "device", "auto")}
        assert got["host"][0] == 0 and got["host"][1]
        assert got["host"] == got["device"] == got["auto"], extra
