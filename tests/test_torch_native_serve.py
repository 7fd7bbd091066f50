"""The port's native serve kernels (``NativeServe`` over ``mri_serve_*``)
against the JAX package's, call by call, on the same ``index.mri`` (v2
and v2.1): block decode of every term and of mixed selections, postings
decode, the AND kernel against a set oracle, BM25 top-k (direct,
prepared and coalesced) byte for byte with its block accounting — and
the port's native BM25 bit-equal to its numpy BM25 on a corpus whose
document lengths vary widely.

The corpus pins term dfs at the 128-doc block boundaries (1/127/128/
129/256/300) and spreads doc ids so packed delta widths run from 0
(consecutive ids) to the corpus maximum."""

import array
import random

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve import (
    engine as jengine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    Engine,
    artifact as TA,
    artifact_path,
)

from test_torch_serve_device import _build

pytestmark = pytest.mark.serve

NDOCS = 1200
TARGET_DFS = (1, 127, 128, 129, 256, 300)
KS = (1, 10, 128)
MODES = ("exhaustive", "bmw", "maxscore")


def _corpus():
    """Member lists per term (spelled in letters) and the doc blobs;
    tf varies with the doc and the term."""
    rng = random.Random(41)
    members = {}
    for df in TARGET_DFS:
        if df == 1:
            ids = [NDOCS // 2]
        else:
            step = max(1, (NDOCS - 2) // df)
            ids = list(range(1, 1 + step * df, step))[:df]
        members["df" + "".join("abcdefghij"[int(c)] for c in str(df))] = ids
    members["runzero"] = list(range(5, 5 + 300))  # every delta 1: width 0
    g, ids = 1, []
    while g <= NDOCS:                              # geometric gaps: wide
        ids.append(g)
        g = max(g + 1, int(g * 1.9))
    members["wide"] = ids
    members["spread"] = sorted(rng.sample(range(1, NDOCS + 1), 300))
    for t in range(40):
        members["noise" + "abcdefghij"[t // 10] + "abcdefghij"[t % 10]] = \
            sorted(rng.sample(range(1, NDOCS + 1), rng.randint(2, 200)))
    per_doc = [[] for _ in range(NDOCS + 1)]
    for name, docs in members.items():
        for d in docs:
            per_doc[d].extend([name] * (1 + (d * (len(name) + 3)) % 9))
    blobs = []
    for d in range(1, NDOCS + 1):
        toks = per_doc[d] or ["filler"]
        rng.shuffle(toks)
        blobs.append(" ".join(toks).encode())
    return blobs, members


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    blobs, members = _corpus()
    outs = _build(tmp_path_factory.mktemp("tnative"), blobs)
    return outs, members


@pytest.fixture(scope="module", params=["2", "3"], ids=["v2", "v2.1"])
def handles(built, request):
    """(port engine, port handle, JAX engine, JAX handle), native
    required on both sides."""
    outs, members = built
    mp = pytest.MonkeyPatch()
    mp.setenv("MRI_SERVE_NATIVE", "1")
    try:
        port = Engine(artifact_path(outs[request.param]))
        jax_ = jengine.Engine(artifact_path(outs[request.param]))
    finally:
        mp.undo()
    yield port, port._native_handle(), jax_, jax_._native_handle(), members
    port.close()
    jax_.close()


def _lex(engine, word: str) -> int:
    idx, found = engine.lookup(engine.encode_batch([word]))
    assert found[0], word
    return int(idx[0])


def _same(a, b):
    """Tuples of arrays/ints equal element by element (None matches None)."""
    assert (a is None) == (b is None)
    if a is None:
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


def test_library_flags_and_load():
    assert "-ffp-contract=off" in native._CXX_FLAGS
    assert native.load() is not None, native.load_error()


def test_decode_blocks_every_term(handles):
    port, h, _, jh, _ = handles
    art = port.artifact
    widths = set()
    for i in range(art.vocab):
        b0, b1 = int(art.term_block_off[i]), int(art.term_block_off[i + 1])
        if b0 == b1:
            continue
        sel = np.arange(b0, b1, dtype=np.int64)
        widths.update(art.blk_width[sel].tolist())
        got = h.decode_blocks(sel)
        _same(got, jh.decode_blocks(sel))
        ids, tfm, cnt = got
        want_ids, want_cnt = art.decode_blocks(sel)
        want_tf, _ = art.decode_tf_blocks(sel)
        assert np.array_equal(cnt, want_cnt) and np.array_equal(ids, want_ids)
        mask = np.arange(art.block_size)[None, :] < want_cnt[:, None]
        assert np.array_equal(tfm[mask], want_tf[mask]) and (tfm[~mask] == 1).all()
    assert 0 in widths and max(widths) >= 8, widths


def test_decode_mixed_selection(handles):
    port, h, _, jh, _ = handles
    sel = np.random.default_rng(7).permutation(port.artifact.num_blocks)[:200].astype(np.int64)
    _same(h.decode_blocks(sel), jh.decode_blocks(sel))
    _same(h.decode_blocks(sel, want_tf=False), jh.decode_blocks(sel, want_tf=False))
    assert np.array_equal(h.decode_blocks(sel)[0], port.artifact.decode_blocks(sel)[0])


def test_decode_postings(handles):
    port, h, _, jh, members = handles
    for word, docs in members.items():
        i = _lex(port, word)
        df = int(port.artifact.df[i])
        got = h.decode_postings(i, df)
        _same(got, jh.decode_postings(i, df))
        assert got[0].tolist() == docs
        assert np.array_equal(got[1], port.artifact.decode_tf(i))
        assert h.decode_postings(i, df + 1) is None  # a wrong df is refused


def test_and_kernel_against_set_oracle(handles):
    """Candidates that miss every block, fall between members or exceed
    the last block's max."""
    port, h, _, jh, members = handles
    art = port.artifact
    rng = np.random.default_rng(11)
    names = sorted(members)
    for _ in range(60):
        i = _lex(port, names[int(rng.integers(len(names)))])
        cand = np.unique(rng.integers(0, NDOCS + 40, size=int(rng.integers(1, 400)))
                         .astype(np.int32))
        got = h.query_and(cand, i)
        _same(got, jh.query_and(cand, i))
        out, dec, skp = got
        assert np.array_equal(out, np.intersect1d(cand, art.decode_postings(i)))
        b0, b1 = int(art.term_block_off[i]), int(art.term_block_off[i + 1])
        assert dec + skp == b1 - b0 and dec >= 0 and skp >= 0


def _ranked_queries(members):
    rng = random.Random(17)
    names = sorted(members)
    qs = [[n] for n in names[:8]] + [[n, n] for n in names[:4]]
    for _ in range(30):
        qs.append(rng.sample(names, rng.randint(2, 5)))
    return qs


@pytest.mark.parametrize("mode", MODES)
def test_topk_kernel_call_by_call(handles, mode):
    """Direct, prepared and coalesced top-k: the same docs, score bits
    and block accounting as the JAX handle (on v2, with no bound
    columns, a pruned mode scores everything)."""
    port, h, jax_, jh, members = handles
    qs = _ranked_queries(members)
    occs = [[_lex(port, w) for w in q] for q in qs]
    idfs = [[port._term_idf(i) for i in occ] for occ in occs]
    assert idfs == [[jax_._term_idf(i) for i in occ] for occ in occs]
    for k in KS:
        pids, jpids = array.array("q"), array.array("q")
        for occ, idf in zip(occs, idfs):
            got = h.top_k_bm25(occ, idf, k, mode)
            _same(got, jh.top_k_bm25(occ, idf, k, mode))
            pid, jpid = h.prep_query(occ, idf), jh.prep_query(occ, idf)
            fast = h.top_k_bm25_fast(pid, k, mode)
            assert fast == jh.top_k_bm25_fast(jpid, k, mode)
            assert fast[0] == list(zip(got[0].tolist(), got[1].tolist()))
            pids.append(pid)
            jpids.append(jpid)
        modes = array.array("i", [h.MODES[mode]] * len(pids))
        res = h.top_k_bm25_batch(pids, modes, len(pids), k)
        assert res == jh.top_k_bm25_batch(jpids, modes, len(jpids), k)
        assert res[0] == [h.top_k_bm25_fast(p, k, mode)[0] for p in pids]
        h.clear_preps()
        jh.clear_preps()
    assert h.MODES == jh.MODES and h.MODE_NAMES == jh.MODE_NAMES


def test_batch_accounting(handles, monkeypatch):
    """A coalesced group advances the ranked counters by one per query,
    as the serial path does, and lands on the native op counter."""
    port, _, jax_, _, members = handles
    monkeypatch.setenv("MRI_SERVE_PLANNER", "auto")
    names = sorted(members)
    qs = [[n, names[0]] for n in names[:6]]
    for eng in (port, jax_):
        encs = [eng.encode_batch(q) for q in qs]
        for b in encs:  # warm every memo so the group fuses
            eng.top_k_scored(b, 5)
        before = eng.planner.describe()
        ops0 = eng.describe()["native"]["ops"]
        eng.top_k_scored_batch(encs, 5)
        after = eng.planner.describe()
        assert sum(after["ranked"].values()) == sum(before["ranked"].values()) + len(qs)
        assert eng.describe()["native"]["ops"] == ops0 + len(qs)
        assert after["last_ranked"]["backend"] == "native"
    assert port.planner.describe() == jax_.planner.describe()


def test_native_required_without_library(built, monkeypatch):
    outs, _ = built
    monkeypatch.setenv("MRI_SERVE_NATIVE", "0")
    with Engine(outs["3"]) as eng:
        eng.top_k_scored(eng.encode_batch(["spread"]), 3)
        assert eng.describe()["native"] == {"mode": "0", "active": False, "error": None,
                                            "ops": 0, "fallbacks": 0}
    monkeypatch.setenv("MRI_SERVE_NATIVE", "1")
    monkeypatch.setattr(native, "load", lambda *a, **kw: None)
    with pytest.raises(RuntimeError, match="MRI_SERVE_NATIVE=1"):
        Engine(outs["3"])


def test_serve_columns_are_views(built):
    """The kernels read one word past each run: the columns must be views
    into the mapped file, never trimmed copies."""
    outs, _ = built
    with TA.load_artifact(outs["3"]) as art:
        cols = TA.serve_columns(art)
        for name in ("post_words", "tf_words", "blk_max", "blk_first", "blk_width"):
            assert not cols[name].flags.owndata, name
        assert cols["blk_max_tf"] is not None and cols["blk_max_tf"].dtype == np.uint8
    with TA.load_artifact(outs["2"]) as art:
        assert TA.serve_columns(art)["blk_max_tf"] is None
    with TA.load_artifact(outs["1"]) as art, pytest.raises(TA.ArtifactError, match="v2"):
        TA.serve_columns(art)


@pytest.fixture(scope="module")
def varied(tmp_path_factory):
    """Doc lengths from 1 to about 3,000 tokens and tf from 1 to 60."""
    rng = random.Random(77)
    words = ["alpha", "beta", "gamma", "delta", "omega", "kappa", "sigma", "theta"]
    docs = []
    for d in range(400):
        n = int(rng.paretovariate(0.9)) % 3000 + 1
        toks = [rng.choice(words[: 1 + d % len(words)]) for _ in range(n)]
        toks += ["sigma"] * (d % 60)
        rng.shuffle(toks)
        docs.append(" ".join(toks).encode())
    return _build(tmp_path_factory.mktemp("tvaried"), docs)


@pytest.mark.parametrize("fmt", ["2", "3"])
@pytest.mark.parametrize("planner", ["exhaustive", "bmw", "maxscore", "auto"])
def test_native_bm25_bit_equal_numpy(varied, fmt, planner, monkeypatch):
    """The same engine class with the native kernels on and off: every
    (doc, score) pair equal, float bits included."""
    monkeypatch.setenv("MRI_SERVE_PLANNER", planner)
    engines = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("MRI_SERVE_NATIVE", mode)
        engines[mode] = Engine(varied[fmt])
    lens = engines["0"]._bm25_corpus()[0]
    assert lens[lens > 0].min() < 5 and lens.max() > 500  # lengths do vary
    words = ["alpha", "beta", "gamma", "delta", "omega", "kappa", "sigma", "theta"]
    rng = random.Random(3)
    for _ in range(30):
        q = [rng.choice(words) for _ in range(rng.randint(1, 5))]
        for k in (1, 10, 100):
            num = engines["0"].top_k_scored(engines["0"].encode_batch(q), k)
            nat = engines["1"].top_k_scored(engines["1"].encode_batch(q), k)
            assert [(d, np.float64(s).tobytes()) for d, s in nat] == \
                [(d, np.float64(s).tobytes()) for d, s in num], (q, k)
    assert engines["1"].describe()["native"]["ops"] > 0
    assert engines["1"].describe()["native"]["fallbacks"] == 0
    for eng in engines.values():
        eng.close()
