"""The port's torch ``DeviceEngine`` on the CPU against the JAX package's
``DeviceEngine`` and host ``Engine`` on the same artifacts, in formats
v1, v2 and v2.1 (the JAX package's ``backend="cpu"`` builds, which carry
real term frequencies).

df, postings, AND, OR and top-k must be byte-equal at batches 1, 32,
1024 and 8192, the shared-prefix corpus included.  The fixtures here
also serve ``test_torch_serve_compound.py`` (AND, OR, BM25 under each planner) and
``test_torch_serve_cli.py`` (the ``query`` CLI).  Query terms are drawn
from a seed."""

import random
import re

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve import Engine as JHost
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.device_engine import (
    DeviceEngine as JDevice,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models.inverted_index import (
    DeviceUnavailable,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    ArtifactError,
    DeviceEngine,
    artifact_path,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text.tokenizer import (
    clean_token,
)

pytestmark = pytest.mark.serve

FORMATS = ("1", "2", "3")
_WS = re.compile(rb"[ \t\n\v\f\r]+")

#: >= 3 vocabulary terms sharing one 8-byte prefix (the lookup's
#: shared-prefix arm), the bare prefix, a shorter sibling, neighbours
PREFIX_DOCS = [
    b"aaaaaaaab aaaaaaaac common one",
    b"aaaaaaaad aaaaaaaab common two",
    b"aaaaaaaa aaaaaaa aaaaaaaabzz three",
    b"aaaaaaab aaaaaaaac zebra common",
]


def _naive(docs) -> dict[str, list[int]]:
    post: dict[str, set[int]] = {}
    for doc_id, blob in enumerate(docs, start=1):
        for raw in _WS.split(blob):
            w = clean_token(raw)
            if w:
                post.setdefault(w, set()).add(doc_id)
    return {t: sorted(d) for t, d in post.items()}


def _build(root, docs):
    """The JAX package's cpu-backend ``--artifact`` build, per format."""
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    mp = pytest.MonkeyPatch()
    try:
        for fmt in FORMATS:
            mp.setenv("MRI_SERVE_FORMAT", fmt)
            assert jcli.main(["1", "1", str(root / "list.txt"), "--backend", "cpu",
                              "--artifact", "--output-dir", str(root / f"v{fmt}")]) == 0
    finally:
        mp.undo()
    return {fmt: root / f"v{fmt}" for fmt in FORMATS}


class Trio:
    def __init__(self, out):
        self.out = out
        self.port = DeviceEngine(artifact_path(out), device="cpu")
        self.jdev = JDevice(artifact_path(out))
        self.host = JHost(artifact_path(out))

    def close(self):
        for e in (self.port, self.jdev, self.host):
            e.close()


@pytest.fixture(scope="module")
def zipf(tmp_path_factory):
    docs = tsyn.zipf_corpus(num_docs=60, vocab_size=900, tokens_per_doc=150, seed=11)
    docs.append(b"zebra zebra zebra apple apple quokka " * 30)  # tf > 1
    outs = _build(tmp_path_factory.mktemp("tserve_zipf"), docs)
    trios = {fmt: Trio(out) for fmt, out in outs.items()}
    yield trios, _naive(docs)
    for t in trios.values():
        t.close()


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    outs = _build(tmp_path_factory.mktemp("tserve_prefix"), PREFIX_DOCS)
    trios = {fmt: Trio(out) for fmt, out in outs.items()}
    yield trios, _naive(PREFIX_DOCS)
    for t in trios.values():
        t.close()


def _assert_single_term(trio, naive, terms):
    b = trio.port.encode_batch(terms)
    assert (b == trio.jdev.encode_batch(terms)).all()
    d = trio.port.df(b)
    assert d.dtype == np.int64
    assert d.tolist() == trio.jdev.df(b).tolist() == trio.host.df(b).tolist()
    idx, found = trio.port.lookup(b)
    jidx, jfound = trio.jdev.lookup(b)
    assert found.tolist() == jfound.tolist()
    assert idx[found].tolist() == jidx[jfound].tolist()
    for t, p, j, h in zip(terms, trio.port.postings(b), trio.jdev.postings(b),
                          trio.host.postings(b)):
        want = naive.get(t)
        if want is None or t == "":
            assert p is None and j is None and h is None, t
        else:
            assert p.dtype == j.dtype == np.int32, t
            assert p.tolist() == want and np.array_equal(p, j) and np.array_equal(p, h), t


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("batch", [1, 32, 1024, 8192])
def test_df_postings_lookup_parity(zipf, fmt, batch):
    trios, naive = zipf
    vocab = sorted(naive)
    rng = random.Random(batch)
    junk = ["", "zzzznope", "Aardvark!!", "x1y2z3q4", "a" * 40, "THE"]
    terms = [vocab[rng.randrange(len(vocab))] if rng.random() < 0.8
             else junk[rng.randrange(len(junk))] for _ in range(batch)]
    _assert_single_term(trios[fmt], naive, terms)


@pytest.mark.parametrize("fmt", FORMATS)
def test_top_k_parity(zipf, fmt):
    trio = zipf[0][fmt]
    for li in range(26):
        for k in (0, 1, 3, 1000):
            assert trio.port.top_k(li, k) == trio.jdev.top_k(li, k) == trio.host.top_k(li, k)
    assert trio.port.top_k("z", 2) == trio.jdev.top_k("z", 2)
    with pytest.raises(ValueError):
        trio.port.top_k("1", 3)


def test_empty_batch(zipf):
    port = zipf[0]["3"].port
    empty = port.encode_batch([])
    assert port.df(empty).tolist() == []
    assert port.postings(empty) == []
    assert port.query_and(empty).tolist() == []
    assert port.query_or(empty).tolist() == []
    assert port.top_k_scored(empty, 5) == []


@pytest.mark.parametrize("fmt", FORMATS)
def test_shared_prefix_parity(prefix, fmt):
    trios, naive = prefix
    trio = trios[fmt]
    assert trio.port._group == trio.jdev._group >= 4
    probes = ["aaaaaaaa", "aaaaaaa", "aaaaaaaab", "aaaaaaaabzz", "aaaaaaaac", "aaaaaaaad",
              "aaaaaaab", "aaaaaaaae", "aaaaaaaaz", "common", "zebra", "aaaaaaaabz"]
    _assert_single_term(trio, naive, probes)
    for t in probes:
        _assert_single_term(trio, naive, [t])
    for terms in (["aaaaaaaab", "aaaaaaaac"], ["aaaaaaaa", "aaaaaaaad"],
                  ["aaaaaaaab", "common", "aaaaaaaad"]):
        b = trio.port.encode_batch(terms)
        assert trio.port.query_and(b).tolist() == trio.host.query_and(b).tolist()
        assert trio.port.query_or(b).tolist() == trio.host.query_or(b).tolist()


def test_describe_keys(zipf):
    trio = zipf[0]["3"]
    got, want = trio.port.describe(), trio.jdev.describe()
    assert set(got) == set(want)
    assert set(got["cache"]) == set(want["cache"])
    assert set(got["planner"]) == set(want["planner"])
    # port-only: name, column_bytes; JAX-only: jit_functions, jit_cache_entries
    assert set(got["device"]) == (set(want["device"]) - {"jit_functions", "jit_cache_entries"}) \
        | {"name", "column_bytes"}
    assert got["device"]["platform"] == "cpu" and got["device"]["shards"] == 1
    assert got["device"]["tiers"] == want["device"]["tiers"]
    assert got["vocab"] == want["vocab"] and got["format"] == want["format"] == 3
    assert got["device"]["column_bytes"] > 0


def test_engine_refusals(zipf, tmp_path, monkeypatch):
    out = zipf[0]["3"].out
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable):
            DeviceEngine(out)
    monkeypatch.setenv("MRI_SERVE_SHARDS", "2")
    with pytest.raises(ValueError, match="A10"):
        DeviceEngine(out, device="cpu")
    monkeypatch.delenv("MRI_SERVE_SHARDS")
    (tmp_path / "segments.manifest.json").write_text("{}")
    with pytest.raises(ArtifactError, match="segment-managed"):
        DeviceEngine(tmp_path, device="cpu")
    with pytest.raises(ArtifactError, match="cannot open"):
        DeviceEngine(tmp_path / "nowhere", device="cpu")
