"""The port's ``ServeDaemon`` on the card: the default engine is the
``DeviceEngine`` on ``cuda``, its answers equal the host engine's over
the protocol (df, postings, AND, OR, top-k, BM25 within rel 1e-5), five
hot reloads leave the allocated device memory within one engine's
``column_bytes`` of its level after the first, ``shards=4`` puts four
logical shards on the card(s) with the same answers, and the explain
report names the ``device`` path.  Every test needs a CUDA device and
skips without one; none needs JAX:
``python -m pytest --noconftest tests/test_torch_cuda_daemon.py -m cuda``."""

import contextlib
import json
import math
import socket

import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import Engine
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
    ServeDaemon,
)

pytestmark = [pytest.mark.cuda, pytest.mark.daemon, pytest.mark.serve]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    _need_cuda()
    root = tmp_path_factory.mktemp("cuda_daemon")
    docs = tsyn.zipf_corpus(num_docs=2000, vocab_size=20000, tokens_per_doc=120, seed=3)
    tman.write_manifest(root / "list.txt", tsyn.write_corpus(root / "docs", docs))
    assert tcli.main(["1", "1", str(root / "list.txt"), "--device", "cpu", "--artifact",
                      "--output-dir", str(root / "out")]) == 0
    return root / "out"


@contextlib.contextmanager
def serving(out, **kw):
    d = ServeDaemon(str(out), coalesce_us=200, **kw)
    d.start()
    try:
        yield d
    finally:
        d.drain()


def _exchange(d, reqs):
    """Pipelined requests; the answers in request order (the daemon
    answers a coalesced batch in the order it finishes them)."""
    with socket.create_connection(d.address, timeout=60) as s, s.makefile("rb") as f:
        for r in reqs:
            s.sendall((json.dumps(r) + "\n").encode())
        by_id = {a["id"]: a for a in (json.loads(f.readline()) for _ in reqs)}
    return [by_id[r["id"]] for r in reqs]


def _requests(out):
    with Engine(out) as host:
        art = host.artifact
        terms = [art.term(i).decode() for i in range(0, host.vocab_size, 37)]
    reqs = [{"id": 1, "op": "df", "terms": terms}, {"id": 2, "op": "postings", "terms": terms[:64]},
            {"id": 3, "op": "and", "terms": terms[:2]}, {"id": 4, "op": "or", "terms": terms[3:6]},
            {"id": 5, "op": "top_k", "letter": "m", "k": 10}]
    reqs += [{"id": 10 + i, "op": "top_k", "score": "bm25", "k": 10, "terms": terms[i:i + 3]}
             for i in range(0, 30, 3)]
    return reqs


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = {k: v for k, v in g.items() if k != "trace_id"}
        w = {k: v for k, v in w.items() if k != "trace_id"}
        if "docs" in w and w["docs"] and isinstance(w["docs"][0], list):
            assert [d for d, _ in g.pop("docs")] == [d for d, _ in w.pop("docs")]
        assert g == w


def test_daemon_on_the_card_matches_host(out):
    _need_cuda()
    reqs = _requests(out)
    with serving(out, engine="host") as hd:
        want = _exchange(hd, reqs)
    with serving(out) as d:  # the default: the device engine on cuda
        desc = d.stats()["engine"]
        assert desc["engine"] == "device" and desc["device"]["platform"] == "cuda"
        got = _exchange(d, reqs)
        ex = _exchange(d, [dict(reqs[-1], id=99, explain=True)])[0]["explain"]
    _same(got, want)
    for g, w in zip(got, want):
        if "docs" in w and w["docs"] and isinstance(w["docs"][0], list):
            assert all(math.isclose(a[1], b[1], rel_tol=1e-5) for a, b in zip(g["docs"], w["docs"]))
    assert {t["path"] for t in ex["terms"]} == {"device"} and ex["totals"]["blocks_decoded"] > 0


def test_reloads_free_the_old_columns(out):
    _need_cuda()
    with serving(out, engine="device") as d:
        _exchange(d, [{"id": 0, "op": "df", "terms": ["a"]}])
        assert _exchange(d, [{"id": 1, "op": "reload"}])[0]["reloaded"]
        torch.cuda.synchronize()
        level = torch.cuda.memory_allocated()
        column_bytes = d.stats()["engine"]["device"]["column_bytes"]
        for i in range(4):
            assert _exchange(d, [{"id": 2 + i, "op": "reload"}])[0]["reloaded"]
        torch.cuda.synchronize()
        assert abs(torch.cuda.memory_allocated() - level) <= column_bytes
        assert d.stats()["counters"]["reload_ok"] == 5


def test_four_shards_on_the_card(out):
    _need_cuda()
    reqs = _requests(out)
    with serving(out, engine="device", shards=1) as d1:
        want = _exchange(d1, reqs)
    with serving(out, engine="device", shards=4) as d4:
        assert d4.stats()["engine"]["device"]["shards"] == 4
        got = _exchange(d4, reqs)
    # the ranked tail runs on the first shard: the same bits at every N
    assert [{k: v for k, v in g.items() if k != "trace_id"} for g in got] == \
        [{k: v for k, v in w.items() if k != "trace_id"} for w in want]
