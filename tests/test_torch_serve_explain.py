"""Cost attribution of the port's ``DeviceEngine``: under
``obs.attribution.collect`` it reports what the JAX ``DeviceEngine``
reports on the same artifact — the resolved terms (path ``device``), the
decoded blocks and bytes, and the ranked planner's theta — for a df
batch, a postings batch and a BM25 ``top_k_scored`` call under each
planner, in formats v1, v2 and v2.1 (the JAX package's cpu-backend
builds, which carry real term frequencies).  The whole report must be
equal; the port's registry counters must equal the report's totals."""

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.obs import (
    attribution as jattrib,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.device_engine import (
    DeviceEngine as JDevice,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.obs import (
    attribution as tattrib,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    DeviceEngine,
    artifact_path,
)

from test_torch_serve_device import FORMATS, _build, _naive

pytestmark = [pytest.mark.serve, pytest.mark.attrib]

OPS = ("df", "postings", "bm25-exhaustive", "bm25-bmw", "bm25-maxscore", "bm25-auto")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    docs = tsyn.zipf_corpus(num_docs=300, vocab_size=2000, tokens_per_doc=60, seed=5)
    outs = _build(tmp_path_factory.mktemp("explain"), docs)
    naive = _naive(docs)
    hot = sorted(naive, key=lambda w: (-len(naive[w]), w))
    pairs = {f: (DeviceEngine(artifact_path(outs[f]), device="cpu"),
                 JDevice(artifact_path(outs[f]))) for f in FORMATS}
    yield pairs, hot
    for port, jax in pairs.values():
        port.close()
        jax.close()


def _run(eng, op, terms):
    batch = eng.encode_batch(terms)
    if op == "df":
        return eng.df(batch).tolist()
    if op == "postings":
        return [None if r is None else r.tolist() for r in eng.postings(batch)]
    return eng.top_k_scored(batch, 10)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_device_engine_explain_matches_jax(engines, fmt, op, monkeypatch):
    pairs, hot = engines
    port, jax = pairs[fmt]
    if op.startswith("bm25"):
        monkeypatch.setenv("MRI_SERVE_PLANNER", op.split("-")[1])
        terms = [hot[0], hot[3], hot[60], hot[0]]
    else:
        terms = hot[:5] + ["nosuchword", hot[200], hot[-1]]
    before = {k: port.metrics.counter(k).value for k in (
        "mri_engine_blocks_decoded_total", "mri_engine_bytes_decoded_total",
        "mri_engine_blocks_skipped_total")}
    with tattrib.collect(op) as tcoll:
        got = _run(port, op, terms)
    with jattrib.collect(op) as jcoll:
        want = _run(jax, op, terms)
    trep, jrep = tcoll.report(), jcoll.report()
    if op.startswith("bm25"):
        assert [d for d, _ in got] == [d for d, _ in want]
        assert np.allclose([s for _, s in got], [s for _, s in want], rtol=1e-4)
        assert trep["planner"]["theta"] == jrep["planner"]["theta"]
    else:
        assert got == want
    assert [t["path"] for t in trep["terms"]] == ["device"] * len(terms)
    assert trep == jrep
    totals = trep["totals"]
    assert totals["blocks_decoded"] > 0 or op == "df"
    # every feed sits beside its registry counter
    assert port.metrics.counter("mri_engine_blocks_decoded_total").value \
        - before["mri_engine_blocks_decoded_total"] == totals["blocks_decoded"]
    assert port.metrics.counter("mri_engine_bytes_decoded_total").value \
        - before["mri_engine_bytes_decoded_total"] == totals["bytes_decoded"]
    assert port.metrics.counter("mri_engine_blocks_skipped_total").value \
        - before["mri_engine_blocks_skipped_total"] == totals["blocks_skipped"]
