"""Every single-device build plan of the port with ``artifact=True``
writes an ``index.mri`` byte-equal to the JAX package's same plan, in
formats v1, v2 and v2.1, on a seeded Zipf corpus and on the smoke
fixture, beside letter files equal to the JAX package's.

The plans: one-shot, pipelined, streaming, all-device, streaming
all-device, the two width-8 ``WidthOverflow`` restarts, and the oracle.
The streaming all-device plan and its restart are held against the JAX
plan they must equal (pipelined and streaming): on JAX's CPU backend the
JAX streaming all-device plan's window ring can refill a buffer a queued
program still reads."""

from pathlib import Path

import numpy as np
import pytest

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import native as jnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native as tnative
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    artifact as TA,
)

from conftest import read_letter_files

SMOKE = Path(__file__).resolve().parent / "fixtures" / "smoke"

pytestmark = [
    pytest.mark.serve,
    pytest.mark.skipif(not (tnative.available() and jnative.available()),
                       reason="no C++ toolchain"),
]

# plan -> (port config, JAX config of the plan it must equal)
PLANS = {
    "one_shot": ({"pipeline_chunk_docs": 0}, {"pipeline_chunk_docs": 0}),
    "pipelined": ({}, {}),
    "streaming": ({"stream_chunk_docs": 7}, {"stream_chunk_docs": 7}),
    "all_device": ({"device_tokenize": True}, {"device_tokenize": True}),
    "stream_all_device": ({"device_tokenize": True, "stream_chunk_docs": 7}, {}),
    "width8_restart": ({"device_tokenize": True, "device_tokenize_width": 8},
                       {"device_tokenize": True, "device_tokenize_width": 8}),
    "stream_width8_restart": ({"device_tokenize": True, "stream_chunk_docs": 7,
                               "device_tokenize_width": 8}, {"stream_chunk_docs": 7}),
    "oracle": ({"backend": "oracle"}, {"backend": "oracle"}),
}


def _port_cfg(kw):
    kw = dict(kw, artifact=True)
    if kw.get("backend") != "oracle":
        kw.update(device="cpu", pad_multiple=64)
    return tpkg.IndexConfig(**kw)


def _jax_cfg(kw):
    kw = dict(kw, artifact=True)
    if kw.get("backend") != "oracle":
        kw.update(backend="tpu", device_shards=1, pad_multiple=64)
    return JaxConfig(**kw)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("art_plans")
    paths = tsyn.write_corpus(root / "zipf", tsyn.zipf_corpus(
        num_docs=30, vocab_size=400, tokens_per_doc=60, seed=9))
    tman.write_manifest(root / "zipf.txt", paths)
    return {"zipf": root / "zipf.txt", "smoke": SMOKE / "manifest.txt"}


@pytest.mark.parametrize("fmt", ["1", "2", "3"])
@pytest.mark.parametrize("corpus", ["zipf", "smoke"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plan_artifact_equals_jax(plan, corpus, fmt, corpora, tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SERVE_FORMAT", fmt)
    monkeypatch.chdir(corpora[corpus].parent)  # the smoke manifest's paths are relative
    port_kw, jax_kw = PLANS[plan]
    st = tpkg.build_index(tpkg.read_manifest(corpora[corpus]), _port_cfg(port_kw),
                          output_dir=str(tmp_path / "t"))
    jpkg.build_index(jpkg.read_manifest(corpora[corpus]), _jax_cfg(jax_kw),
                     output_dir=str(tmp_path / "j"))
    assert read_letter_files(tmp_path / "t") == read_letter_files(tmp_path / "j")
    got = (tmp_path / "t" / "index.mri").read_bytes()
    assert got == (tmp_path / "j" / "index.mri").read_bytes()
    assert st["artifact_bytes"] == len(got) and st["artifact_build_ms"] >= 0
    if plan.endswith("restart") and corpus == "zipf":
        assert "device_tokenize_fallback" in st
    with TA.load_artifact(tmp_path / "t") as art:
        assert art.version == int(fmt)


def test_empty_corpus_artifact_equals_jax(tmp_path, monkeypatch):
    """The empty-corpus branches pack an artifact too (from no groups)."""
    paths = tsyn.write_corpus(tmp_path / "docs", [b"123 456", b"--- !!!"])
    tman.write_manifest(tmp_path / "list.txt", paths)
    for plan in ("pipelined", "one_shot", "streaming", "all_device", "stream_all_device"):
        port_kw, _ = PLANS[plan]
        tpkg.build_index(tpkg.read_manifest(tmp_path / "list.txt"), _port_cfg(port_kw),
                         output_dir=str(tmp_path / plan))
        assert (tmp_path / plan / "index.mri").exists(), plan
    jpkg.build_index(jpkg.read_manifest(tmp_path / "list.txt"), _jax_cfg({}),
                     output_dir=str(tmp_path / "jax"))
    want = (tmp_path / "jax" / "index.mri").read_bytes()
    for plan in ("pipelined", "one_shot", "streaming", "all_device", "stream_all_device"):
        assert (tmp_path / plan / "index.mri").read_bytes() == want, plan
    with TA.load_artifact(tmp_path / "jax") as art:
        assert art.vocab == 0 and np.array_equal(art.letter_dir, np.zeros(27))
