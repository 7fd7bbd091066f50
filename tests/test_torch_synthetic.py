"""The port's virtual manifests (``corpus/synthetic.py``
``SyntheticManifest``, ``corpus/virtualseq.py``), the fingerprint of a
virtual corpus, and the last public-API gaps (``tokenize_corpus``,
``TokenizedCorpus.vocab_strings``, ``DeviceEngine.cache``), each against
the JAX package on the same inputs.

A virtual manifest's paths are placeholders, equal for any two corpora
of one size, so its checkpoint fingerprint must hash the generator's
parameters (``fingerprint_extra``) as the JAX package does: otherwise a
resume can mix windows from two generators, and no checkpoint of a
virtual corpus loads across the packages."""

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import (
    IndexConfig as JConfig,
    build_index as jbuild,
    tokenize_corpus as jtokenize_corpus,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    manifest as jman,
    synthetic as jsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.utils import (
    checkpoint as jckpt,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus.virtualseq import (
    VirtualSeq,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import (
    checkpoint as tckpt,
)

from conftest import read_letter_files

# (num_docs, vocab_size, tokens_per_doc, alpha, seed, gen_chunk)
PARAMS = [
    (100, 200, 10, 1.05, 9, 16),
    (257, 900, 20, 1.2, 3, 128),
    (40, 50, 1, 0.9, 0, 65536),
]


def _pair(num_docs, vocab, tokens, alpha, seed, chunk):
    kw = dict(alpha=alpha, seed=seed, gen_chunk=chunk)
    return (tsyn.synthetic_manifest(num_docs, vocab, tokens, **kw),
            jsyn.synthetic_manifest(num_docs, vocab, tokens, **kw))


@pytest.mark.parametrize("params", PARAMS)
def test_documents_equal_jax_in_any_order(params):
    t, j = _pair(*params)
    n = params[0]
    order = np.random.default_rng(7).permutation(n).tolist() + [n - 1, 0, n // 2]
    assert [t.read_doc(i) for i in order] == [j.read_doc(i) for i in order]
    assert len(t) == len(j) == n
    assert t.total_bytes == j.total_bytes
    assert list(t.sizes) == list(j.sizes)
    assert list(t.paths) == list(j.paths)
    assert [t.doc_id(i) for i in (0, n - 1)] == [j.doc_id(i) for i in (0, n - 1)]
    assert t.fingerprint_extra == j.fingerprint_extra


def test_synthetic_manifest_random_access_deterministic():
    """Twin of the JAX scale suite's check: out-of-order reads cross
    chunk boundaries and stay stable."""
    m = tsyn.synthetic_manifest(num_docs=100, vocab_size=200, tokens_per_doc=10,
                                seed=9, gen_chunk=16)
    a = [m.read_doc(i) for i in (99, 0, 17, 16, 15, 99, 50)]
    b = [m.read_doc(i) for i in (99, 0, 17, 16, 15, 99, 50)]
    assert a == b
    assert len(m) == 100 and m.doc_id(0) == 1
    assert m.total_bytes > 0 and len(m.sizes) == 100


def test_concurrent_reads_across_chunks_return_the_right_documents():
    """The host backend's K reader threads read one virtual manifest at
    once, across chunk boundaries: each gets its own document."""
    import threading

    t, j = _pair(96, 300, 6, 1.05, 4, 8)
    want = [j.read_doc(i) for i in range(96)]
    got = {}

    def reader(w):
        order = np.random.default_rng(w).permutation(96).tolist()
        got[w] = [(i, t.read_doc(i)) for i in order]

    threads = [threading.Thread(target=reader, args=(w,)) for w in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert all(doc == want[i] for w in got for i, doc in got[w])


def test_virtual_seq_is_a_real_sequence():
    seq = VirtualSeq(5, lambda i: i * i)
    assert list(seq) == [0, 1, 4, 9, 16]  # iteration terminates
    assert seq[-1] == 16 and seq[1:4] == [1, 4, 9] and seq[::2] == [0, 4, 16]
    with pytest.raises(IndexError):
        seq[5]
    m = tsyn.synthetic_manifest(num_docs=3, vocab_size=10, tokens_per_doc=2)
    assert list(m.paths) == ["<synthetic doc 0>", "<synthetic doc 1>",
                             "<synthetic doc 2>"]


def _file_manifests(tmp_path):
    paths = tsyn.write_corpus(tmp_path / "docs", tsyn.zipf_corpus(6, 30, 5, seed=2))
    tman.write_manifest(tmp_path / "list.txt", paths)
    return tman.read_manifest(tmp_path / "list.txt"), jman.read_manifest(tmp_path / "list.txt")


@pytest.mark.parametrize("which", ["seed3", "seed4", "files"])
def test_fingerprint_equals_jax(which, tmp_path):
    if which == "files":
        t, j = _file_manifests(tmp_path)
    else:
        seed = int(which[-1])
        t, j = _pair(100, 200, 10, 1.05, seed, 65536)
    assert tckpt.manifest_fingerprint(t) == jckpt.manifest_fingerprint(j)


def test_fingerprint_tells_generators_of_one_size_apart():
    a = tsyn.synthetic_manifest(num_docs=100, vocab_size=200, tokens_per_doc=10, seed=3)
    b = tsyn.synthetic_manifest(num_docs=100, vocab_size=200, tokens_per_doc=10, seed=4)
    assert list(a.paths) == list(b.paths)
    assert tckpt.manifest_fingerprint(a) != tckpt.manifest_fingerprint(b)


def test_stream_checkpoint_rejects_changed_synthetic_params(tmp_path, monkeypatch):
    """Twin of the JAX check: resuming a seed-11 stream under seed-12
    data would silently mix corpora, so the resume is refused."""
    def cfg():
        return tpkg.IndexConfig(device="cpu", device_tokenize=True, stream_chunk_docs=10,
                                stream_checkpoint=str(tmp_path / "stream.ckpt.npz"),
                                stream_checkpoint_every=1, pad_multiple=256)

    monkeypatch.setenv("MRI_TPU_STREAM_CRASH_AFTER_WINDOWS", "2")
    m1 = tsyn.synthetic_manifest(num_docs=30, vocab_size=50, tokens_per_doc=8, seed=11)
    with pytest.raises(RuntimeError, match="injected stream crash"):
        tpkg.build_index(m1, cfg(), output_dir=str(tmp_path / "out"))
    monkeypatch.delenv("MRI_TPU_STREAM_CRASH_AFTER_WINDOWS")
    m2 = tsyn.synthetic_manifest(num_docs=30, vocab_size=50, tokens_per_doc=8, seed=12)
    with pytest.raises(ValueError, match="different manifest"):
        tpkg.build_index(m2, cfg(), output_dir=str(tmp_path / "out"))


def test_pairs_checkpoint_of_a_virtual_corpus_loads_across_packages(tmp_path):
    """The one-shot plan's pairs checkpoint, written by the port for a
    virtual corpus, resumes in the JAX package (same fingerprint)."""
    t, j = _pair(60, 120, 12, 1.05, 5, 32)
    ckpt = tmp_path / "pairs.npz"
    tpkg.build_index(t, tpkg.IndexConfig(device="cpu", checkpoint_path=str(ckpt)),
                     output_dir=str(tmp_path / "port"))
    stats = jbuild(j, JConfig(checkpoint_path=str(ckpt), device_shards=1),
                   output_dir=str(tmp_path / "jax"))
    assert stats["resumed_from"] == str(ckpt)
    assert read_letter_files(tmp_path / "jax") == read_letter_files(tmp_path / "port")


@pytest.fixture(scope="module")
def virtual_golden(tmp_path_factory):
    """A virtual corpus whose documents run past the manifest's size
    estimate, with the oracle's letter files over the whole documents."""
    t, j = _pair(150, 400, 30, 1.05, 8, 64)
    assert max(len(t.read_doc(i)) for i in range(len(t))) > t.sizes[0]
    out = tmp_path_factory.mktemp("virtual") / "oracle"
    tpkg.oracle_index(t, str(out))
    return t, j, read_letter_files(out)


@pytest.mark.parametrize("backend,kw", [
    ("cpu", {}),                        # the parallel route (K = cores)
    ("cpu", {"host_threads": 1}),       # the pipelined route
    ("cpu", {"io_prefetch": 0}),        # the one-shot native call
    ("cuda", {}),                       # the device plan on the CPU device
])
def test_virtual_corpus_builds_equal_the_oracle(backend, kw, virtual_golden, tmp_path):
    """A virtual manifest through every route of the port's host backend
    and its device plan gives the oracle's bytes over whole documents."""
    t, _, golden = virtual_golden
    stats = tpkg.build_index(t, tpkg.IndexConfig(backend=backend, device="cpu", **kw),
                             output_dir=str(tmp_path / "port"))
    assert "cpu_fallback" not in stats
    assert read_letter_files(tmp_path / "port") == golden


@pytest.mark.parametrize("kw,whole", [({"device_shards": 1}, True),
                                      ({"backend": "cpu", "io_prefetch": 0}, True),
                                      ({"backend": "cpu", "host_threads": 1}, False),
                                      ({"backend": "cpu"}, False)])
def test_jax_host_backend_truncates_virtual_documents(kw, whole, virtual_golden, tmp_path):
    """The disagreement the port does not copy (ROADMAP §C): the JAX
    reader sizes each arena view from the manifest's size estimate, so
    its pipelined and parallel host routes index a virtual corpus's
    documents cut to the mean size, while its device build and one-shot
    host call read them whole, as the port does everywhere."""
    _, j, golden = virtual_golden
    jbuild(j, JConfig(**kw), output_dir=str(tmp_path / "jax"))
    assert (read_letter_files(tmp_path / "jax") == golden) is whole


@pytest.mark.parametrize("use_native", [True, False])
def test_tokenize_corpus_and_vocab_strings_equal_jax(use_native, tmp_path):
    t, j = _file_manifests(tmp_path)
    tc = tpkg.tokenize_corpus(t, use_native=use_native)
    jc = jtokenize_corpus(j, use_native=use_native)
    for field in ("term_ids", "doc_ids", "vocab", "letter_of_term"):
        np.testing.assert_array_equal(getattr(tc, field), getattr(jc, field))
    assert tc.vocab_strings() == jc.vocab_strings()
    assert all(isinstance(w, str) for w in tc.vocab_strings())
    assert "tokenize_corpus" in tpkg.__all__


def test_device_engine_cache_property(tmp_path):
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        DeviceEngine,
    )
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.cache import (
        LRUCache,
    )

    t, _ = _file_manifests(tmp_path)
    tpkg.build_index(t, tpkg.IndexConfig(device="cpu", artifact=True),
                     output_dir=str(tmp_path / "out"))
    eng = DeviceEngine(str(tmp_path / "out"), device="cpu")
    try:
        assert isinstance(eng.cache, LRUCache)
        assert eng.cache is eng.cache
        assert eng.cache.stats() == eng.cache_stats()
    finally:
        eng.close()
