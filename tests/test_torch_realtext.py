"""The port's paragraph-resharded real-text manifest
(``corpus/realtext.py`` ``ParagraphManifest``) against the JAX
package's on the same source directory, on the CPU: the JAX suite's
cases twinned (paragraph split, cycling, sizes, paths, fingerprints,
salting with fixed-width tags, refusals), every document, size and path
equal to JAX's, the checkpoint fingerprint equal to JAX's, and the
port's builds over it (the device plans on the CPU device and the host
backend's routes) equal to ``oracle_index``."""

import pytest

from conftest import read_letter_files

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus.realtext import (
    ParagraphManifest as JParagraphs,
    _cycle_tag as jcycle_tag,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.utils import (
    checkpoint as jckpt,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus.manifest import (
    iter_document_chunks,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus.realtext import (
    ParagraphManifest,
    _cycle_tag,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import (
    checkpoint as tckpt,
)


@pytest.fixture(scope="module")
def src_dir(tmp_path_factory):
    """The JAX suite's source directory: blank-line runs, CRLF, a
    paragraph with punctuation and capitals."""
    d = tmp_path_factory.mktemp("trt_src")
    (d / "a.txt").write_bytes(
        b"First paragraph here.\n\nSecond one, with Words!\n\n\n"
        b"Third after a blank run.")
    (d / "b.txt").write_bytes(b"Only paragraph of file two\r\n\r\nAnd another")
    return d


def _pair(src, **kw):
    return ParagraphManifest(src, **kw), JParagraphs(src, **kw)


@pytest.mark.parametrize("kw", [{"repeats": 1}, {"repeats": 3}, {"num_docs": 7},
                                {"num_docs": 13, "salt_cycles": True},
                                {"repeats": 3, "salt_cycles": True}])
def test_manifest_equals_jax(src_dir, kw):
    t, j = _pair(src_dir, **kw)
    n = len(j)
    assert len(t) == n
    assert [t.read_doc(i) for i in range(n)] == [j.read_doc(i) for i in range(n)]
    assert list(t.sizes) == list(j.sizes) and list(t.paths) == list(j.paths)
    assert t.sizes[1:4] == j.sizes[1:4]
    assert t.total_bytes == j.total_bytes
    assert (t.source_files, t.source_paragraphs) == (j.source_files, j.source_paragraphs)
    assert t.fingerprint_extra == j.fingerprint_extra
    assert tckpt.manifest_fingerprint(t) == jckpt.manifest_fingerprint(j)
    assert [t.doc_id(i) for i in (0, n - 1)] == [1, n]


def test_paragraph_split_and_cycling(src_dir):
    m = ParagraphManifest(src_dir, repeats=1)
    assert (m.source_files, m.source_paragraphs, len(m)) == (2, 5, 5)
    m3 = ParagraphManifest(src_dir, repeats=3)
    assert len(m3) == 15
    assert m3.read_doc(0) == m3.read_doc(5) == m3.read_doc(10)
    assert m3.doc_id(7) == 8
    with pytest.raises(IndexError):
        m3.read_doc(15)


def test_sizes_paths_and_total_bytes(src_dir):
    """Sizes are the documents' own lengths (the port's reader sizes a
    virtual document from its bytes; here the estimate is exact)."""
    m = ParagraphManifest(src_dir, num_docs=7)
    assert len(m.sizes) == len(m.paths) == 7
    assert [m.sizes[i] for i in range(7)] == [len(m.read_doc(i)) for i in range(7)]
    assert m.total_bytes == sum(m.sizes)
    assert len(list(m.paths)) == 7 and sum(1 for _ in m.sizes) == 7


def test_fingerprint_distinguishes_counts_sources_and_salting(src_dir, tmp_path):
    a = ParagraphManifest(src_dir, num_docs=5)
    b = ParagraphManifest(src_dir, num_docs=10)
    assert a.fingerprint_extra != b.fingerprint_extra
    other = tmp_path / "other_src"
    other.mkdir()
    (other / "c.txt").write_bytes(b"different corpus text")
    assert ParagraphManifest(other, num_docs=5).fingerprint_extra != a.fingerprint_extra
    s = ParagraphManifest(src_dir, num_docs=5, salt_cycles=True)
    assert tckpt.manifest_fingerprint(s) != tckpt.manifest_fingerprint(a)


def test_streaming_loader_covers_every_doc(src_dir):
    m = ParagraphManifest(src_dir, repeats=2)
    seen = []
    for contents, ids in iter_document_chunks(m, 4):
        assert len(contents) == len(ids) <= 4
        seen.extend(ids)
    assert seen == list(range(1, 11))


def test_salted_cycles_grow_vocabulary(src_dir):
    P = ParagraphManifest(src_dir, repeats=1).source_paragraphs
    m = ParagraphManifest(src_dir, repeats=3, salt_cycles=True)
    plain = ParagraphManifest(src_dir, repeats=1)
    assert [m.read_doc(i) for i in range(P)] == [plain.read_doc(i) for i in range(P)]
    assert m.read_doc(P) == b" ".join(w + b"aa" for w in m.read_doc(0).split())
    assert m.read_doc(2 * P) == b" ".join(w + b"ab" for w in m.read_doc(0).split())

    def vocab(docs):
        return {w for d in docs for w in d.split()}

    v1 = vocab(m.read_doc(i) for i in range(P))
    assert len(vocab(m.read_doc(i) for i in range(3 * P))) == 3 * len(v1)
    u = ParagraphManifest(src_dir, repeats=3)
    assert len(vocab(u.read_doc(i) for i in range(3 * P))) == len(v1)


def test_cycle_tag_equals_jax_and_is_fixed_width():
    tags = [_cycle_tag(r, 2) for r in range(1, 677)]
    assert tags == [jcycle_tag(r, 2) for r in range(1, 677)]
    assert tags[:3] == [b"aa", b"ab", b"ac"] and len(set(tags)) == len(tags)
    assert all(t.isalpha() and t.islower() and len(t) == 2 for t in tags)
    assert _cycle_tag(700, 4) == jcycle_tag(700, 4)
    with pytest.raises(ValueError, match="does not fit"):
        _cycle_tag(677, 2)
    assert b"web" + _cycle_tag(1, 2) != b"we" + _cycle_tag(28, 2)


def test_empty_source_and_zero_docs_rejected(src_dir, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no .txt files"):
        ParagraphManifest(empty)
    with pytest.raises(ValueError, match="num_docs"):
        ParagraphManifest(src_dir, num_docs=0)


@pytest.mark.parametrize("salt", [False, True])
@pytest.mark.parametrize("cfg", [
    {"device": "cpu"},                                            # the default plan
    {"device": "cpu", "pipeline_chunk_docs": 0},                  # one-shot
    {"device": "cpu", "stream_chunk_docs": 4},                    # streaming
    {"device": "cpu", "device_tokenize": True, "pad_multiple": 256,
     "stream_chunk_docs": 4},                                     # streaming all-device
    {"backend": "cpu"},                                           # the host backend
    {"backend": "cpu", "host_threads": 1},                        # its pipelined route
])
def test_builds_equal_the_oracle(src_dir, tmp_path, cfg, salt):
    m = ParagraphManifest(src_dir, repeats=4, salt_cycles=salt)
    tpkg.oracle_index(m, str(tmp_path / "golden"))
    stats = tpkg.build_index(m, tpkg.IndexConfig(**cfg), output_dir=str(tmp_path / "port"))
    assert "cpu_fallback" not in stats
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "golden")
    if "stream_chunk_docs" in cfg and salt:
        curve = stats.get("vocab_curve") or stats.get("unique_rows_curve")
        assert curve == sorted(curve) and curve[-1] > curve[0]


def test_stream_checkpoint_resumes_a_paragraph_corpus(src_dir, tmp_path, monkeypatch):
    """A streaming all-device build over the paragraph corpus crashed at
    window 3 resumes from its checkpoint (fingerprinted by
    ``fingerprint_extra``) to the oracle's bytes; the same checkpoint is
    refused for the salted corpus of the same size."""
    m = ParagraphManifest(src_dir, repeats=6)

    def cfg():
        return tpkg.IndexConfig(device="cpu", device_tokenize=True, stream_chunk_docs=4,
                                stream_checkpoint=str(tmp_path / "s.ckpt.npz"),
                                stream_checkpoint_every=1, pad_multiple=256)

    monkeypatch.setenv("MRI_TPU_STREAM_CRASH_AFTER_WINDOWS", "3")
    with pytest.raises(RuntimeError, match="injected stream crash"):
        tpkg.build_index(m, cfg(), output_dir=str(tmp_path / "out"))
    monkeypatch.delenv("MRI_TPU_STREAM_CRASH_AFTER_WINDOWS")
    salted = ParagraphManifest(src_dir, repeats=6, salt_cycles=True)
    with pytest.raises(ValueError, match="different manifest"):
        tpkg.build_index(salted, cfg(), output_dir=str(tmp_path / "out"))
    stats = tpkg.build_index(m, cfg(), output_dir=str(tmp_path / "out"))
    assert stats["resumed_from_window"] >= 1
    tpkg.oracle_index(m, str(tmp_path / "golden"))
    assert read_letter_files(tmp_path / "out") == read_letter_files(tmp_path / "golden")
