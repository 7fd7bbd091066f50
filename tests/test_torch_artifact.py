"""The port's serving artifact (``serve/artifact.py``) against the JAX
package's: the writers (``pack``, ``pack_v2``, ``build_from_emit_arrays``,
``build_from_grouped``) give the same bytes from the same numpy inputs in
formats v1, v2 and v2.1 at block sizes 64 and 128 and score bits 8 and
16; the port's reader decodes what the JAX package's native exporter
writes (real term frequencies); the overlap refusal and the corrupt-file
errors are the JAX package's.  Inputs are made from a seed with numpy."""

import re
import struct
import zlib

import numpy as np
import pytest

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve import (
    artifact as JA,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.utils import (
    envknobs as jknobs,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    artifact as TA,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
    formatter as tfmt,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import (
    envknobs as tknobs,
)

pytestmark = pytest.mark.serve


def _lex_arrays(seed, *, vocab, max_doc, max_df, max_tf):
    """Lex-sorted terms with random ascending postings (and tf)."""
    rng = np.random.default_rng(seed)
    words = sorted({bytes(rng.integers(97, 123, rng.integers(1, 13)).tolist())
                    for _ in range(vocab)})
    V = len(words)
    df = np.minimum(rng.integers(1, max_df + 1, V), max_doc)
    posts = [np.sort(rng.choice(np.arange(1, max_doc + 1), size=d, replace=False))
             for d in df]
    term_offsets = np.zeros(V + 1, np.int64)
    np.cumsum([len(w) for w in words], out=term_offsets[1:])
    post_offsets = np.zeros(V + 1, np.int64)
    np.cumsum(df, out=post_offsets[1:])
    flat = np.concatenate(posts).astype(np.int32)
    return dict(
        term_blob=np.frombuffer(b"".join(words), np.uint8), term_offsets=term_offsets,
        df=df, post_offsets=post_offsets, postings=flat,
        df_order=rng.permutation(V), max_doc_id=max_doc,
        tf=rng.integers(1, max_tf + 1, len(flat)).astype(np.int32))


SHAPES = {  # (vocab, max doc id, max df, max tf): tf/doc gaps of 1-17 bits
    "dense": (60, 40, 40, 1),
    "zipfish": (400, 3000, 900, 6),
    "sparse": (40, 100_000, 5000, 300),
    "wide_tf": (6, 12, 3, 70_000),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pack_v1_bytes_equal_jax(shape, tmp_path):
    vocab, max_doc, max_df, max_tf = SHAPES[shape]
    kw = _lex_arrays(1, vocab=vocab, max_doc=max_doc, max_df=max_df, max_tf=max_tf)
    del kw["tf"]
    nj = JA.pack(tmp_path / "j.mri", fmt=1, **kw)
    nt = TA.pack(tmp_path / "t.mri", fmt=1, **kw)
    assert nj == nt
    assert (tmp_path / "t.mri").read_bytes() == (tmp_path / "j.mri").read_bytes()


@pytest.mark.parametrize("fmt", [2, 3])
@pytest.mark.parametrize("block_size", [64, 128])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pack_v2_bytes_equal_jax(shape, fmt, block_size, bits, tmp_path):
    vocab, max_doc, max_df, max_tf = SHAPES[shape]
    kw = _lex_arrays(2, vocab=vocab, max_doc=max_doc, max_df=max_df, max_tf=max_tf)
    JA.pack_v2(tmp_path / "j.mri", fmt=fmt, block_size=block_size, score_bits=bits, **kw)
    TA.pack_v2(tmp_path / "t.mri", fmt=fmt, block_size=block_size, score_bits=bits, **kw)
    assert (tmp_path / "t.mri").read_bytes() == (tmp_path / "j.mri").read_bytes()


@pytest.mark.parametrize("fmt", ["1", "2", "3"])
@pytest.mark.parametrize("block_size", ["64", "128"])
@pytest.mark.parametrize("bits", ["8", "16"])
def test_builders_bytes_equal_jax_under_the_knobs(fmt, block_size, bits, tmp_path, monkeypatch):
    """``build_from_emit_arrays`` (unsorted vocab, oversized postings
    buffer with gaps) and ``build_from_grouped``, formats and block
    geometry picked by the same knobs in both packages."""
    monkeypatch.setenv("MRI_SERVE_FORMAT", fmt)
    monkeypatch.setenv("MRI_SERVE_BLOCK_SIZE", block_size)
    monkeypatch.setenv("MRI_SERVE_SCORE_BITS", bits)
    rng = np.random.default_rng(int(fmt) * 100 + int(block_size) + int(bits))
    words = sorted({bytes(rng.integers(97, 123, rng.integers(1, 9)).tolist()) for _ in range(300)})
    vocab = np.array(words, dtype="S")[rng.permutation(len(words))]
    V, max_doc = len(vocab), 700
    df = rng.integers(1, 300, V)
    offsets = np.cumsum(df + rng.integers(0, 4, V)) - df  # gaps between runs
    postings = np.zeros(int(offsets[-1] + df[-1] + 5), np.int32)
    for t in range(V):
        postings[offsets[t]:offsets[t] + df[t]] = np.sort(
            rng.choice(np.arange(1, max_doc + 1), df[t], replace=False))
    letters = np.frombuffer(b"".join(w[:1] for w in vocab), np.uint8) - ord("a")
    order = np.lexsort((-df, letters))
    kw = dict(vocab=vocab, order=order, df=df, offsets=offsets, postings=postings,
              max_doc_id=max_doc)
    JA.build_from_emit_arrays(tmp_path / "j.mri", **kw)
    TA.build_from_emit_arrays(tmp_path / "t.mri", **kw)
    assert (tmp_path / "t.mri").read_bytes() == (tmp_path / "j.mri").read_bytes()

    per_letter = {}
    for t in order.tolist():
        per_letter.setdefault(int(letters[t]), []).append(
            (bytes(vocab[t]), postings[offsets[t]:offsets[t] + df[t]].tolist()))
    JA.build_from_grouped(tmp_path / "jg.mri", per_letter)
    TA.build_from_grouped(tmp_path / "tg.mri", per_letter)
    assert (tmp_path / "tg.mri").read_bytes() == (tmp_path / "jg.mri").read_bytes()
    JA.build_from_grouped(tmp_path / "je.mri", {})
    TA.build_from_grouped(tmp_path / "te.mri", {})
    assert (tmp_path / "te.mri").read_bytes() == (tmp_path / "je.mri").read_bytes()


def test_knob_errors_match_jax(monkeypatch):
    for name, bad, want in (("MRI_SERVE_FORMAT", "4", "not in (1, 2, 3)"),
                            ("MRI_SERVE_FORMAT", "v2", "is not a valid int"),
                            ("MRI_SERVE_BLOCK_SIZE", "1", "must be >= 2"),
                            ("MRI_SERVE_SCORE_BITS", "12", "not in (8, 16)"),
                            ("MRI_SERVE_PLANNER", "wand", "not in")):
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError, match=re.escape(want)):
            tknobs.get(name)
        with pytest.raises(ValueError, match=re.escape(want)):
            jknobs.get(name)
        monkeypatch.delenv(name)
    monkeypatch.setenv("MRI_SERVE_BLOCK_SIZE", "96")
    with pytest.raises(ValueError, match="not a power of two"):
        TA.resolve_block_size()


# -- the reader -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cpu_artifacts(tmp_path_factory):
    """The JAX package's ``backend="cpu"`` builds (its native exporter,
    real term frequencies) in formats v1, v2 and v2.1."""
    root = tmp_path_factory.mktemp("jax_cpu_art")
    docs = tsyn.zipf_corpus(num_docs=50, vocab_size=600, tokens_per_doc=160, seed=5)
    docs.append(b"zebra zebra zebra zebra apple apple " * 40)
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for fmt in ("1", "2", "3"):
            mp.setenv("MRI_SERVE_FORMAT", fmt)
            jpkg.build_index(jpkg.read_manifest(root / "list.txt"),
                             JaxConfig(backend="cpu", artifact=True),
                             output_dir=str(root / f"v{fmt}"))
            out[int(fmt)] = root / f"v{fmt}" / "index.mri"
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("fmt", [1, 2, 3])
def test_reader_decodes_jax_cpu_artifact(jax_cpu_artifacts, fmt):
    path = jax_cpu_artifacts[fmt]
    with JA.load_artifact(path) as ja, TA.load_artifact(path) as ta:
        assert (ta.version, ta.vocab, ta.num_postings, ta.max_doc_id, ta.width,
                ta.nbytes, ta.block_size, ta.num_blocks, ta.score_bits) == (
            ja.version, ja.vocab, ja.num_postings, ja.max_doc_id, ja.width,
            ja.nbytes, ja.block_size, ja.num_blocks, ja.score_bits)
        assert ta.has_block_scores == ja.has_block_scores == (fmt == 3)
        saw_tf = False
        for i in range(ta.vocab):
            assert ta.term(i) == ja.term(i)
            assert np.array_equal(ta.decode_postings(i), ja.decode_postings(i))
            tf = ta.decode_tf(i)
            assert tf.dtype == np.int32 and np.array_equal(tf, ja.decode_tf(i))
            saw_tf |= bool(tf.max() > 1)
        assert saw_tf == (fmt != 1)
        for a, b in zip(TA.bm25_corpus(ta), JA.bm25_corpus(ja)):
            assert np.array_equal(a, b)
        for a, b in zip(TA.term_table(ta), JA.term_table(ja)):
            assert np.array_equal(a, b)
        assert TA.checksum(path) == JA.checksum(path)


def test_device_columns_match_jax_columns(jax_cpu_artifacts):
    """The port's int64 key orders the terms as the JAX (hi, lo) pair,
    and the other columns are the JAX engine's (the packed streams carry
    one more zero pad word)."""
    for fmt, path in jax_cpu_artifacts.items():
        with JA.load_artifact(path) as ja, TA.load_artifact(path) as ta:
            jc, tc = JA.device_columns(ja), TA.device_columns(ta)
            pair = (jc["key_hi"].astype(np.int64) << 32) | jc["key_lo"].astype(np.int64)
            assert np.array_equal(tc["key"], pair)
            assert np.all(np.diff(tc["key"]) >= 0)
            assert tc["max_prefix_group"] == jc["max_prefix_group"]
            for name in ("rows", "df", "df_order", "letter_dir", "post_offsets",
                         "term_block_off", "blk_first", "blk_width", "blk_woff"):
                if name in jc:
                    assert np.array_equal(tc[name], jc[name]), (fmt, name)
            if fmt > 1:
                assert np.array_equal(tc["post_words"].view(np.uint32)[:-1], jc["post_words"])


def test_corrupt_artifacts_raise(jax_cpu_artifacts, tmp_path):
    good = jax_cpu_artifacts[3].read_bytes()
    cases = {
        "header": good[:10] + bytes([good[10] ^ 1]) + good[11:],
        "payload": good[:200] + bytes([good[200] ^ 1]) + good[201:],
        "truncated": good[:-16],
        "tiny": good[:40],
    }
    for name, data in cases.items():
        p = tmp_path / f"{name}.mri"
        p.write_bytes(data)
        with pytest.raises(TA.ArtifactError) as te:
            TA.load_artifact(p)
        with pytest.raises(JA.ArtifactError) as je:
            JA.load_artifact(p)
        assert str(te.value) == str(je.value), name
    # a good header with a wrong magic: the header checksum is recomputed
    bad = bytearray(good[:92])
    bad[:8] = b"NOTANIDX"
    p = tmp_path / "magic.mri"
    p.write_bytes(bytes(bad) + struct.pack("<I", zlib.adler32(bytes(bad)))
                  + good[96:])
    with pytest.raises(TA.ArtifactError, match="bad magic"):
        TA.load_artifact(p)
    # a letter-file directory without index.mri names the remedy
    (tmp_path / "letters").mkdir()
    (tmp_path / "letters" / "a.txt").write_bytes(b"")
    with pytest.raises(TA.ArtifactError, match="rebuild with --artifact"):
        TA.load_artifact(tmp_path / "letters")


def test_overlap_artifact_refusal_matches_jax():
    with pytest.raises(ValueError) as te:
        tpkg.IndexConfig(artifact=True, overlap_tail_fraction=0.3)
    with pytest.raises(ValueError) as je:
        JaxConfig(backend="tpu", artifact=True, overlap_tail_fraction=0.3)
    assert str(te.value) == str(je.value)
    assert "artifact is incompatible with overlap_tail_fraction" in str(te.value)


def test_cli_artifact_flag_and_refusal(tmp_path, capsys):
    paths = tsyn.write_corpus(tmp_path / "docs", tsyn.zipf_corpus(6, 80, 30, seed=2))
    tman.write_manifest(tmp_path / "list.txt", paths)
    assert tcli.main(["1", "1", str(tmp_path / "list.txt"), "--device", "cpu",
                      "--artifact", "--output-dir", str(tmp_path / "out")]) == 0
    with TA.load_artifact(tmp_path / "out") as art:
        assert art.version == 3 and art.max_doc_id == 6
    letters = tfmt.letters_md5(tmp_path / "out")
    assert tcli.main(["1", "1", str(tmp_path / "list.txt"), "--device", "cpu",
                      "--output-dir", str(tmp_path / "plain")]) == 0
    assert tfmt.letters_md5(tmp_path / "plain") == letters
    assert not (tmp_path / "plain" / "index.mri").exists()
    capsys.readouterr()
    assert tcli.main(["1", "1", str(tmp_path / "list.txt"), "--device", "cpu", "--artifact",
                      "--overlap-tail-fraction", "0.3", "--output-dir", str(tmp_path / "x")]) == 2
    assert "artifact is incompatible with overlap_tail_fraction" in capsys.readouterr().err
