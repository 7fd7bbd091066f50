"""The one-shot plan's pairs checkpoint (``--checkpoint``,
``utils/checkpoint.save_pairs``/``load_pairs``, the model's
``_tokenize_or_resume``) against the JAX package's.

The file format is the JAX one: a checkpoint written by either package
loads, and resumes a build, in the other to the same letter files.  The
CLI resumes from the checkpoint alone, refuses another manifest's and a
torn one under ``--resume strict``, and quarantines a torn one under
``--resume auto``; ``--checkpoint`` on a two-shard mesh (``dist_index``)
gives the JAX mesh build's bytes.
"""

import json

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import faults as jfaults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cli import main as jmain
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.text.tokenizer import (
    tokenize as jtokenize,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.utils import (
    checkpoint as jckpt,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import faults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text.tokenizer import (
    tokenize,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import (
    checkpoint as tckpt,
)

from conftest import read_letter_files

pytestmark = pytest.mark.faults

FIELDS = ("term_ids", "doc_ids", "vocab", "letter_of_term")


@pytest.fixture(autouse=True)
def _disarm():
    for mod in (faults, jfaults):
        mod.install(None)
        mod.begin_run()
    yield
    for mod in (faults, jfaults):
        mod.install(None)
        mod.begin_run()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    docs = tsyn.zipf_corpus(num_docs=30, vocab_size=200, tokens_per_doc=30, seed=9)
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    tpkg.oracle_index(tman.read_manifest(root / "list.txt"), root / "golden")
    return root / "list.txt", read_letter_files(root / "golden")


def _mk_corpus(tmp_path):
    (tmp_path / "d1.txt").write_text("alpha beta gamma")
    (tmp_path / "d2.txt").write_text("beta delta alpha")
    tman.write_manifest(tmp_path / "list.txt", [str(tmp_path / "d1.txt"),
                                                str(tmp_path / "d2.txt")])
    return tmp_path / "list.txt"


def _truncate(path):
    size = path.stat().st_size
    with open(path, "r+b") as f:
        f.truncate(max(size // 3, 1))


def _run(argv, capsys, fn=main):
    capsys.readouterr()
    rc = fn(argv)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), out.err


def _assert_same_corpus(a, b):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.pairs_deduped == b.pairs_deduped and a.raw_tokens == b.raw_tokens


# -- the file format ----------------------------------------------------


@pytest.mark.parametrize("use_native", [False, True])
def test_pairs_round_trip(use_native, tmp_path):
    corpus = tokenize([b"alpha beta", b"beta gamma alpha"], [1, 2], use_native=use_native,
                      dedup_pairs=True)
    p = tmp_path / "pairs.npz"
    tckpt.save_pairs(p, corpus, fingerprint="fp")
    assert not (tmp_path / "pairs.npz.tmp").exists()
    _assert_same_corpus(tckpt.load_pairs(p, expect_fingerprint="fp"), corpus)
    _assert_same_corpus(tckpt.load_pairs(p), corpus)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pairs_checkpoint_loads_in_both_packages(writer, tmp_path):
    docs, ids = [b"alpha beta", b"beta gamma alpha", b"zeta"], [1, 2, 3]
    p = tmp_path / "pairs.npz"
    if writer == "port":
        tckpt.save_pairs(p, tokenize(docs, ids, use_native=False, dedup_pairs=True),
                         fingerprint="fp")
    else:
        jckpt.save_pairs(p, jtokenize(docs, ids, use_native=False, dedup_pairs=True),
                         fingerprint="fp")
    _assert_same_corpus(tckpt.load_pairs(p, "fp"), jckpt.load_pairs(p, "fp"))


def test_manifest_fingerprint_matches_jax(corpus):
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
        manifest as jman,
    )

    list_path, _ = corpus
    assert (tckpt.manifest_fingerprint(tman.read_manifest(list_path))
            == jckpt.manifest_fingerprint(jman.read_manifest(list_path)))


def test_load_pairs_corrupt_is_named_error(tmp_path):
    corpus = tokenize([b"alpha beta"], [1], use_native=False, dedup_pairs=True)
    p = tmp_path / "pairs.npz"
    tckpt.save_pairs(p, corpus, fingerprint="fp")
    _truncate(p)
    with pytest.raises(tckpt.CheckpointCorrupt) as ei:
        tckpt.load_pairs(p, expect_fingerprint="fp")
    assert str(p) in str(ei.value) and "--resume=auto" in str(ei.value)


def test_load_pairs_rejects_version_and_fingerprint(tmp_path):
    corpus = tokenize([b"alpha"], [1], use_native=False, dedup_pairs=True)
    p = tmp_path / "pairs.npz"
    tckpt.save_pairs(p, corpus, fingerprint="fp")
    with pytest.raises(ValueError, match="different manifest"):
        tckpt.load_pairs(p, expect_fingerprint="other")
    with np.load(p) as z:
        members = {k: z[k] for k in z.files}
    members["version"] = np.int64(1)
    with open(p, "wb") as f:
        np.savez(f, **members)
    with pytest.raises(ValueError, match="version 1, expected 2"):
        tckpt.load_pairs(p)


def test_ckpt_corrupt_fault_tears_the_pairs_save(tmp_path):
    corpus = tokenize([b"alpha beta"], [1], use_native=False, dedup_pairs=True)
    p = tmp_path / "pairs.npz"
    faults.install("ckpt-corrupt:save=1")
    tckpt.save_pairs(p, corpus, fingerprint="fp")
    with pytest.raises(tckpt.CheckpointCorrupt):
        tckpt.load_pairs(p, "fp")


# -- the CLI ------------------------------------------------------------


def test_cli_checkpoint_resume(tmp_path, capsys):
    listfile = _mk_corpus(tmp_path)
    ckpt = tmp_path / "pairs.npz"
    base = ["1", "1", str(listfile), "--device", "cpu", "--checkpoint", str(ckpt),
            "--pad-multiple", "64", "--stats"]
    rc, st1, _ = _run([*base, "--output-dir", str(tmp_path / "o1")], capsys)
    assert rc == 0 and ckpt.exists()
    assert {"load", "tokenize", "checkpoint"} <= set(st1["phases_ms"])
    assert "tokenize_feed" not in st1["phases_ms"]  # --checkpoint takes the one-shot plan
    # the corpus gone: the resume rebuilds the same output from the
    # checkpoint alone
    (tmp_path / "d1.txt").unlink()
    (tmp_path / "d2.txt").unlink()
    rc, st2, _ = _run([*base, "--output-dir", str(tmp_path / "o2")], capsys)
    assert rc == 0
    assert "resume" in st2["phases_ms"] and not {"load", "tokenize"} & set(st2["phases_ms"])
    assert st2["resumed_from"] == str(ckpt) and st2["documents"] == 0
    assert st2["degradation"]["skipped_docs"] == []
    assert read_letter_files(tmp_path / "o1") == read_letter_files(tmp_path / "o2")


def test_cli_checkpoint_manifest_mismatch(tmp_path, capsys):
    listfile = _mk_corpus(tmp_path)
    ckpt = tmp_path / "pairs.npz"
    rc, _, _ = _run(["1", "1", str(listfile), "--device", "cpu", "--checkpoint", str(ckpt),
                     "--output-dir", str(tmp_path / "o1"), "--pad-multiple", "64"], capsys)
    assert rc == 0
    # another file list, the same checkpoint: refused, not a crash and
    # not the old corpus's index
    (tmp_path / "d3.txt").write_text("delta")
    tman.write_manifest(tmp_path / "list2.txt", [str(tmp_path / "d3.txt")])
    rc, _, err = _run(["1", "1", str(tmp_path / "list2.txt"), "--device", "cpu",
                       "--checkpoint", str(ckpt), "--output-dir", str(tmp_path / "o2"),
                       "--pad-multiple", "64"], capsys)
    assert rc == 2 and "different manifest" in err and err.count("\n") == 1


def test_cli_corrupt_checkpoint(tmp_path, capsys):
    listfile = _mk_corpus(tmp_path)
    ckpt = tmp_path / "bad.npz"
    ckpt.write_bytes(b"not a checkpoint")
    rc, _, err = _run(["1", "1", str(listfile), "--device", "cpu", "--checkpoint",
                       str(ckpt), "--output-dir", str(tmp_path / "o")], capsys)
    assert rc == 2 and err.startswith("error:") and err.count("\n") == 1


def test_resume_auto_quarantines_pairs_checkpoint(tmp_path, capsys):
    listfile = _mk_corpus(tmp_path)
    ckpt = tmp_path / "pairs.npz"
    base = ["1", "1", str(listfile), "--device", "cpu", "--checkpoint", str(ckpt),
            "--pad-multiple", "64", "--stats"]
    assert _run([*base, "--output-dir", str(tmp_path / "o1")], capsys)[0] == 0
    _truncate(ckpt)
    rc, _, err = _run([*base, "--output-dir", str(tmp_path / "o2")], capsys)
    assert rc == 2 and "corrupt" in err
    rc, st, _ = _run([*base, "--output-dir", str(tmp_path / "o3"), "--resume", "auto"], capsys)
    assert rc == 0
    assert st["quarantined_checkpoint"] == str(ckpt) + ".corrupt"
    assert (tmp_path / "pairs.npz.corrupt").exists() and ckpt.exists()  # saved afresh
    assert read_letter_files(tmp_path / "o3") == read_letter_files(tmp_path / "o1")


def test_ckpt_corrupt_spec_then_auto_resume(tmp_path, capsys):
    """``--fault-spec ckpt-corrupt:save=1`` tears the run's save; the
    rerun quarantines it under ``--resume auto`` and rebuilds."""
    listfile = _mk_corpus(tmp_path)
    ckpt = tmp_path / "pairs.npz"
    base = ["1", "1", str(listfile), "--device", "cpu", "--checkpoint", str(ckpt),
            "--pad-multiple", "64", "--stats"]
    rc, _, _ = _run([*base, "--output-dir", str(tmp_path / "o1"),
                     "--fault-spec", "ckpt-corrupt:save=1"], capsys)
    assert rc == 0
    faults.install(None)
    rc, st, _ = _run([*base, "--output-dir", str(tmp_path / "o2"), "--resume", "auto"], capsys)
    assert rc == 0 and "quarantined_checkpoint" in st and "tokenize" in st["phases_ms"]
    assert read_letter_files(tmp_path / "o1") == read_letter_files(tmp_path / "o2")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cli_resumes_the_other_packages_checkpoint(writer, corpus, tmp_path, capsys):
    """A checkpoint written by one package's build resumes in the other
    to the same letter files."""
    list_path, golden = corpus
    ckpt = tmp_path / "pairs.npz"
    common = ["1", "1", str(list_path), "--checkpoint", str(ckpt), "--pad-multiple", "256",
              "--stats"]
    port = [*common, "--device", "cpu"]
    jax = [*common, "--backend", "tpu", "--device-shards", "1"]
    first, second = ((port, main), (jax, jmain)) if writer == "port" else ((jax, jmain),
                                                                            (port, main))
    rc, st1, _ = _run([*first[0], "--output-dir", str(tmp_path / "first")], capsys, first[1])
    assert rc == 0 and "checkpoint" in st1["phases_ms"]
    rc, st2, _ = _run([*second[0], "--output-dir", str(tmp_path / "second")], capsys,
                      second[1])
    assert rc == 0 and st2["resumed_from"] == str(ckpt) and st2["documents"] == 0
    assert (read_letter_files(tmp_path / "first") == read_letter_files(tmp_path / "second")
            == golden)


@pytest.mark.parametrize("skew", [False, True])
def test_checkpoint_stats_match_jax(skew, corpus, tmp_path, capsys):
    """The save and the resume record the JAX package's keys and phases."""
    list_path, _ = corpus
    extra = ["--skew"] if skew else []
    keys = {}
    for name, fn, dev in (("port", main, ["--device", "cpu"]),
                          ("jax", jmain, ["--backend", "tpu", "--device-shards", "1"])):
        ckpt = tmp_path / f"{name}.npz"
        argv = ["1", "1", str(list_path), "--checkpoint", str(ckpt), "--pad-multiple", "256",
                "--stats", *extra, *dev]
        rc, save, _ = _run([*argv, "--output-dir", str(tmp_path / f"{name}1")], capsys, fn)
        rc2, resume, _ = _run([*argv, "--output-dir", str(tmp_path / f"{name}2")], capsys, fn)
        assert rc == rc2 == 0
        keys[name] = [(s["documents"], s.get("resumed_from") is not None,
                       s.get("letter_imbalance"), s["unique_pairs"],
                       sorted(set(s["phases_ms"]) & {"load", "tokenize", "checkpoint",
                                                      "resume", "skew_stats"}))
                      for s in (save, resume)]
    assert keys["port"] == keys["jax"]


def test_checkpoint_on_a_two_shard_mesh_matches_jax(corpus, tmp_path, capsys):
    """``--checkpoint`` with ``--device-shards 2`` takes the one-shot
    ``dist_index``; save and resume give the JAX mesh build's bytes."""
    list_path, golden = corpus
    out = {}
    for name, fn, dev in (("port", main, ["--device", "cpu"]),
                          ("jax", jmain, ["--backend", "tpu"])):
        ckpt = tmp_path / f"{name}.npz"
        argv = ["1", "1", str(list_path), "--checkpoint", str(ckpt), "--pad-multiple", "256",
                "--device-shards", "2", "--stats", *dev]
        for leg in ("save", "resume"):
            rc, st, _ = _run([*argv, "--output-dir", str(tmp_path / f"{name}_{leg}")], capsys,
                             fn)
            assert rc == 0 and st["device_shards"] == 2
            assert ("resumed_from" in st) == (leg == "resume")
            out[name, leg] = read_letter_files(tmp_path / f"{name}_{leg}")
        if name == "port":
            assert st["engine"] == "dist"
    assert set(out.values()) == {golden}


def test_checkpoint_with_stream_or_device_tokenize_is_refused(tmp_path, capsys):
    listfile = _mk_corpus(tmp_path)
    for extra, msg in ((["--stream-chunk-docs", "1"], "incompatible with checkpoint_path"),
                       (["--device-tokenize"], "checkpoint_path belongs to the host-scan"),
                       (["--backend", "oracle"], "checkpoint_path requires backend='cuda'")):
        rc, _, err = _run(["1", "1", str(listfile), "--device", "cpu", "--checkpoint",
                           str(tmp_path / "c.npz"), "--output-dir", str(tmp_path / "o"),
                           *extra], capsys)
        assert rc == 2 and msg in err, (extra, err)
