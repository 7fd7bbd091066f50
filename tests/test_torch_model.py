"""The port end to end: letter files byte-equal to the JAX package's
one-shot plan (``backend='tpu', use_native=False, device_shards=1``, the
plan that reaches the Pallas dedup), to the oracle and to the smoke
golden; tokenizer and generator parity; skew counts; CLI exit codes;
and the rule that the port never imports jax or the JAX package."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.config import (
    IndexConfig as JaxConfig,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    synthetic as jsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.text import (
    tokenizer as jtok,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.utils import (
    stats as jstats,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
    inverted_index as tmodel,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    keys as tkeys,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
    formatter as tfmt,
    tokenizer as ttok,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import (
    stats as tstats,
)

from conftest import REPO_ROOT, read_letter_files

JAX_PKG = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu"
PORT_PKG = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
PORT_DIR = REPO_ROOT / PORT_PKG


def _port_cfg(**kw):
    """The port's one-shot plan over the numpy tokenizer, the counterpart
    of :func:`_jax_cfg` (the default build takes the pipelined plan,
    tests/test_torch_pipelined.py)."""
    kw.setdefault("use_native", False)
    return tpkg.IndexConfig(device="cpu", **kw)


def _jax_cfg(**kw):
    return JaxConfig(backend="tpu", use_native=False, device_shards=1, **kw)


def _md5(directory) -> str:
    return hashlib.md5(read_letter_files(directory)).hexdigest()


def _manifest(tmp_path, docs, name="corpus"):
    paths = tsyn.write_corpus(tmp_path / name, docs)
    list_path = tmp_path / f"{name}.txt"
    tman.write_manifest(list_path, paths)
    return list_path


def _distinct_vocab_docs(num_words=70_000, num_docs=30, seed=5):
    """Every one of ``num_words`` distinct words at least once, plus
    repeats: a vocabulary past the u16 engine's 65535 limit."""
    words = tsyn.make_vocab(num_words, seed=seed)
    rng = np.random.default_rng(seed)
    per_doc = [[] for _ in range(num_docs)]
    for i, w in enumerate(words):
        per_doc[i % num_docs].append(w)
    for idx in rng.integers(0, num_words, 20_000):
        per_doc[int(rng.integers(0, num_docs))].append(words[int(idx)])
    return [b" ".join(ws) for ws in per_doc]


CORPORA = {
    "u16": lambda: tsyn.zipf_corpus(num_docs=40, vocab_size=3000, tokens_per_doc=300, seed=1),
    "packed": _distinct_vocab_docs,
}


# -- end to end against the JAX package ----------------------------------


@pytest.mark.parametrize("engine", ["u16", "packed"])
def test_build_matches_jax_one_shot_plan(engine, tmp_path):
    list_path = _manifest(tmp_path, CORPORA[engine]())
    m_t = tpkg.read_manifest(list_path)
    m_j = jpkg.read_manifest(list_path)
    st = tpkg.build_index(m_t, _port_cfg(), output_dir=str(tmp_path / "torch"))
    sj = jpkg.build_index(m_j, _jax_cfg(), output_dir=str(tmp_path / "jax"))
    assert st["engine"] == engine
    assert read_letter_files(tmp_path / "torch") == read_letter_files(tmp_path / "jax")
    for key in ("tokens", "unique_terms", "unique_pairs", "lines_written", "documents"):
        assert st[key] == sj[key], key


def test_pairs_engine_matches_jax(tmp_path, monkeypatch):
    # a corpus whose keys do not fit int32 needs ~2**31 / vocab documents;
    # the same engine is reached here by refusing the int32 key
    list_path = _manifest(tmp_path, CORPORA["u16"]())
    monkeypatch.setattr(tkeys, "can_pack", lambda vocab, max_doc: False)
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(),
                          output_dir=str(tmp_path / "torch"))
    jpkg.build_index(jpkg.read_manifest(list_path), _jax_cfg(),
                     output_dir=str(tmp_path / "jax"))
    assert st["engine"] == "pairs"
    assert read_letter_files(tmp_path / "torch") == read_letter_files(tmp_path / "jax")


@pytest.mark.parametrize("pad_multiple", [1, 1000, 1 << 16])
def test_pad_multiple_is_output_invariant(pad_multiple, tmp_path):
    list_path = _manifest(tmp_path, CORPORA["u16"]())
    tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(pad_multiple=pad_multiple),
                     output_dir=str(tmp_path / "torch"))
    tpkg.oracle_index(tpkg.read_manifest(list_path), tmp_path / "oracle")
    assert _md5(tmp_path / "torch") == _md5(tmp_path / "oracle")


def test_phase_keys_match_jax(tmp_path):
    list_path = _manifest(tmp_path, CORPORA["u16"]())
    st = tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(collect_skew_stats=True),
                          output_dir=str(tmp_path / "torch"))
    sj = jpkg.build_index(jpkg.read_manifest(list_path), _jax_cfg(collect_skew_stats=True),
                          output_dir=str(tmp_path / "jax"))
    assert set(st["phases_ms"]) == set(sj["phases_ms"]) == {
        "load", "tokenize", "skew_stats", "feed", "device_index", "fetch", "emit"}
    assert st["letter_imbalance"] == sj["letter_imbalance"]


# -- goldens and the oracle ------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "oracle"])
def test_smoke_fixture_golden(backend, smoke_fixture, tmp_path, monkeypatch):
    monkeypatch.chdir(smoke_fixture)
    manifest = tpkg.read_manifest("manifest.txt")
    tpkg.build_index(manifest, _port_cfg(backend=backend), output_dir=str(tmp_path))
    assert read_letter_files(tmp_path) == read_letter_files(smoke_fixture / "golden")


def test_cli_smoke_fixture_golden(smoke_fixture, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(smoke_fixture)
    rc = tcli.main(["2", "3", "manifest.txt", "--device", "cpu", "--skew", "--stats",
                    "--output-dir", str(tmp_path)])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # --skew keeps the one-shot plan; the native combiner dedups its feed
    assert stats["engine"] == "u16_prededuped" and stats["degradation"]["skipped_docs"] == []
    assert read_letter_files(tmp_path) == read_letter_files(smoke_fixture / "golden")


@pytest.mark.parametrize("backend", ["cuda", "oracle"])
def test_empty_corpus_writes_26_empty_files(backend, tmp_path):
    list_path = _manifest(tmp_path, [b"123 ... !!", b""])
    tpkg.build_index(tpkg.read_manifest(list_path), _port_cfg(backend=backend),
                     output_dir=str(tmp_path / "out"))
    files = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert files == [f"{chr(97 + i)}.txt" for i in range(26)]
    assert read_letter_files(tmp_path / "out") == b""


# -- skew statistics -------------------------------------------------------


@pytest.mark.parametrize("num_buckets", [2, 8, 26])
def test_partition_skew_matches_jax(num_buckets):
    corpus = ttok.tokenize_documents(CORPORA["u16"](), list(range(1, 41)))
    want = jstats.partition_skew(corpus.term_ids, corpus.letter_of_term, num_buckets)
    got = tstats.partition_skew(corpus.term_ids, corpus.letter_of_term, num_buckets)
    for key in ("letter_counts", "bucket_counts"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    for key in ("letter_imbalance", "bucket_imbalance", "num_buckets"):
        assert got[key] == want[key]


# -- tokenizer and generator parity ---------------------------------------

TOKENIZER_DOCS = {
    "zipf": lambda: tsyn.zipf_corpus(num_docs=12, vocab_size=800, tokens_per_doc=150, seed=3),
    "edges": lambda: [b"Don't x1y2z3 caf\xc3\xa9 ALPHA\tbeta\ngamma\r\x0bdelta",
                      b"", b"  \n  ", b"a" * 40 + b" " + b"b" * 305, b"...  z"],
    "long_words": lambda: [b" ".join(b"q" * n for n in (31, 32, 33, 64, 298, 299, 300)),
                           b"q" * 33 + b" short"],
    "no_letters": lambda: [b"123 456", b"!!!"],
}


@pytest.mark.parametrize("name", sorted(TOKENIZER_DOCS))
def test_tokenizer_matches_jax(name):
    docs = TOKENIZER_DOCS[name]()
    ids = list(range(1, len(docs) + 1))
    want = jtok.tokenize_documents(docs, ids)
    got = ttok.tokenize_documents(docs, ids)
    for field in ("term_ids", "doc_ids", "vocab", "letter_of_term"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.num_tokens == want.num_tokens and got.vocab_size == want.vocab_size


def test_corpus_from_numpy_carries_a_jax_tokenization():
    docs = TOKENIZER_DOCS["zipf"]()
    want = jtok.tokenize_documents(docs, list(range(1, len(docs) + 1)))
    got = ttok.corpus_from_numpy(want.term_ids, want.doc_ids, want.vocab, want.letter_of_term)
    own = ttok.tokenize_documents(docs, list(range(1, len(docs) + 1)))
    for field in ("term_ids", "doc_ids", "vocab", "letter_of_term"):
        np.testing.assert_array_equal(getattr(got, field), getattr(own, field))
    assert got.term_ids.dtype == np.int32 and got.letter_of_term.dtype == np.int32


@pytest.mark.parametrize("raw", ["Don't", "x1y2z3", "café", "A" * 400, "", "--"])
def test_clean_token_matches_jax(raw):
    assert tpkg.clean_token(raw) == jpkg.clean_token(raw)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_zipf_corpus_bytes_match_jax(seed):
    kw = dict(num_docs=9, vocab_size=500, tokens_per_doc=40, seed=seed)
    assert tsyn.zipf_corpus(**kw) == jsyn.zipf_corpus(**kw)
    assert tsyn.make_vocab(300, seed=seed) == jsyn.make_vocab(300, seed=seed)


# -- configuration, device and CLI contract -------------------------------


@pytest.mark.parametrize("kw", [{"num_mappers": 0}, {"num_reducers": 0},
                                {"pad_multiple": 0}, {"backend": "nope"}])
def test_config_validation_messages_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tpkg.IndexConfig(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [{"device": "tpu"},
                                {"backend": "oracle", "collect_skew_stats": True}])
def test_config_rejects_port_only_mistakes(kw):
    with pytest.raises(ValueError):
        tpkg.IndexConfig(**kw)


def test_default_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    list_path = _manifest(tmp_path, [b"alpha beta"])
    with pytest.raises(tmodel.DeviceUnavailable):
        tpkg.build_index(tpkg.read_manifest(list_path), tpkg.IndexConfig(),
                         output_dir=str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("case", ["mappers", "reducers", "missing_list", "bad_manifest",
                                  "no_card"])
def test_cli_exit_2(case, tmp_path, capsys):
    list_path = _manifest(tmp_path, [b"alpha beta"])
    argv = {
        "mappers": ["0", "1", str(list_path), "--device", "cpu"],
        "reducers": ["1", "0", str(list_path), "--device", "cpu"],
        "missing_list": ["1", "1", str(tmp_path / "nope.txt"), "--device", "cpu"],
        "bad_manifest": ["1", "1", str(tmp_path / "bad.txt"), "--device", "cpu"],
        "no_card": ["1", "1", str(list_path)],
    }[case]
    if case == "no_card" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "bad.txt").write_text("3\nonly_one.txt\n")
    assert tcli.main([*argv, "--output-dir", str(tmp_path / "out")]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and err.count("\n") == 1


@pytest.mark.parametrize("backend", ["cuda", "oracle"])
def test_cli_exit_3_on_skipped_document(backend, tmp_path, capsys):
    paths = tsyn.write_corpus(tmp_path / "docs", [b"alpha beta", b"beta gamma"])
    list_path = tmp_path / "list.txt"
    tman.write_manifest(list_path, [paths[0], str(tmp_path / "gone.txt"), paths[1]])
    rc = tcli.main(["2", "2", str(list_path), "--device", "cpu", "--backend", backend,
                    "--stats", "--output-dir", str(tmp_path / "out")])
    assert rc == tcli.EXIT_DEGRADED == 3
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip())["degradation"]["skipped_docs"] == [2]
    assert "DEGRADED" in captured.err
    assert (tmp_path / "out" / "g.txt").read_bytes() == b"gamma:[3]\n"


# -- the port imports neither jax nor the JAX package ---------------------


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT_DIR.rglob("*.py")):
        rel = path.relative_to(REPO_ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        if parts[-1] != "__main__":
            mods.append(".".join(parts))
    return mods


def _forbidden(module: str) -> bool:
    """jax (and its subpackages) or the JAX package — matched exactly, not
    by prefix: the JAX package's name is a prefix of the port's."""
    return module.split(".")[0] in ("jax", "jaxlib", JAX_PKG)


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO_ROOT, env=env, timeout=120, check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert PORT_PKG in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", [
    *(str(p.relative_to(REPO_ROOT)) for p in sorted(PORT_DIR.rglob("*.py"))),
    "chip_smoke.py",
])
def test_source_names_no_jax_import(path):
    tree = ast.parse((REPO_ROOT / path).read_text())
    named = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            named += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            named.append(node.module)
    assert [m for m in named if _forbidden(m)] == []


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(where, tmp_path):
    if torch.cuda.is_available() and where == "repo":
        pytest.skip("a CUDA device is present: the script would run for real")
    script = REPO_ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          cwd=script.parent, env=env, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
