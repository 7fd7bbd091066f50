"""The port's integrity and observability options against the JAX
package's: ``--audit`` writes the JAX ``index.manifest.json`` byte for
byte (with and without ``index.mri``), ``--verify DIR`` accepts an
untouched directory and names every flipped file, on a segment-managed
directory its segments and tombstones too; ``--trace-out`` writes the JAX
device plans' sparse trace with the port's spans added, and nothing
without the flag;
``--profile-dir`` writes a torch.profiler trace on the CPU; and the new
config fields raise the JAX messages."""

import json
import shutil

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import (
    IndexConfig as JaxConfig,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import audit as jaudit
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cli import main as jmain
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import audit
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)

from conftest import read_letter_files

pytestmark = pytest.mark.faults


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("audit")
    docs = tsyn.zipf_corpus(num_docs=25, vocab_size=200, tokens_per_doc=30, seed=2)
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    return root / "list.txt"


def _run(fn, argv, capsys):
    capsys.readouterr()
    rc = fn(argv)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, lines, out.err


def _build(corpus, out, capsys, *extra, fn=main):
    dev = ["--device", "cpu"] if fn is main else ["--backend", "tpu", "--device-shards", "1"]
    rc, lines, err = _run(fn, ["1", "1", str(corpus), "--output-dir", str(out), "--stats",
                               "--pad-multiple", "256", *dev, *extra], capsys)
    assert rc == 0, err
    return json.loads(lines[-1])


def _flip(path, at=None):
    data = bytearray(path.read_bytes())
    i = len(data) // 2 if at is None else at
    data[i] ^= 0x01
    path.write_bytes(bytes(data))


# -- the output manifest ------------------------------------------------


@pytest.mark.parametrize("artifact", [False, True])
def test_audit_manifest_matches_jax_byte_for_byte(artifact, corpus, tmp_path, capsys):
    extra = ["--audit", *(["--artifact"] if artifact else [])]
    st = _build(corpus, tmp_path / "port", capsys, *extra)
    jst = _build(corpus, tmp_path / "jax", capsys, *extra, fn=jmain)
    got = (tmp_path / "port" / audit.MANIFEST_NAME).read_bytes()
    assert got == (tmp_path / "jax" / jaudit.MANIFEST_NAME).read_bytes()
    assert ("index.mri" in json.loads(got)["files"]) == artifact
    assert len(json.loads(got)["files"]) == 26 + artifact
    assert st["audit_ms"] >= 0 and "audit_ms" in jst
    # the JAX writer over the port's directory writes the same bytes
    shutil.copytree(tmp_path / "port", tmp_path / "again")
    jaudit.write_output_manifest(tmp_path / "again")
    assert (tmp_path / "again" / audit.MANIFEST_NAME).read_bytes() == got
    assert audit.letter_checksums(tmp_path / "port") == jaudit.letter_checksums(tmp_path / "port")


def test_no_manifest_without_audit(corpus, tmp_path, capsys):
    st = _build(corpus, tmp_path / "out", capsys)
    assert "audit_ms" not in st
    assert not (tmp_path / "out" / audit.MANIFEST_NAME).exists()


@pytest.mark.parametrize("plan", [["--backend", "oracle"], ["--pipeline-chunk-docs", "0"],
                                  ["--device-tokenize", "--stream-chunk-docs", "9"]])
def test_audit_on_every_plan_verifies(plan, corpus, tmp_path, capsys):
    st = _build(corpus, tmp_path / "out", capsys, "--audit", *plan)
    assert "audit_ms" in st
    assert audit.verify_output_dir(tmp_path / "out") == (True, [])


# -- --verify -----------------------------------------------------------


def test_cli_verify_mode_exit_codes(corpus, tmp_path, capsys):
    _build(corpus, tmp_path / "out", capsys, "--audit", "--artifact")
    rc, lines, err = _run(main, ["--verify", str(tmp_path / "out")], capsys)
    assert rc == 0 and lines == [f"verify: {tmp_path / 'out'} matches its index manifest"]
    assert err == ""
    for name in ("b.txt", "index.mri"):
        shutil.rmtree(tmp_path / "bad", ignore_errors=True)
        shutil.copytree(tmp_path / "out", tmp_path / "bad")
        _flip(tmp_path / "bad" / name)
        rc, _, err = _run(main, ["--verify", str(tmp_path / "bad")], capsys)
        assert rc == 2 and f"verify: {name}: checksum mismatch" in err
        assert err.count("\n") == 1
        # the JAX CLI reads the port's directory the same way
        assert _run(jmain, ["--verify", str(tmp_path / "bad")], capsys)[0] == 2


def test_verify_names_every_flipped_file(corpus, tmp_path, capsys):
    _build(corpus, tmp_path / "out", capsys, "--audit", "--artifact")
    flipped = ["a.txt", "q.txt", "index.mri"]
    for name in flipped:
        if (tmp_path / "out" / name).stat().st_size:
            _flip(tmp_path / "out" / name)
        else:
            (tmp_path / "out" / name).write_bytes(b"x:[1]\n")
    ok, problems = audit.verify_output_dir(tmp_path / "out")
    assert not ok and [p.split(":")[0] for p in problems] == flipped
    assert (ok, problems) == jaudit.verify_output_dir(tmp_path / "out")


def test_verify_missing_and_extra_files(corpus, tmp_path, capsys):
    _build(corpus, tmp_path / "out", capsys, "--audit")
    (tmp_path / "out" / "z.txt").unlink()
    ok, problems = audit.verify_output_dir(tmp_path / "out")
    assert not ok and any("z.txt" in p for p in problems)
    _build(corpus, tmp_path / "out2", capsys, "--audit")
    shutil.copy(tmp_path / "out" / "a.txt", tmp_path / "out2" / "index.mri")
    ok, problems = audit.verify_output_dir(tmp_path / "out2")
    assert problems == ["index.mri: present but not in manifest"]


def test_verify_without_a_manifest_or_dir(tmp_path, capsys):
    ok, problems = audit.verify_output_dir(tmp_path)
    assert not ok and "unreadable manifest" in problems[0]
    rc, _, err = _run(main, ["--verify"], capsys)
    assert rc == 2 and "needs an output directory" in err
    assert _run(main, ["--verify", str(tmp_path)], capsys)[0] == 2


def test_verify_refuses_a_segment_managed_dir(corpus, tmp_path, capsys):
    """A torn segment manifest is refused as the JAX ``--verify`` refuses
    it; a live directory verifies its segments and tombstones, and a
    flipped segment byte is named, with the JAX problem list."""
    _build(corpus, tmp_path / "out", capsys, "--audit", "--artifact")
    (tmp_path / "out" / "segments.manifest.json").write_text("{}")
    ok, problems = audit.verify_output_dir(tmp_path / "out")
    assert not ok and len(problems) == 1 and "not a segment manifest" in problems[0]
    assert (ok, problems) == jaudit.verify_output_dir(tmp_path / "out")
    rc, _, err = _run(main, ["--verify", str(tmp_path / "out")], capsys)
    assert rc == 2 and "not a segment manifest" in err
    (tmp_path / "out" / "segments.manifest.json").unlink()
    # generation 1 seeded from the artifact, then a tombstone generation
    assert main(["delete", str(tmp_path / "out"), "--docs", "3", "7"]) == 0
    assert audit.verify_output_dir(tmp_path / "out") == (True, [])
    rc, lines, _ = _run(main, ["--verify", str(tmp_path / "out")], capsys)
    assert rc == 0 and "matches its index manifest" in lines[-1]
    seg = tmp_path / "out" / "segments" / "seg_1_0"
    _flip(seg / "index.mri")
    _flip(seg / "tombstones_2.bin", at=9)
    ok, problems = audit.verify_output_dir(tmp_path / "out")
    assert not ok and len(problems) == 2
    assert all("checksum mismatch" in p for p in problems)
    assert (ok, problems) == jaudit.verify_output_dir(tmp_path / "out")


# -- --trace-out and --profile-dir --------------------------------------


@pytest.mark.parametrize("plan", [[], ["--device-tokenize"], ["--backend", "oracle"]])
def test_trace_out_writes_the_jax_sparse_trace(plan, corpus, tmp_path, capsys):
    """The port's metadata events equal the JAX package's sparse trace,
    and the port adds its spans: the CLI's manifest and build, and each
    phase of ``--stats``."""
    st = _build(corpus, tmp_path / "port", capsys, "--trace-out", str(tmp_path / "p.json"),
                *plan)
    jst = _build(corpus, tmp_path / "jax", capsys, "--trace-out", str(tmp_path / "j.json"),
                 *plan, fn=jmain)
    assert st["trace_out"] == str(tmp_path / "p.json") and "trace_out" in jst
    doc = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert meta == want["traceEvents"] and len(meta) + len(spans) == len(doc["traceEvents"])
    assert {e["name"] for e in meta} == {"process_name", "thread_name"}
    assert doc["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    assert sorted(e["name"] for e in spans) == sorted(["manifest", "build", *st["phases_ms"]])
    assert list(tmp_path.glob("p.json.tmp*")) == []


def test_trace_out_absent_without_flag(corpus, tmp_path, capsys):
    st = _build(corpus, tmp_path / "out", capsys)
    assert "trace_out" not in st
    assert not list(tmp_path.rglob("*.json"))


@pytest.mark.parametrize("plan", [[], ["--pipeline-chunk-docs", "0"],
                                  ["--stream-chunk-docs", "9"], ["--device-tokenize"],
                                  ["--overlap-tail-fraction", "0.4"]])
def test_profile_dir_writes_a_torch_trace_on_the_cpu(plan, corpus, tmp_path, capsys):
    st = _build(corpus, tmp_path / "out", capsys, "--profile-dir", str(tmp_path / "prof"),
                *plan)
    traces = sorted((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    _build(corpus, tmp_path / "plain", capsys, *plan)
    assert read_letter_files(tmp_path / "out") == read_letter_files(tmp_path / "plain")
    assert "profile_dir" not in st


# -- the config fields --------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"checkpoint_path": "c.npz", "stream_chunk_docs": 4},
    {"checkpoint_path": "c.npz", "device_tokenize": True},
    {"checkpoint_path": "c.npz", "device_tokenize": True, "pipeline_chunk_docs": 4},
    {"checkpoint_path": "c.npz", "backend": "oracle"},
    {"profile_dir": "p", "backend": "oracle"},
    {"stream_chunk_docs": 4, "profile_dir": "p", "backend": "oracle"},
])
def test_config_validations_raise_the_jax_messages(kw):
    with pytest.raises(ValueError) as got:
        tpkg.IndexConfig(**kw)
    jkw = dict(kw, backend="tpu" if kw.get("backend", "cuda") == "cuda" else kw["backend"])
    with pytest.raises(ValueError) as want:
        JaxConfig(**jkw)
    assert str(got.value) == str(want.value).replace("'tpu'", "'cuda'")


def test_config_accepts_the_options():
    cfg = tpkg.IndexConfig(checkpoint_path="c.npz", profile_dir="p", audit=True,
                           trace_out="t.json", pipeline_chunk_docs=0)
    assert (cfg.checkpoint_path, cfg.profile_dir, cfg.audit, cfg.trace_out) == (
        "c.npz", "p", True, "t.json")
    assert tpkg.IndexConfig(backend="oracle", audit=True, trace_out="t.json").audit
