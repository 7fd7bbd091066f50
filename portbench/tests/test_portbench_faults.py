"""Whole runs on the CPU (the look for a card skipped) with the timed
path broken underneath must come out ``correct: false``: an answer
altered where it is produced (a letter file, a posting of the artifact),
half of the documents left out, and the artifact not packed.  (A cell on
one card has no exchange between cards to leave out, and no step whose
state could come back unchanged.)"""

import importlib
import time
from pathlib import Path

import numpy as np
import pytest
from portbench_cells import tiny

from portbench import run

PORT = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
CELLS = ["build.zipf100k.stream-device", "build.zipf100k.default"]


def _run(name: str) -> dict:
    return run.run_cell(name, 2 ** 31 + 21, 1.0, False, device="cpu", t0=time.monotonic(),
                        cell=tiny(name))


def _flip_a_byte(monkeypatch):
    formatter = importlib.import_module(f"{PORT}.text.formatter")
    emit = formatter.emit_index

    def altered(output_dir, *a, **kw):
        out = emit(output_dir, *a, **kw)
        p = max(Path(output_dir).glob("?.txt"), key=lambda f: f.stat().st_size)
        data = bytearray(p.read_bytes())
        data[0] = ord("z") if data[0] != ord("z") else ord("y")
        p.write_bytes(bytes(data))
        return out

    monkeypatch.setattr(formatter, "emit_index", altered)


def _half_the_documents(monkeypatch):
    cli = importlib.import_module(f"{PORT}.cli")
    manifest = importlib.import_module(f"{PORT}.corpus.manifest")
    read = cli.read_manifest

    def half(path, *a, **kw):
        m = read(path, *a, **kw)
        n = len(m) // 2
        return manifest.Manifest(paths=m.paths[:n], sizes=m.sizes[:n])

    monkeypatch.setattr(cli, "read_manifest", half)


def _no_artifact(monkeypatch):
    artifact = importlib.import_module(f"{PORT}.serve.artifact")
    monkeypatch.setattr(artifact, "build_from_emit_arrays", lambda path, **kw: 0)


def _alter_a_posting(monkeypatch):
    """The last doc id of the first term whose last id is below the
    largest, raised by one as the artifact is packed (still ascending)."""
    artifact = importlib.import_module(f"{PORT}.serve.artifact")
    pack = artifact.build_from_emit_arrays

    def altered(path, *, df, offsets, postings, max_doc_id, **kw):
        postings = np.array(postings, copy=True)
        last = np.asarray(offsets)[:len(df)] + np.asarray(df) - 1
        t = int(np.nonzero(postings[last] < max_doc_id)[0][0])
        postings[last[t]] += 1
        return pack(path, df=df, offsets=offsets, postings=postings,
                    max_doc_id=max_doc_id, **kw)

    monkeypatch.setattr(artifact, "build_from_emit_arrays", altered)


FAULTS = [_flip_a_byte, _half_the_documents, _no_artifact, _alter_a_posting]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(tmp_root, monkeypatch, name, fault):
    fault(monkeypatch)
    line = _run(name)
    assert line["correct"] is False, line["compared"]


def test_artifact_faults_read_on_the_artifact(tmp_root, monkeypatch):
    _alter_a_posting(monkeypatch)
    comp = _run(CELLS[0])["compared"]
    assert comp["wrong_letter_files"]["value"] == 0
    assert comp["wrong_artifact_terms"]["value"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tmp_root, name):
    assert _run(name)["correct"] is True
