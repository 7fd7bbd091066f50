"""Crash safety of the port's build, with real child processes on the
CPU: a SIGKILL at a stream-window boundary (``sigkill:window=K``), an
engine crash (``stream-crash``) and a torn checkpoint save
(``ckpt-corrupt``) each rerun with ``--resume auto`` to the oracle's
bytes; a SIGKILL after the Nth letter file of the emit
(``MRI_EMIT_KILL_AFTER_LETTERS``, native and Python writers) leaves the
completed letters whole and no truncated one.  The JAX package's
``tests/test_faults.py`` and ``tests/test_emit_backend.py`` cases, on
the port's CLI."""

import json
import os
import signal
import sys

import pytest

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import faults, native
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)

from conftest import REPO_ROOT, read_letter_files, run_child

pytestmark = pytest.mark.faults

PKG = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
KILL_TEXTS = (b"alpha beta", b"beta gamma", b"delta alpha", b"epsilon beta", b"zeta eta alpha")


@pytest.fixture(autouse=True)
def _disarm():
    faults.install(None)
    yield
    faults.install(None)


def _corpus(tmp_path, docs=KILL_TEXTS):
    paths = tsyn.write_corpus(tmp_path / "docs", list(docs))
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tman.read_manifest(tmp_path / "list.txt")
    tpkg.oracle_index(m, tmp_path / "clean")
    return read_letter_files(tmp_path / "clean")


def _stream_argv(tmp_path):
    return ["1", "1", str(tmp_path / "list.txt"), "--device", "cpu",
            "--output-dir", str(tmp_path / "out"),
            "--device-tokenize", "--stream-chunk-docs", "1", "--pad-multiple", "64",
            "--stream-checkpoint", str(tmp_path / "run.ckpt.npz"),
            "--stream-checkpoint-every", "1", "--resume", "auto", "--stats"]


def _child(argv, **env):
    """The port's CLI in a child process (its own session, group-killed
    on a hang); returns the finished process."""
    return run_child([sys.executable, "-m", PKG, *argv], cwd=str(REPO_ROOT),
                     env={**os.environ, "PYTHONPATH": str(REPO_ROOT), **env}, timeout=300)


def _rerun(tmp_path, capsys) -> dict:
    capsys.readouterr()
    assert main(_stream_argv(tmp_path)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# Two kill points of the 5-window stream: right after the first save,
# and after the last window that saves (the last window's save is
# skipped by design).
@pytest.mark.parametrize("window", [1, 4])
def test_sigkill_at_window_boundary_resume_byte_identical(window, tmp_path, capsys):
    golden = _corpus(tmp_path)
    proc = _child(_stream_argv(tmp_path), MRI_FAULTS=f"sigkill:window={window}")
    assert proc.returncode == -signal.SIGKILL
    ckpt = tmp_path / "run.ckpt.npz"
    assert ckpt.exists()  # the kill landed after a completed save
    stats = _rerun(tmp_path, capsys)
    assert stats["resumed_from_window"] == window
    assert not ckpt.exists()
    assert read_letter_files(tmp_path / "out") == golden


def test_stream_crash_then_resume_at_the_last_save(tmp_path, capsys):
    """The engine dies folding window 3 — after window 2's save, before
    window 3's — and the rerun resumes after window 2."""
    golden = _corpus(tmp_path)
    proc = _child(_stream_argv(tmp_path), MRI_FAULTS="stream-crash:window=3")
    assert proc.returncode == 1
    assert (tmp_path / "run.ckpt.npz").exists()
    stats = _rerun(tmp_path, capsys)
    assert stats["resumed_from_window"] == 2
    assert read_letter_files(tmp_path / "out") == golden


def test_corrupt_save_then_kill_quarantines_and_rebuilds(tmp_path, capsys):
    """``ckpt-corrupt:save=2`` tears the second save and the kill right
    after it leaves the torn file behind; ``--resume auto`` quarantines
    it and rebuilds from the start."""
    golden = _corpus(tmp_path)
    proc = _child(_stream_argv(tmp_path), MRI_FAULTS="ckpt-corrupt:save=2; sigkill:window=2")
    assert proc.returncode == -signal.SIGKILL
    stats = _rerun(tmp_path, capsys)
    assert stats["quarantined_checkpoint"] == str(tmp_path / "run.ckpt.npz") + ".corrupt"
    assert "resumed_from_window" not in stats
    assert (tmp_path / "run.ckpt.npz.corrupt").exists()
    assert read_letter_files(tmp_path / "out") == golden


@pytest.mark.parametrize("backend", ["python", "native"])
def test_kill_mid_emit_leaves_no_truncated_file(backend, tmp_path):
    """SIGKILL after the 7th letter: completed letters are byte-exact,
    later letters are absent or ``.tmp`` residue — never a truncated
    ``<letter>.txt`` that would parse as a smaller plausible index."""
    if backend == "native" and not native.available():
        pytest.skip("no C++ toolchain")
    docs = tsyn.zipf_corpus(num_docs=30, vocab_size=400, tokens_per_doc=40, seed=4)
    golden = _corpus(tmp_path, docs)
    argv = ["1", "1", str(tmp_path / "list.txt"), "--device", "cpu",
            "--output-dir", str(tmp_path / "killed"), "--emit-backend", backend]
    proc = _child(argv, MRI_EMIT_KILL_AFTER_LETTERS="7")
    assert proc.returncode == -signal.SIGKILL
    survivors = 0
    clean = tmp_path / "clean"
    for i in range(26):
        name = f"{chr(ord('a') + i)}.txt"
        final = tmp_path / "killed" / name
        if final.exists():
            # anything that looks complete must be complete
            assert final.read_bytes() == (clean / name).read_bytes()
            survivors += 1
        else:
            leftovers = list((tmp_path / "killed").glob(name + "*"))
            assert [p.suffix for p in leftovers] in ([], [".tmp"])
    assert survivors == 7  # killed right after the 7th rename
    assert len(golden) > 0
