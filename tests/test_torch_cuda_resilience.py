"""The build's resilience options on the card, at the size of
``chip_smoke.py``'s Path A (355 Zipf documents): the pairs checkpoint
saved and resumed (``--checkpoint``, with ``--skew``: the
``bucket_histogram`` kernel launched on the resume), read faults on the
pipelined and all-device plans (same bytes and degradation block as the
CPU build under the same spec), and the streaming all-device plan killed
at a window boundary, crashed in the engine and torn at a save, each
resumed with ``--resume auto`` to the oracle's bytes.  Every test needs a
CUDA device and skips without one; none needs JAX, so on the card
``python -m pytest --noconftest tests/test_torch_cuda_resilience.py -m
cuda`` runs them."""

import io
import json
import os
import signal
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli, faults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    kernels as tk,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
    formatter as tfmt,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
PKG = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def _disarm():
    faults.install(None)
    yield
    faults.install(None)


@pytest.fixture(scope="module")
def path_a(tmp_path_factory):
    """Path A's corpus and its oracle md5."""
    _need_cuda()
    root = tmp_path_factory.mktemp("path_a")
    docs = tsyn.zipf_corpus(num_docs=355, vocab_size=33_000, tokens_per_doc=2900, seed=7)
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    tpkg.oracle_index(tman.read_manifest(root / "list.txt"), root / "oracle")
    return root / "list.txt", tfmt.letters_md5(root / "oracle")


def _cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _build(list_path, out, *extra, device="cuda"):
    return _cli(["4", "26", str(list_path), "--stats", "--device", device,
                 "--output-dir", str(out), *extra])


def test_k1_pairs_checkpoint_save_and_resume_on_the_card(path_a, tmp_path):
    _need_cuda()
    list_path, md5 = path_a
    argv = ["--skew", "--checkpoint", str(tmp_path / "pairs.npz")]
    rc, save = _build(list_path, tmp_path / "save", *argv)
    assert rc == 0 and "checkpoint" in save["phases_ms"]
    tk.reset_launch_counts()
    rc, resume = _build(list_path, tmp_path / "resume", *argv)
    assert rc == 0 and resume["resumed_from"] == str(tmp_path / "pairs.npz")
    assert "resume" in resume["phases_ms"] and "load" not in resume["phases_ms"]
    assert tk.bucket_histogram.launches == 2  # letters and hash buckets
    assert tfmt.letters_md5(tmp_path / "save") == tfmt.letters_md5(tmp_path / "resume") == md5
    # a torn checkpoint: strict refuses, auto quarantines and rebuilds
    p = tmp_path / "pairs.npz"
    with open(p, "r+b") as f:
        f.truncate(p.stat().st_size // 3)
    assert _build(list_path, tmp_path / "strict", *argv)[0] == 2
    rc, auto = _build(list_path, tmp_path / "auto", *argv, "--resume", "auto")
    assert rc == 0 and auto["quarantined_checkpoint"] == str(p) + ".corrupt"
    assert tfmt.letters_md5(tmp_path / "auto") == md5


@pytest.mark.parametrize("plan", [[], ["--device-tokenize"]])
@pytest.mark.parametrize("spec", ["read-error:every=97:times=2", "read-error:doc=4:times=-1"])
def test_k2_read_faults_on_the_card_match_the_cpu(plan, spec, path_a, tmp_path, monkeypatch):
    _need_cuda()
    list_path, md5 = path_a
    monkeypatch.setenv("MRI_READ_BACKOFF_MS", "0")
    runs = {}
    for device in ("cuda", "cpu"):
        rc, st = _build(list_path, tmp_path / device, *plan, "--fault-spec", spec,
                        device=device)
        runs[device] = (rc, st["degradation"], tfmt.letters_md5(tmp_path / device))
    assert runs["cuda"] == runs["cpu"]
    rc, deg, got = runs["cuda"]
    if spec.endswith("times=2"):
        assert rc == 0 and got == md5 and deg["skipped_docs"] == []
        assert deg["read_retries"] == 2 * len(range(0, 355, 97))
    else:
        assert rc == 3 and deg["skipped_docs"] == [5] and deg["read_retries"] == 2


def _stream_argv(list_path, tmp_path):
    return ["4", "26", str(list_path), "--stats", "--output-dir", str(tmp_path / "out"),
            "--device-tokenize", "--stream-chunk-docs", "50",
            "--stream-checkpoint", str(tmp_path / "ck.npz"), "--stream-checkpoint-every", "2",
            "--resume", "auto"]


def test_k3_sigkill_at_a_window_boundary_then_resume(path_a, tmp_path):
    _need_cuda()
    list_path, md5 = path_a
    proc = subprocess.run([sys.executable, "-m", PKG, *_stream_argv(list_path, tmp_path)],
                          cwd=str(REPO_ROOT), timeout=600, capture_output=True,
                          env={**os.environ, "PYTHONPATH": str(REPO_ROOT),
                               "MRI_FAULTS": "sigkill:window=5"})
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert (tmp_path / "ck.npz").exists()
    rc, st = _cli(_stream_argv(list_path, tmp_path))
    assert rc == 0 and st["resumed_from_window"] == 4 and not (tmp_path / "ck.npz").exists()
    assert tfmt.letters_md5(tmp_path / "out") == md5


def test_k3_stream_crash_and_torn_save_then_resume(path_a, tmp_path):
    _need_cuda()
    list_path, md5 = path_a
    argv = _stream_argv(list_path, tmp_path)
    faults.install("stream-crash:window=3")
    with pytest.raises(RuntimeError, match="injected stream crash after window 3"):
        _cli(argv)
    faults.install(None)
    rc, st = _cli(argv)
    assert rc == 0 and st["resumed_from_window"] == 2
    assert tfmt.letters_md5(tmp_path / "out") == md5
    faults.install("ckpt-corrupt:save=1; stream-crash:window=3")
    with pytest.raises(RuntimeError, match="injected stream crash"):
        _cli(argv)
    faults.install(None)
    rc, st = _cli(argv)
    assert rc == 0 and "quarantined_checkpoint" in st and "resumed_from_window" not in st
    assert tfmt.letters_md5(tmp_path / "out") == md5
