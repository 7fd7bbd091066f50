"""The plain reference against the port's CPU paths at a tiny size: the
letter files and the artifact of both build plans the cells run.  (The
reference itself imports nothing of the port.)"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
from portbench_cells import tiny

from portbench import gen
from portbench.entries import build
from portbench.reference import letters

PORT = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
SEED = 2 ** 32 + 77


def _port_build(tmp: Path, docs: list[bytes], argv: list[str]) -> list[bytes]:
    """The port's letter files of ``docs`` (and ``index.mri`` beside them)."""
    import importlib

    port = importlib.import_module(PORT)
    cli = importlib.import_module(f"{PORT}.cli")
    paths = []
    for i, d in enumerate(docs):
        p = tmp / "docs" / f"d{i:05d}.txt"
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(d)
        paths.append(str(p))
    port.write_manifest(tmp / "list.txt", paths)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["4", "26", str(tmp / "list.txt"), "--device", "cpu", "--output-dir",
                         str(tmp / "out"), *argv]) == 0
    return [(tmp / "out" / f"{chr(97 + i)}.txt").read_bytes() for i in range(26)]


def _docs_of(c):
    return [c.doc(i) for i in range(len(c))]


def _ref(docs):
    buf = np.frombuffer(b"".join(docs), dtype=np.uint8)
    lens = np.array([len(d) for d in docs], dtype=np.int64)
    stops = np.cumsum(lens)
    return letters.letter_files(letters.index(buf, stops - lens, stops))


@pytest.mark.parametrize("cell", ["build.zipf100k.stream-device", "build.zipf100k.default"])
def test_letter_files_equal_the_port_build(tmp_path, cell):
    c = tiny(cell)
    corpus = gen.corpus(c["config_params"], SEED)
    got = _port_build(tmp_path, _docs_of(corpus), c["mix"]["argv"])
    assert _ref(_docs_of(corpus)) == got


EDGE = [b"Hello, World! don't\tstop\n\nCAF\xc3\xa9 123 a-b " + b"x" * 400,
        b"  the the THE tHe\x0bend", b"", b"...", b"zebra Zebra apple ab1c",
        b"abcdefghijklmnopqrstu abc\r\nxyz"]


def test_tokenisation_edges_equal_the_port(tmp_path):
    assert _ref(EDGE) == _port_build(tmp_path, EDGE, [])


def test_control_differs_from_the_reference():
    c = gen.corpus(tiny("build.zipf100k.default")["config_params"], SEED)
    want = letters.letter_files(letters.index(c.buf, c.starts, c.stops))
    ctl = letters.letter_files(letters.index(c.buf, c.starts, c.stops, dedup=False))
    assert sum(a != b for a, b in zip(want, ctl)) > 0



@pytest.mark.parametrize("cell", ["build.zipf100k.stream-device", "build.zipf100k.default"])
def test_artifact_equals_the_reference(tmp_path, cell):
    c = tiny(cell)
    corpus = gen.corpus(c["config_params"], SEED)
    _port_build(tmp_path, _docs_of(corpus), c["mix"]["argv"])
    ix = letters.index(corpus.buf, corpus.starts, corpus.stops)
    every = np.arange(len(ix.words))
    assert build.artifact_wrong(tmp_path / "out" / "index.mri", ix, len(corpus), every) == (0, 0)
    assert build.artifact_wrong(None, ix, len(corpus), every) == (len(ix.words), len(corpus))
