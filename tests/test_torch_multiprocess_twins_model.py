"""Twins of the JAX package's 2-process tests (``tests/test_distributed.py``),
part 2: the model's letter emit on the mesh all-device plan, and the
mesh streaming all-device engine through several windows with regrows.

As in part 1 (``test_torch_multiprocess_twins.py``): the JAX package's
2-process workers and the port's on one ``zipf_corpus`` with the JAX
test's parameters; the same owners per process, byte-equal letter files
or owner blocks, and equality with ``oracle_index``.
"""

import re

import test_distributed as jdist
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import oracle_index
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus.manifest import (
    manifest_from_dir,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus.synthetic import (
    write_corpus,
    zipf_corpus,
)

from conftest import read_letter_files
from test_torch_multiprocess import (
    DEVSTREAM_WORKER,
    DEVTOK_LETTER_WORKER,
    finish,
    jax_pair,
    same_owner_blocks,
    start_pair,
)


def test_two_process_device_tokenize_letter_emit(tmp_path):
    """Each process writes only its own owners' letter files into one
    shared directory; the union equals the JAX run's and the oracle's,
    and each process wrote the lines its JAX counterpart wrote."""
    write_corpus(tmp_path / "docs",
                 zipf_corpus(num_docs=26, vocab_size=350, tokens_per_doc=45, seed=91))
    jout, tout = tmp_path / "jax_out", tmp_path / "port_out"
    jout.mkdir()
    tout.mkdir()
    jprocs = jax_pair(tmp_path, "jax_worker", jdist.DEVTOK_LETTER_WORKER, tmp_path / "docs",
                      jout)
    tprocs = start_pair(tmp_path, "port_worker", DEVTOK_LETTER_WORKER, tmp_path / "docs", tout)
    jouts, touts = finish(jprocs), finish(tprocs)

    oracle_index(manifest_from_dir(tmp_path / "docs"), tmp_path / "oracle")
    assert read_letter_files(tout) == read_letter_files(jout) == read_letter_files(
        tmp_path / "oracle")
    line = re.compile(r"proc (\d) letter_owners=(\d+) lines=(\d+)")
    for (jo, _), (to, _) in zip(jouts, touts):
        assert line.search(jo).groups() == line.search(to).groups()
    assert sum(int(line.search(to).group(3)) for to, _ in touts) > 0
    # the run reports what each process sent the other
    sent = re.compile(r"proc (\d) dist_sent_bytes=(\d+)")
    assert [int(sent.search(to).group(2)) > 0 for to, _ in touts] == [True, True]


def test_two_process_device_stream_accumulator(tmp_path):
    write_corpus(tmp_path / "docs",
                 zipf_corpus(num_docs=26, vocab_size=220, tokens_per_doc=40, seed=37))
    jout, tout = tmp_path / "jax_blocks", tmp_path / "port_blocks"
    jout.mkdir()
    tout.mkdir()
    jprocs = jax_pair(tmp_path, "jax_worker", jdist.DEVSTREAM_WORKER, tmp_path / "docs", jout)
    tprocs = start_pair(tmp_path, "port_worker", DEVSTREAM_WORKER, tmp_path / "docs", tout)
    jouts, touts = finish(jprocs), finish(tprocs)

    stream = re.compile(r"stream owners (\[[\d, ]+\]) windows (\d+) cap (\d+)")
    caps = []
    for pid, owners in enumerate(("[0, 1]", "[2, 3]")):
        j, t = stream.search(jouts[pid][0]), stream.search(touts[pid][0])
        assert j.group(1) == t.group(1) == owners
        # the same windows; each grew its accumulators from 32 (the port
        # to what its owners' rows need, the JAX package by doubling)
        assert j.group(2) == t.group(2) and int(j.group(3)) > 32 and int(t.group(3)) > 32
        caps.append(t.group(3))
    # every size comes from the one read both processes share
    assert caps[0] == caps[1]
    same_owner_blocks(tout, jout)
    jdist._check_owner_blocks_vs_oracle(tout, tmp_path / "docs")
