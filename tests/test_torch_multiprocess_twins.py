"""Twins of the JAX package's 2-process tests (``tests/test_distributed.py``),
part 1: the letter-ownership exchange and the mesh all-device engine.

Each starts the JAX package's 2-process workers (2 virtual CPU devices
apiece, a 4-device global mesh) and the port's 2-process workers (a gloo
group, 2 of 4 mesh positions apiece) on one ``zipf_corpus`` with the JAX
test's parameters, and asserts that each port process holds exactly the
owners its JAX counterpart holds, that the letter files or owner blocks
are byte-equal to the JAX run's, and that they equal ``oracle_index``.
"""

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
    DEVTOK_WORKER,
    WORKER,
    finish,
    jax_pair,
    same_owner_blocks,
    start_pair,
)


def _dirs(tmp_path, *names):
    for name in names:
        (tmp_path / name).mkdir()
    return [tmp_path / name for name in names]


def test_two_process_letter_emit_matches_oracle(tmp_path):
    write_corpus(tmp_path / "docs",
                 zipf_corpus(num_docs=24, vocab_size=300, tokens_per_doc=60, seed=77))
    jout, tout = _dirs(tmp_path, "jax_out", "port_out")
    jprocs = jax_pair(tmp_path, "jax_worker", jdist.WORKER, tmp_path / "docs", jout)
    tprocs = start_pair(tmp_path, "port_worker", WORKER, tmp_path / "docs", tout)
    jouts, touts = finish(jprocs), finish(tprocs)

    oracle_index(manifest_from_dir(tmp_path / "docs"), tmp_path / "oracle")
    want = read_letter_files(tmp_path / "oracle")
    assert read_letter_files(tout) == read_letter_files(jout) == want
    for pid, owners in enumerate(("owners [0, 1]", "owners [2, 3]")):
        assert owners in jouts[pid][0] and owners in touts[pid][0]


def test_two_process_device_tokenize_fetch(tmp_path):
    write_corpus(tmp_path / "docs",
                 zipf_corpus(num_docs=22, vocab_size=250, tokens_per_doc=50, seed=31))
    jout, tout = _dirs(tmp_path, "jax_blocks", "port_blocks")
    jprocs = jax_pair(tmp_path, "jax_worker", jdist.DEVTOK_WORKER, tmp_path / "docs", jout)
    tprocs = start_pair(tmp_path, "port_worker", DEVTOK_WORKER, tmp_path / "docs", tout)
    jouts, touts = finish(jprocs), finish(tprocs)

    for pid, owners in enumerate(("fetched owners [0, 1]", "fetched owners [2, 3]")):
        assert owners in jouts[pid][0] and owners in touts[pid][0]
    same_owner_blocks(tout, jout)
    jdist._check_owner_blocks_vs_oracle(tout, tmp_path / "docs")
