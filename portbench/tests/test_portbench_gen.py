"""The generator: the same seed gives the same inputs, another seed other
inputs of the same sizes."""

import numpy as np
import pytest
from portbench_cells import tiny

from portbench import gen

SEEDS = (7, 2 ** 31 + 11, 2 ** 33 + 5)


@pytest.mark.parametrize("cell", ["build.zipf100k.stream-device", "build.zipf100k.default"])
def test_corpus_is_a_function_of_the_seed(cell):
    cfg = tiny(cell)["config_params"]
    a, b, other = gen.corpus(cfg, SEEDS[1]), gen.corpus(cfg, SEEDS[1]), gen.corpus(cfg, SEEDS[2])
    assert a.buf.tobytes() == b.buf.tobytes()
    assert a.buf.tobytes() != other.buf.tobytes()
    assert sorted(a.doc_tokens.tolist()) == sorted(other.doc_tokens.tolist())
    assert abs(a.total_bytes - other.total_bytes) / a.total_bytes < 0.02


def test_documents_are_their_words():
    cfg = tiny("build.zipf100k.default")["config_params"]
    c = gen.corpus(cfg, SEEDS[0])
    ends = np.cumsum(c.doc_tokens)
    for i in (0, 1, len(c) - 1):
        words = [c.word(int(t)) for t in c.tokens[ends[i] - c.doc_tokens[i]:ends[i]]]
        assert c.doc(i) == " ".join(words).encode()


def test_vocabulary_is_distinct_with_fixed_lengths_per_rank():
    r1, l1 = gen.make_vocab(5000, 2, 10, np.random.default_rng(1))
    r2, l2 = gen.make_vocab(5000, 2, 10, np.random.default_rng(2))
    assert len({bytes(r) for r in r1}) == 5000
    assert (l1 == l2).all() and not (r1 == r2).all()
    assert ((r1 != 0).sum(axis=1) == l1).all()


def test_zipf_table_is_the_inverse_cdf():
    z = gen.ZipfTable(50_000, 1.0)
    u = np.random.default_rng(3).random(200_000)
    p = np.arange(1, 50_001, dtype=np.float64) ** -1.0
    want = np.searchsorted(np.cumsum(p / p.sum()), u, side="right").clip(0, 49_999)
    assert (z.ranks(u) == want).all()

