"""The port's ops/engine.py against the JAX package's device programs, on
the same numpy feeds (INT32_MAX / 0xFFFF padding included).  The JAX
side runs on the CPU backend; exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.ops import (
    engine as je,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    engine as te,
)

INT32_MAX = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pairs(n_tokens, vocab, max_doc, seed, dup_frac=0.5):
    """Random (term, doc) pairs with many exact duplicates (the numpy
    tokenizer keeps every occurrence), plus a letter per term."""
    rng = np.random.default_rng(seed)
    base = n_tokens - int(n_tokens * dup_frac)
    terms = rng.integers(0, vocab, base).astype(np.int32)
    docs = rng.integers(1, max_doc + 1, base).astype(np.int32)
    pick = rng.integers(0, base, n_tokens - base)
    terms = np.concatenate([terms, terms[pick]])
    docs = np.concatenate([docs, docs[pick]])
    letters = rng.integers(0, 26, vocab).astype(np.int32)
    return terms, docs, letters


def _packed_feed(terms, docs, max_doc, padded):
    keys = np.full(padded, INT32_MAX, np.int32)
    keys[: len(terms)] = terms * (max_doc + 2) + docs
    return keys


def _assert_outputs_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("seed,n,vocab,max_doc", [(0, 5000, 300, 40), (1, 12000, 2000, 355),
                                                  (2, 700, 9, 3)])
def test_dedup_df_postings_matches(seed, n, vocab, max_doc):
    terms, docs, _ = _pairs(n, vocab, max_doc, seed)
    keys = np.sort(_packed_feed(terms, docs, max_doc, 16384))
    want = je.dedup_df_postings(jnp.asarray(keys), vocab_size=vocab, max_doc_id=max_doc)
    got = te.dedup_df_postings(_t(keys), vocab_size=vocab, max_doc_id=max_doc)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("vocab,max_doc", [
    (300, 40),
    (2000, 355),
    # 26 * stride * (vocab + 1) >= 2**31: the JAX package's stable
    # three-key sort, the port's int64 key
    (50, 2_000_000),
    (70_000, 30_700),
])
def test_emit_order_matches(vocab, max_doc):
    rng = np.random.default_rng(vocab)
    letters = rng.integers(0, 26, vocab).astype(np.int32)
    # few distinct df values so the term-ascending tiebreak decides often
    df = rng.integers(0, 4, vocab).astype(np.int32)
    df[: vocab // 3] = max_doc + 1 if max_doc < 100 else 3
    want = np.asarray(je.emit_order(jnp.asarray(letters), jnp.asarray(df), vocab, max_doc))
    got = te.emit_order(_t(letters), _t(df), vocab, max_doc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_emit_order_int32_overflow_shape_takes_the_stable_sort_in_jax():
    # documents the shape the overflow case above exercises
    assert 26 * (2_000_000 + 2) * 51 >= 2**31
    assert 26 * (30_700 + 2) * 70_001 >= 2**31


@pytest.mark.parametrize("seed", [0, 1])
def test_host_order_offsets_and_pack_u16_feed_match(seed):
    terms, docs, letters = _pairs(3000, 500, 60, seed)
    df = np.bincount(terms, minlength=500)
    for w, g in zip(je.host_order_offsets(letters, df), te.host_order_offsets(letters, df)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(te.pack_u16_feed(terms, docs, 4096),
                                  je.pack_u16_feed(terms, docs, 4096))


@pytest.mark.parametrize("max_doc", [60, 0xFFFE])
def test_u16_feed_decode_matches(max_doc):
    terms, docs, _ = _pairs(3000, 30_000 if max_doc < 100 else 30, max_doc, 5)
    buf = je.pack_u16_feed(terms, docs, 4096)
    want = np.asarray(je._u16_feed_to_keys(jnp.asarray(buf), max_doc))
    got = te.u16_feed_to_keys(te.u16_feed_tensor(buf, "cpu"), max_doc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,n,vocab,max_doc,padded", [
    (0, 5000, 300, 40, 8192),
    (1, 20000, 3000, 355, 32768),
    (2, 9000, 65535, 200, 16384),       # the widest u16 vocab
    (3, 6000, 40, 65534, 8192),         # the widest u16 doc id
])
def test_index_u16_matches(seed, n, vocab, max_doc, padded):
    terms, docs, _ = _pairs(n, vocab, max_doc, seed)
    buf = je.pack_u16_feed(terms, docs, padded)
    want = np.asarray(je.index_u16(jnp.asarray(buf), vocab_size=vocab,
                                   max_doc_id=max_doc)["combined"])
    out = te.index_u16(te.u16_feed_tensor(buf, "cpu"), vocab_size=vocab, max_doc_id=max_doc)
    got = te.narrow_u16(out["combined"])
    assert got.dtype == np.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n,vocab,max_doc,padded", [
    (0, 5000, 300, 40, 8192),
    (1, 30000, 70_000, 355, 65536),     # vocab past the u16 path
    (2, 4000, 100, 100_000, 8192),      # docs past the u16 path
])
def test_index_packed_matches(seed, n, vocab, max_doc, padded):
    terms, docs, letters = _pairs(n, vocab, max_doc, seed)
    keys = _packed_feed(terms, docs, max_doc, padded)
    np.random.default_rng(seed).shuffle(keys)
    want = je.index_packed(jnp.asarray(keys), jnp.asarray(letters),
                           vocab_size=vocab, max_doc_id=max_doc)
    got = te.index_packed(_t(keys), _t(letters), vocab_size=vocab, max_doc_id=max_doc)
    _assert_outputs_equal({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("seed,n,vocab,max_doc,padded", [
    (0, 5000, 300, 40, 8192),
    (1, 8000, 70_000, 40_000, 16384),   # (V+1)(docs+2) >= 2**31: no int32 key
])
def test_index_pairs_matches(seed, n, vocab, max_doc, padded):
    terms, docs, letters = _pairs(n, vocab, max_doc, seed)
    perm = np.random.default_rng(seed).permutation(n)
    pad = np.full(padded - n, INT32_MAX, np.int32)
    t_in = np.concatenate([terms[perm], pad])
    d_in = np.concatenate([docs[perm], pad])
    want = je.index_pairs(jnp.asarray(t_in), jnp.asarray(d_in), jnp.asarray(letters),
                          vocab_size=vocab, max_doc_id=max_doc)
    got = te.index_pairs(_t(t_in), _t(d_in), _t(letters), vocab_size=vocab, max_doc_id=max_doc)
    _assert_outputs_equal({k: v.numpy() for k, v in got.items()}, want)


def test_packed_and_pairs_agree_with_u16():
    terms, docs, letters = _pairs(4000, 500, 80, 9)
    padded = 8192
    u16 = te.narrow_u16(te.index_u16(
        te.u16_feed_tensor(te.pack_u16_feed(terms, docs, padded), "cpu"),
        vocab_size=500, max_doc_id=80)["combined"])
    packed = te.index_packed(_t(_packed_feed(terms, docs, 80, padded)), _t(letters),
                             vocab_size=500, max_doc_id=80)
    pad = np.full(padded - 4000, INT32_MAX, np.int32)
    pairs = te.index_pairs(_t(np.concatenate([terms, pad])), _t(np.concatenate([docs, pad])),
                           _t(letters), vocab_size=500, max_doc_id=80)
    for out in (packed, pairs):
        np.testing.assert_array_equal(out["df"].numpy(), u16[:500])
        nu = int(out["num_unique"])
        np.testing.assert_array_equal(out["postings"].numpy()[:nu], u16[500 : 500 + nu])
