"""ctypes loader for the native host scan (``native/tokenizer.cc``).

The host hot path — tokenize + vocab build + per-(term, doc) combiner,
the analogue of main.c:102-117 plus the reducer's dictionary and dedup —
and the letter-file emit are a C++ library compiled with ``g++`` on
first use and loaded with ctypes.  Without a compiler the callers fall
back to the numpy tokenizer and the Python emit (same bytes, slower).

The library is built into ``native/_build/`` as
``libmri_torch_scan_<hash>.so`` — its own stem and directory, so it can
never shadow, or be pruned by, another package's build of a similar
source — and loaded with ctypes' default ``RTLD_LOCAL``.  Nothing is
compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "tokenizer.cc"
_BUILD_DIR = _SRC.parent / "_build"
_STEM = "libmri_torch_scan"
# -march=native would SIGILL if a built .so moved across machines; the
# scan picks its AVX2/BMI2 path at run time (__builtin_cpu_supports)
_CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_lib_error: str | None = None
_load_lock = threading.Lock()


class _TokenizeResult(ctypes.Structure):
    _fields_ = [
        ("num_tokens", ctypes.c_int64),
        ("raw_tokens", ctypes.c_int64),
        ("vocab_size", ctypes.c_int32),
        ("vocab_width", ctypes.c_int32),
        ("term_ids", ctypes.POINTER(ctypes.c_int32)),
        ("doc_ids", ctypes.POINTER(ctypes.c_int32)),
        ("vocab_packed", ctypes.POINTER(ctypes.c_uint8)),
        ("letter_of_term", ctypes.POINTER(ctypes.c_int32)),
    ]


class _StreamChunkResult(ctypes.Structure):
    _fields_ = [
        ("num_pairs", ctypes.c_int64),
        ("raw_tokens", ctypes.c_int64),
        ("keys", ctypes.POINTER(ctypes.c_int32)),
    ]


class _StreamChunkU16Result(ctypes.Structure):
    _fields_ = [
        ("num_pairs", ctypes.c_int64),
        ("raw_tokens", ctypes.c_int64),
        ("padded", ctypes.c_int64),
        ("feed_u16", ctypes.POINTER(ctypes.c_uint16)),
        ("keys", ctypes.POINTER(ctypes.c_int32)),
    ]


class _StreamFinalResult(ctypes.Structure):
    _fields_ = [
        ("vocab_size", ctypes.c_int32),
        ("vocab_width", ctypes.c_int32),
        ("raw_tokens", ctypes.c_int64),
        ("num_pairs", ctypes.c_int64),
        ("vocab_packed", ctypes.POINTER(ctypes.c_uint8)),
        ("letter_of_term", ctypes.POINTER(ctypes.c_int32)),
        ("remap", ctypes.POINTER(ctypes.c_int32)),
        ("df", ctypes.POINTER(ctypes.c_int32)),
        ("emit_order", ctypes.POINTER(ctypes.c_int32)),
    ]


def _prune_stale(keep: str) -> None:
    """Drop this library's builds of other source hashes — every source
    edit otherwise leaves a dead artifact.  Temp files are left alone:
    one may be a concurrent build's, about to be renamed.
    Best-effort: a process may still hold an old .so open."""
    for p in _BUILD_DIR.glob(f"{_STEM}_*.so"):
        if p.name != keep:
            try:
                p.unlink()
            except OSError:
                pass


def _compile() -> Path:
    tag = hashlib.md5(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:12]
    name = f"{_STEM}_{tag}.so"
    so = _BUILD_DIR / name
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a temp name per process, then an atomic rename: concurrent builds
    # (pytest-xdist workers) never load a half-written library
    tmp = _BUILD_DIR / f"{name}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"native build failed: {e.stderr.decode(errors='replace')}") from e
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build failed: {e}") from e
    os.replace(tmp, so)
    _prune_stale(name)
    return so


def _bind(lib) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    docs = [u8p, i64, i64p, i32p, i32]  # _marshal_docs' five arguments
    sigs = {
        "mri_tokenize": (ctypes.POINTER(_TokenizeResult), [*docs, i32, i32]),
        "mri_free_result": (None, [ctypes.POINTER(_TokenizeResult)]),
        "mri_stream_new_mt": (ctypes.c_void_p, [i64, i32]),
        "mri_stream_free": (None, [ctypes.c_void_p]),
        "mri_stream_feed": (ctypes.POINTER(_StreamChunkResult), [ctypes.c_void_p, *docs]),
        "mri_stream_chunk_free": (None, [ctypes.POINTER(_StreamChunkResult)]),
        "mri_stream_feed_u16": (ctypes.POINTER(_StreamChunkU16Result),
                                [ctypes.c_void_p, *docs, i64]),
        "mri_stream_chunk_u16_free": (None, [ctypes.POINTER(_StreamChunkU16Result)]),
        "mri_stream_finalize": (ctypes.POINTER(_StreamFinalResult), [ctypes.c_void_p]),
        "mri_stream_final_free": (None, [ctypes.POINTER(_StreamFinalResult)]),
        "mri_stream_df_snapshot": (i32, [ctypes.c_void_p, i32p, i32]),
        "mri_token_stats": (i32, [u8p, i64, i64p, i32, i64p, i32p]),
        "mri_emit": (i64, [u8p, i32, i32, i64p, i64p, i64p,
                           ctypes.POINTER(ctypes.c_uint16), i32p, ctypes.c_char_p,
                           i32, i32, i64, i64]),
        "mri_emit_runs": (i64, [u8p, i32, i32, i64p, i32,
                                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
                                ctypes.POINTER(i64p), ctypes.POINTER(i64p),
                                ctypes.c_char_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def load_error() -> str | None:
    """Why :func:`load` returned None, if it did."""
    return _lib_error


def load():
    """The compiled library, or None (the reason cached in
    :func:`load_error` and printed once on stderr)."""
    global _lib, _lib_error
    with _load_lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_compile()))
            _bind(lib)
            _lib = lib
        except (OSError, RuntimeError, AttributeError) as e:
            _lib_error = str(e)
            print(f"warning: native scan unavailable ({e}); using the numpy path",
                  file=sys.stderr)
        return _lib


def available() -> bool:
    return load() is not None


def token_stats(buf: np.ndarray, ends: np.ndarray):
    """Native ``(token_count, max_cleaned_len)`` over one byte window
    (``mri_token_stats``, SIMD masks) — the fast path behind
    ops/device_tokenizer.host_token_stats, the same contract as its
    numpy mirror.  ``None`` when the library is unavailable or refuses
    the arguments (negative or decreasing ends)."""
    lib = load()
    if lib is None:
        return None
    b = np.ascontiguousarray(buf, dtype=np.uint8)
    e = np.ascontiguousarray(ends, dtype=np.int64)
    count = ctypes.c_int64()
    max_len = ctypes.c_int32()
    rc = lib.mri_token_stats(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int64(b.shape[0]),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ctypes.c_int32(e.shape[0]),
        ctypes.byref(count), ctypes.byref(max_len))
    if rc != 0:
        return None
    return int(count.value), int(max_len.value)


def _null(ctype):
    return ctypes.cast(ctypes.c_void_p(), ctypes.POINTER(ctype))


def _marshal_docs(contents: list[bytes], doc_ids: list[int]):
    """ctypes arguments for the document-window C entry points:
    ``(data_ptr, data_len, ends_ptr, ids_ptr, n_docs), keepalive`` —
    NULL pointers for empty input.  Hold ``keepalive`` across the call
    so the backing numpy arrays outlive the native read."""
    buf = b"".join(contents)
    data = np.frombuffer(buf, dtype=np.uint8)
    ends = np.cumsum(np.array([len(c) for c in contents], dtype=np.int64))
    ids = np.asarray(doc_ids, dtype=np.int32)
    n_docs = len(contents)

    def ptr(arr, ctype, nonempty):
        return arr.ctypes.data_as(ctypes.POINTER(ctype)) if nonempty else _null(ctype)

    args = (
        ptr(data, ctypes.c_uint8, data.size),
        ctypes.c_int64(data.size),
        ptr(ends, ctypes.c_int64, n_docs),
        ptr(ids, ctypes.c_int32, n_docs),
        ctypes.c_int32(n_docs),
    )
    return args, (buf, data, ends, ids)


def _array(ptr, n: int) -> np.ndarray:
    """A numpy copy of the first ``n`` elements behind a ctypes pointer."""
    return np.ctypeslib.as_array(ptr, shape=(max(n, 1),))[:n].copy()


def _vocab(ptr, v: int, w: int) -> np.ndarray:
    """The packed NUL-padded vocab rows as a sorted 'S' array."""
    return _array(ptr, v * w).view(f"S{w}") if v else np.empty(0, "S1")


def default_threads() -> int:
    """Auto map-phase thread count: the cores we have, capped — the scan
    saturates memory bandwidth long before high core counts pay off."""
    return max(1, min(os.cpu_count() or 1, 8))


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError(f"native scan unavailable: {_lib_error}")
    return lib


def tokenize_native(contents: list[bytes], doc_ids: list[int],
                    dedup_pairs: bool = False, num_threads: int = 1):
    """Native equivalent of ``text.tokenizer.tokenize_documents``.

    ``dedup_pairs`` applies the map-side combiner: each (term, doc) pair
    is emitted once (output-invariant).  ``num_threads`` scans
    contiguous byte-balanced doc ranges in parallel (the reference's
    mapper threads, main.c:348-365); the arrays are identical for every
    thread count.
    """
    from ..text.tokenizer import TokenizedCorpus

    lib = _require()
    args, keepalive = _marshal_docs(contents, doc_ids)
    res = lib.mri_tokenize(*args, ctypes.c_int32(1 if dedup_pairs else 0),
                           ctypes.c_int32(max(1, num_threads)))
    del keepalive
    if not res:
        raise MemoryError("native tokenizer allocation failure")
    try:
        r = res.contents
        n, v, w = int(r.num_tokens), int(r.vocab_size), int(r.vocab_width)
        return TokenizedCorpus(
            term_ids=_array(r.term_ids, n), doc_ids=_array(r.doc_ids, n),
            vocab=_vocab(r.vocab_packed, v, w), letter_of_term=_array(r.letter_of_term, v),
            pairs_deduped=bool(dedup_pairs), raw_tokens=int(r.raw_tokens))
    finally:
        lib.mri_free_result(res)


class KeyOverflow(Exception):
    """A packed provisional key would exceed int32 — the caller must fall
    back to the one-shot engine."""


class NativeKeyStream:
    """Incremental native scan emitting combiner-deduped provisional keys.

    Feeds the pipelined plan (models/inverted_index.py): each
    :meth:`feed_u16` scans one window of whole documents and returns its
    upload buffer, ready to copy to the card while the next window is
    scanned — provisional ids are first-occurrence ids, stable once
    assigned, so the device sort (ops/engine.sort_prov_chunks) never
    needs the final vocab.  :meth:`finalize` resolves the sorted vocab,
    the prov->rank remap, letters, the per-term document frequencies and
    the emit order.
    """

    def __init__(self, stride: int, num_threads: int = 1):
        self._lib = _require()
        self._handle = ctypes.c_void_p(self._lib.mri_stream_new_mt(
            ctypes.c_int64(stride), ctypes.c_int32(max(1, num_threads))))
        if not self._handle:
            raise MemoryError("native stream allocation failure")

    def feed(self, contents: list[bytes], doc_ids: list[int]):
        """Scan one whole-document window; returns ``(keys, raw_tokens)``
        — packed ``prov_id * stride + doc_id`` int32 keys (a copy).
        Raises :class:`KeyOverflow` when a key no longer fits int32."""
        args, keepalive = _marshal_docs(contents, doc_ids)
        res = self._lib.mri_stream_feed(self._handle, *args)
        del keepalive
        if not res:
            raise MemoryError("native stream feed allocation failure")
        try:
            r = res.contents
            n, raw = int(r.num_pairs), int(r.raw_tokens)
            if n < 0:
                raise KeyOverflow()
            return _array(r.keys, n), raw
        finally:
            self._lib.mri_stream_chunk_free(res)

    def feed_u16(self, contents: list[bytes], doc_ids: list[int], granule: int = 1 << 14):
        """Scan one window, returning the device-ready feed.

        ``("u16", buf, num_pairs, raw_tokens)`` where ``buf`` is the
        ``[terms | docs]`` uint16 upload buffer (each half padded to
        ``granule``, 0xFFFF padding) — or ``("keys", keys, num_pairs,
        raw_tokens)`` once provisional ids outgrow uint16.  Raises
        :class:`KeyOverflow` when even packed int32 keys overflow.
        """
        args, keepalive = _marshal_docs(contents, doc_ids)
        res = self._lib.mri_stream_feed_u16(self._handle, *args, ctypes.c_int64(granule))
        del keepalive
        if not res:
            raise MemoryError("native stream feed allocation failure")
        try:
            r = res.contents
            n, raw = int(r.num_pairs), int(r.raw_tokens)
            if n < 0:
                raise KeyOverflow()
            if r.feed_u16:
                return "u16", _array(r.feed_u16, 2 * int(r.padded)), n, raw
            if n == 0:
                return "u16", np.empty(0, np.uint16), 0, raw
            return "keys", _array(r.keys, n), n, raw
        finally:
            self._lib.mri_stream_chunk_u16_free(res)

    def df_snapshot(self, hint: int = 1 << 16) -> np.ndarray:
        """Current per-term deduped (term, doc) counts in global prov-id
        space (int32, one slot per provisional id seen so far) — a
        vocab-scale copy, in MT mode a vocab-scale fold per worker.  The
        overlap plan diffs consecutive snapshots for per-window per-term
        pair counts instead of token-scale bincounts."""
        buf = np.empty(max(hint, 1), np.int32)
        n = self._lib.mri_stream_df_snapshot(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(buf.shape[0]))
        if n < 0:  # the buffer was too small: -n slots are needed
            buf = np.empty(-n, np.int32)
            n = self._lib.mri_stream_df_snapshot(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int32(buf.shape[0]))
        return buf[:n].copy()

    def finalize(self):
        """``(vocab, letter_of_term, remap, df_prov, raw_tokens,
        num_pairs, emit_order)``.

        ``vocab`` is the sorted 'S' array; ``letter_of_term`` is in rank
        space; ``remap`` maps prov id -> rank; ``df_prov`` holds the
        combiner's per-term document frequencies in prov space;
        ``emit_order`` lists ranks in the reducer's emit order (letter,
        -df, word — main.c:55-64), computed in C++.
        """
        res = self._lib.mri_stream_finalize(self._handle)
        if not res:
            raise MemoryError("native stream finalize allocation failure")
        try:
            r = res.contents
            v = int(r.vocab_size)
            return (_vocab(r.vocab_packed, v, int(r.vocab_width)),
                    _array(r.letter_of_term, v), _array(r.remap, v), _array(r.df, v),
                    int(r.raw_tokens), int(r.num_pairs),
                    _array(r.emit_order, v).astype(np.int64))
        finally:
            self._lib.mri_stream_final_free(res)

    def close(self):
        if self._handle:
            self._lib.mri_stream_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def emit_native(out_dir, vocab: np.ndarray, order, df, offsets, postings) -> int:
    """Native letter-file emit; byte-identical to the Python writer in
    ``text.formatter.emit_index``.  ``vocab`` is the sorted 'S' array;
    postings may be uint16 or int32.  Returns total bytes written."""
    lib = _require()
    os.makedirs(out_dir, exist_ok=True)
    vocab_size = int(vocab.shape[0])
    width = vocab.dtype.itemsize if vocab_size else 1
    vbuf = np.ascontiguousarray(vocab).view(np.uint8)
    order64 = np.ascontiguousarray(order, dtype=np.int64)
    df64 = np.ascontiguousarray(df, dtype=np.int64)
    off64 = np.ascontiguousarray(offsets, dtype=np.int64)
    postings = np.ascontiguousarray(postings)
    if postings.dtype == np.uint16:
        p16 = postings.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
        p32 = _null(ctypes.c_int32)
    else:
        postings = postings.astype(np.int32, copy=False)
        p16 = _null(ctypes.c_uint16)
        p32 = postings.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def ptr(arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype)) if vocab_size else _null(ctype)

    rc = lib.mri_emit(
        ptr(vbuf, ctypes.c_uint8), ctypes.c_int32(vocab_size), ctypes.c_int32(width),
        ptr(order64, ctypes.c_int64), ptr(df64, ctypes.c_int64), ptr(off64, ctypes.c_int64),
        p16, p32, str(out_dir).encode(),
        ctypes.c_int32(0), ctypes.c_int32(26), ctypes.c_int64(0), ctypes.c_int64(vocab_size))
    if rc < 0:
        raise OSError(f"native emit failed writing to {str(out_dir)!r}")
    return int(rc)


def emit_native_runs(out_dir, vocab: np.ndarray, order, runs) -> int:
    """Multi-run native emit: each term's postings list is the
    concatenation of its per-run segments in run order.

    ``runs`` is a sequence of ``(postings_u16, offsets, counts)`` —
    postings a uint16 array, offsets and counts rank-space int64 arrays.
    The overlap plan's device windows and host tail are contiguous
    ascending doc ranges, so concatenation in run order is the merge.
    Byte-identical to one :func:`emit_native` call over the merged
    postings.  Returns total bytes written."""
    lib = _require()
    os.makedirs(out_dir, exist_ok=True)
    vocab_size = int(vocab.shape[0])
    width = vocab.dtype.itemsize if vocab_size else 1
    vbuf = np.ascontiguousarray(vocab).view(np.uint8)
    order64 = np.ascontiguousarray(order, dtype=np.int64)
    n = len(runs)
    keep = []  # the contiguous arrays must outlive the call
    bases = (ctypes.POINTER(ctypes.c_uint16) * max(n, 1))()
    offs = (ctypes.POINTER(ctypes.c_int64) * max(n, 1))()
    cnts = (ctypes.POINTER(ctypes.c_int64) * max(n, 1))()
    for i, (postings, offsets, counts) in enumerate(runs):
        p = np.ascontiguousarray(postings, dtype=np.uint16)
        o = np.ascontiguousarray(offsets, dtype=np.int64)
        c = np.ascontiguousarray(counts, dtype=np.int64)
        keep.extend((p, o, c))
        bases[i] = p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
        offs[i] = o.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        cnts[i] = c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def ptr(arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype)) if vocab_size else _null(ctype)

    rc = lib.mri_emit_runs(
        ptr(vbuf, ctypes.c_uint8), ctypes.c_int32(vocab_size), ctypes.c_int32(width),
        ptr(order64, ctypes.c_int64), ctypes.c_int32(n), bases, offs, cnts,
        str(out_dir).encode())
    del keep
    if rc < 0:
        raise OSError(f"native emit failed writing to {str(out_dir)!r}")
    return int(rc)
