"""ctypes loader for the native host scan (``native/tokenizer.cc``).

The host hot path — tokenize + vocab build + per-(term, doc) combiner,
the analogue of main.c:102-117 plus the reducer's dictionary and dedup —
the letter-file emit, the host backend's index and merge
(:func:`host_index_native`, :class:`HostIndexStream`,
:class:`HostIndexMerge`) and the host query engine's serve kernels
(:class:`NativeServe`) are a C++ library compiled with ``g++`` on first
use and loaded with ctypes.  Without a compiler the callers fall back
to the numpy tokenizer, the Python emit and the numpy query paths (same
bytes, slower).

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
# scan picks its AVX2/BMI2 path at run time (__builtin_cpu_supports).
# -ffp-contract=off: the serve kernels' BM25 scores must be bit-equal to
# numpy's, which no fused multiply-add may change (GCC contracts by
# default where the target has FMA, as on aarch64 hosts)
_CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

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


class _HostIndexStats(ctypes.Structure):
    _fields_ = [
        ("raw_tokens", ctypes.c_int64),
        ("num_pairs", ctypes.c_int64),
        ("vocab_size", ctypes.c_int32),
        ("bytes_written", ctypes.c_int64),
    ]


class _HostStreamStats(ctypes.Structure):
    _fields_ = [
        ("raw_tokens", ctypes.c_int64),
        ("num_pairs", ctypes.c_int64),
        ("vocab_size", ctypes.c_int32),
        ("reserved", ctypes.c_int32),
        ("bytes_written", ctypes.c_int64),
        ("scan_ns", ctypes.c_int64),
        ("finalize_ns", ctypes.c_int64),
        ("emit_ns", ctypes.c_int64),
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
    u32p, f64 = ctypes.POINTER(ctypes.c_uint32), ctypes.c_double
    f64p = ctypes.POINTER(ctypes.c_double)
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
        # -- the host backend: one-shot index, incremental streams, merge --
        "mri_host_index": (i32, [*docs, ctypes.c_char_p,
                                 ctypes.POINTER(_HostIndexStats), i32]),
        "mri_hidx_new": (ctypes.c_void_p, []),
        "mri_hidx_free": (None, [ctypes.c_void_p]),
        "mri_hidx_feed": (i32, [ctypes.c_void_p, *docs]),
        "mri_hidx_finalize_emit": (i32, [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.POINTER(_HostStreamStats)]),
        "mri_hidx_partial": (i32, [ctypes.c_void_p, i64p, i64p]),
        "mri_hidx_info": (i32, [ctypes.c_void_p, i32p, i64p, i64p]),
        "mri_hidx_runpack_info": (i32, [ctypes.c_void_p, i32p, i32p,
                                        i64p, i64p, i64p, i64p]),
        "mri_hidx_runpack": (i32, [ctypes.c_void_p, i32, u8p, i32p, i64p, i64p,
                                   i32p, i32p, i64p, i64p, i32p, i64p]),
        "mri_hidxm_audit": (i32, [ctypes.c_void_p, i32p]),
        "mri_hidxm_new": (ctypes.c_void_p, [ctypes.POINTER(ctypes.c_void_p), i32,
                                            ctypes.POINTER(_HostStreamStats)]),
        "mri_hidxm_free": (None, [ctypes.c_void_p]),
        "mri_hidxm_emit_range": (i64, [ctypes.c_void_p, i32, i32, ctypes.c_char_p]),
        "mri_hidxm_export_info": (i32, [ctypes.c_void_p, i32p, i32p, i32p,
                                        i64p, i64p]),
        "mri_hidxm_export_payload": (i32, [ctypes.c_void_p, u8p] + [i64] * 7),
        "mri_hidxm_export_v2_prepare": (i32, [ctypes.c_void_p, i32, i32,
                                              i64p, i64p, i64p]),
        "mri_hidxm_export_v2_payload": (i32, [ctypes.c_void_p, u8p, i64p, i32]),
        "mri_hidxm_export": (i32, [ctypes.c_void_p, u8p, i32p, i64p, i64p,
                                   i32p, i64p, i64p]),
        # -- serve kernels --
        "mri_serve_new": (ctypes.c_void_p, [
            i32p,                              # blk_max
            i32p,                              # blk_first
            u8p,                               # blk_width
            u8p,                               # blk_tf_width
            u8p,                               # blk_max_tf (raw bytes | NULL)
            u8p,                               # blk_min_dl (raw bytes | NULL)
            u32p,                              # post_words
            u32p,                              # tf_words
            f64p,                              # doc_lens
            i64p,                              # term_block_off
            i32p,                              # blk_cnt
            i64p,                              # blk_woff
            i64p,                              # blk_tf_woff
            i32, i64, i32, i32, i64,           # vocab, blocks, B, bits, ndocs
            f64, f64, f64, i32]),              # avgdl, k1, b, cache cap
        "mri_serve_free": (None, [ctypes.c_void_p]),
        "mri_serve_decode_blocks": (i32, [ctypes.c_void_p, i64p, i64, i32p, i32p, i32p]),
        "mri_serve_decode_postings": (i64, [ctypes.c_void_p, i32, i32p, i32p]),
        "mri_serve_and": (i64, [ctypes.c_void_p, i32p, i64, i32, i32p, i64p]),
        "mri_serve_topk_bm25": (i64, [ctypes.c_void_p, i32p, i32, f64p, i32, i32,
                                      i32p, f64p, i64p]),
        "mri_serve_set_topk_out": (i64, [ctypes.c_void_p, i32p, f64p, i64p]),
        "mri_serve_topk_prep": (i64, [ctypes.c_void_p, i32p, i32, f64p]),
        "mri_serve_topk_prep_clear": (i64, [ctypes.c_void_p]),
        "mri_serve_topk_prep_free": (i64, [ctypes.c_void_p, i64]),
        "mri_serve_topk_run": (i64, [ctypes.c_void_p, i64, i32, i32]),
        # raw addresses: the coalesced path passes array.array / ndarray
        # buffer addresses as plain ints, with no per-call pointer casts
        "mri_serve_topk_batch": (i64, [ctypes.c_void_p] * 3 + [i32, i32]
                                 + [ctypes.c_void_p] * 4),
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


def host_index_native(contents: list[bytes], doc_ids: list[int],
                      out_dir, num_threads: int = 1) -> dict:
    """Whole pipeline in one native call: tokenize + postings + emit.

    The ``backend="cpu"`` engine (models/inverted_index.py): the
    reference's all-on-host regime without its pathologies — no spill
    files, no stdio locks, no token-scale sorts (docs arrive ascending
    per term by construction).  ``num_threads`` forks the map scan over
    contiguous byte-balanced doc ranges.  Returns the stats dict.
    """
    lib = load()
    if lib is None:
        raise RuntimeError(f"native host index unavailable: {_lib_error}")
    os.makedirs(out_dir, exist_ok=True)
    stats = _HostIndexStats()
    args, keepalive = _marshal_docs(contents, doc_ids)
    rc = lib.mri_host_index(*args, str(out_dir).encode(), ctypes.byref(stats),
                            ctypes.c_int32(max(1, num_threads)))
    del keepalive
    if rc == -2:
        raise MemoryError("native host index allocation failure")
    if rc != 0:
        raise OSError(f"native host index failed writing to {out_dir!r}")
    return {
        "documents": len(contents),
        "tokens": int(stats.raw_tokens),
        "unique_terms": int(stats.vocab_size),
        "unique_pairs": int(stats.num_pairs),
        "lines_written": int(stats.vocab_size),
        "bytes_written": int(stats.bytes_written),
    }


class HostIndexStream:
    """Incremental ``backend="cpu"`` pipeline: feed windows, emit once.

    The zero-copy counterpart of :func:`host_index_native` — each
    :meth:`feed_arrays` call hands the scan a window straight out of a
    reusable io.arena buffer (no ``b"".join``, no marshalling copies),
    and ctypes releases the GIL for the call's duration, so a Python
    reader thread can fill the next arena while C++ scans this one.
    :meth:`finalize_emit` flattens postings, sorts, and writes the 26
    letter files, returning a stats dict that includes the native-side
    ``scan_ms`` / ``finalize_ms`` / ``emit_ms`` stage split.
    """

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native host index unavailable: {_lib_error}")
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.mri_hidx_new())
        if not self._handle:
            raise MemoryError("native host index allocation failure")
        self._documents = 0

    def feed_arrays(self, buf: np.ndarray, ends: np.ndarray,
                    ids: np.ndarray, num_docs: int | None = None,
                    used_bytes: int | None = None) -> None:
        """Scan one window of whole documents, zero-copy.

        ``buf`` is the concatenated uint8 document bytes, ``ends`` the
        int64 cumulative end offsets, ``ids`` the int32 doc ids.  Pass
        ``num_docs`` / ``used_bytes`` to scan a prefix of oversized
        arena arrays without slicing (slices of C-contiguous prefixes
        are fine too — the pointers are taken as-is).
        """
        n = int(num_docs if num_docs is not None else ends.shape[0])
        if n == 0:
            return
        nbytes = int(used_bytes if used_bytes is not None else buf.shape[0])
        if buf.dtype != np.uint8 or ends.dtype != np.int64 \
                or ids.dtype != np.int32:
            raise TypeError("feed_arrays requires uint8/int64/int32 arrays")
        rc = self._lib.mri_hidx_feed(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(nbytes),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(n))
        if rc != 0:
            raise MemoryError("native host index feed allocation failure")
        self._documents += n

    def feed(self, contents: list[bytes], doc_ids: list[int]) -> None:
        """Convenience wrapper for list-of-bytes callers (tests)."""
        args, keepalive = _marshal_docs(contents, doc_ids)
        rc = self._lib.mri_hidx_feed(self._handle, *args)
        del keepalive
        if rc != 0:
            raise MemoryError("native host index feed allocation failure")
        self._documents += len(contents)

    def finalize_emit(self, out_dir) -> dict:
        """Flatten + sort + write the 26 letter files; the stats dict."""
        os.makedirs(out_dir, exist_ok=True)
        stats = _HostStreamStats()
        rc = self._lib.mri_hidx_finalize_emit(
            self._handle, str(out_dir).encode(), ctypes.byref(stats))
        if rc == -2:
            raise MemoryError("native host index allocation failure")
        if rc != 0:
            raise OSError(f"native host index failed writing to {out_dir!r}")
        return {
            "documents": self._documents,
            "tokens": int(stats.raw_tokens),
            "unique_terms": int(stats.vocab_size),
            "unique_pairs": int(stats.num_pairs),
            "lines_written": int(stats.vocab_size),
            "bytes_written": int(stats.bytes_written),
            "scan_ms": stats.scan_ns / 1e6,
            "finalize_ms": stats.finalize_ns / 1e6,
            "emit_ms": stats.emit_ns / 1e6,
        }

    def partial(self) -> dict:
        """Flatten this worker's scan into per-term doc runs (the paper's
        per-worker ``partial_a..z`` spill, kept in memory).

        Runs in the calling worker thread with the GIL released, so K
        workers' partial passes overlap.  Each term's run is sorted
        ascending even when the steal queue delivered windows out of
        order.  After this call the handle can only be merged via
        :class:`HostIndexMerge` — ``finalize_emit`` is no longer valid
        (the scan buffers are released).  Idempotent.
        """
        scan_ns = ctypes.c_int64(0)
        partial_ns = ctypes.c_int64(0)
        rc = self._lib.mri_hidx_partial(
            self._handle, ctypes.byref(scan_ns), ctypes.byref(partial_ns))
        if rc != 0:
            raise MemoryError("native host index partial allocation failure")
        return {
            "scan_ms": scan_ns.value / 1e6,
            "partial_ms": partial_ns.value / 1e6,
        }

    def info(self) -> dict:
        """Scan-state probe for the audit layer: this worker's local
        vocab size, deduped pair count, and raw token count (read-only,
        vocab-free — O(1))."""
        vocab = ctypes.c_int32(0)
        pairs = ctypes.c_int64(0)
        raw = ctypes.c_int64(0)
        self._lib.mri_hidx_info(
            self._handle, ctypes.byref(vocab), ctypes.byref(pairs),
            ctypes.byref(raw))
        return {"vocab": int(vocab.value), "pairs": int(pairs.value),
                "raw_tokens": int(raw.value)}

    def runpack(self, shards: int) -> dict:
        """Flatten + export this worker's scan state as term-hash-sharded
        run arrays (the out-of-core spill tier's unit of work).

        Terms come back in (shard asc, lex asc) order with NUL-padded
        fixed-width rows; each term's postings run is doc-ascending with
        a parallel tf column; ``shard_term_off`` / ``shard_pair_off``
        (``shards + 1`` entries each) delimit every shard's slice.  The
        ``doc_ids`` / ``doc_tokens`` columns carry per-document cleaned
        token counts (doc-id ascending) for the artifact's doc-length
        table.  After this call the handle is spent — close it and feed
        a fresh stream.
        """
        if shards < 1:
            raise ValueError("shards must be >= 1")
        vocab = ctypes.c_int32(0)
        width = ctypes.c_int32(0)
        pairs = ctypes.c_int64(0)
        ndocs = ctypes.c_int64(0)
        max_doc = ctypes.c_int64(0)
        raw = ctypes.c_int64(0)
        rc = self._lib.mri_hidx_runpack_info(
            self._handle, ctypes.byref(vocab), ctypes.byref(width),
            ctypes.byref(pairs), ctypes.byref(ndocs), ctypes.byref(max_doc),
            ctypes.byref(raw))
        if rc != 0:
            raise MemoryError("native host index runpack allocation failure")
        v, w = int(vocab.value), max(int(width.value), 1)
        p, d = int(pairs.value), int(ndocs.value)
        vocab_packed = np.zeros((max(v, 1), w), dtype=np.uint8)
        word_lens = np.zeros(max(v, 1), dtype=np.int32)
        df = np.zeros(max(v, 1), dtype=np.int64)
        offsets = np.zeros(v + 1, dtype=np.int64)
        postings = np.zeros(max(p, 1), dtype=np.int32)
        tf = np.zeros(max(p, 1), dtype=np.int32)
        shard_term_off = np.zeros(shards + 1, dtype=np.int64)
        shard_pair_off = np.zeros(shards + 1, dtype=np.int64)
        doc_ids = np.zeros(max(d, 1), dtype=np.int32)
        doc_tokens = np.zeros(max(d, 1), dtype=np.int64)
        rc = self._lib.mri_hidx_runpack(
            self._handle, ctypes.c_int32(shards),
            vocab_packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            word_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            df.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            postings.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            shard_term_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            shard_pair_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            doc_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise MemoryError("native host index runpack allocation failure")
        return {
            "vocab": v, "width": w, "pairs": p,
            "max_doc_id": int(max_doc.value),
            "raw_tokens": int(raw.value),
            "vocab_packed": vocab_packed[:v],
            "word_lens": word_lens[:v], "df": df[:v],
            "offsets": offsets,
            "postings": postings[:p], "tf": tf[:p],
            "shard_term_off": shard_term_off,
            "shard_pair_off": shard_pair_off,
            "doc_ids": doc_ids[:d], "doc_tokens": doc_tokens[:d],
        }

    def close(self):
        if self._handle:
            self._lib.mri_hidx_free(self._handle)
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


class HostIndexMerge:
    """Letter-partitioned parallel reduce over K scanned streams.

    Joins the workers' vocabularies into one global vocabulary + emit
    order (the fork-join barrier), then :meth:`emit_range` renders any
    contiguous first-letter range — it is read-only on the merge state
    and releases the GIL, so M reducer threads (``num_reducers``) call
    it concurrently.  The union of ``plan_letter_ranges`` calls is
    byte-identical to a single-stream ``finalize_emit``.

    Keeps references to the source streams: their native runs back the
    merge until :meth:`close`.
    """

    def __init__(self, streams):
        if not streams:
            raise ValueError("HostIndexMerge needs at least one stream")
        lib = load()
        if lib is None:
            raise RuntimeError(f"native host merge unavailable: {_lib_error}")
        self._lib = lib
        self._streams = list(streams)  # keep worker runs alive
        handles = (ctypes.c_void_p * len(self._streams))(
            *[s._handle for s in self._streams])
        stats = _HostStreamStats()
        self._handle = ctypes.c_void_p(
            lib.mri_hidxm_new(handles, len(self._streams),
                              ctypes.byref(stats)))
        if not self._handle:
            raise MemoryError("native host merge allocation failure")
        self._documents = sum(s._documents for s in self._streams)
        self._stats = stats

    def stats(self) -> dict:
        return {
            "documents": self._documents,
            "tokens": int(self._stats.raw_tokens),
            "unique_terms": int(self._stats.vocab_size),
            "unique_pairs": int(self._stats.num_pairs),
            "lines_written": int(self._stats.vocab_size),
            "merge_ms": self._stats.finalize_ns / 1e6,
        }

    def emit_range(self, letter_lo: int, letter_hi: int, out_dir) -> int:
        """Write letter files ``[letter_lo, letter_hi)``; bytes written.

        An empty range (``lo == hi``, from ``plan_letter_ranges`` with
        more reducers than letters) writes nothing and returns 0.
        """
        os.makedirs(out_dir, exist_ok=True)
        n = self._lib.mri_hidxm_emit_range(
            self._handle, ctypes.c_int32(letter_lo),
            ctypes.c_int32(letter_hi), str(out_dir).encode())
        if n == -2:
            raise MemoryError("native host merge emit allocation failure")
        if n < 0:
            raise OSError(
                f"native host merge failed writing letters "
                f"[{letter_lo}, {letter_hi}) to {out_dir!r}")
        return int(n)

    def export_arrays(self) -> dict:
        """Columnar lex-order export of the merged index — the serving
        artifact's source arrays, no letter-file text round-trip.

        Returns ``vocab_packed`` ((V, width) uint8 NUL-padded rows),
        ``word_lens`` (V int32), ``df`` (V int64), ``offsets`` (V+1
        int64 exclusive prefix), ``postings`` (P int32, globally
        ascending per term), ``df_order`` (V int64 — emit-order
        permutation over lex indices), ``letter_off`` (27 int64), plus
        ``vocab``/``width``/``max_doc_id``/``num_pairs`` scalars.
        Read-only on the merge state.
        """
        V, width, P, _, mdi = self.export_info()
        vocab_packed = np.zeros((max(V, 1), width), dtype=np.uint8)
        word_lens = np.zeros(max(V, 1), dtype=np.int32)
        df = np.zeros(max(V, 1), dtype=np.int64)
        offsets = np.zeros(V + 1, dtype=np.int64)
        postings = np.zeros(max(P, 1), dtype=np.int32)
        df_order = np.zeros(max(V, 1), dtype=np.int64)
        letter_off = np.zeros(27, dtype=np.int64)

        def ptr(a, ctype):
            return a.ctypes.data_as(ctypes.POINTER(ctype))

        rc = self._lib.mri_hidxm_export(
            self._handle, ptr(vocab_packed, ctypes.c_uint8),
            ptr(word_lens, ctypes.c_int32), ptr(df, ctypes.c_int64),
            ptr(offsets, ctypes.c_int64), ptr(postings, ctypes.c_int32),
            ptr(df_order, ctypes.c_int64), ptr(letter_off, ctypes.c_int64))
        if rc == -2:
            raise MemoryError("native merge export allocation failure")
        if rc != 0:
            raise RuntimeError(f"native merge export failed (rc={rc})")
        return {
            "vocab_packed": vocab_packed[:V], "word_lens": word_lens[:V],
            "df": df[:V], "offsets": offsets, "postings": postings[:P],
            "df_order": df_order[:V], "letter_off": letter_off,
            "vocab": V, "width": width, "max_doc_id": mdi,
            "num_pairs": P,
        }

    def export_info(self) -> tuple[int, int, int, int, int]:
        """``(vocab, width, num_pairs, blob_bytes, max_doc_id)`` of the
        merged index — the artifact layout's scalars, O(V)."""
        v = ctypes.c_int32(0)
        w = ctypes.c_int32(0)
        mdi = ctypes.c_int32(0)
        pairs = ctypes.c_int64(0)
        blob = ctypes.c_int64(0)
        self._lib.mri_hidxm_export_info(
            self._handle, ctypes.byref(v), ctypes.byref(w),
            ctypes.byref(mdi), ctypes.byref(pairs), ctypes.byref(blob))
        return (int(v.value), int(w.value), int(pairs.value),
                int(blob.value), int(mdi.value))

    def export_payload(self, buf: np.ndarray, offsets: dict) -> None:
        """One-pass fill of an ``index.mri`` file buffer: every payload
        section written at ``offsets[section]`` (absolute byte offsets
        into ``buf``), postings already delta-encoded.  Read-only on the
        merge state; ``buf`` must be C-contiguous uint8."""
        rc = self._lib.mri_hidxm_export_payload(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            *(ctypes.c_int64(offsets[name]) for name in (
                "letter_dir", "term_offsets", "term_blob", "df",
                "post_offsets", "postings", "df_order")))
        if rc == -2:
            raise MemoryError("native artifact export allocation failure")
        if rc != 0:
            raise RuntimeError(f"native artifact export failed (rc={rc})")

    def export_v2_prepare(self, block_size: int,
                          score_bits: int = 0) -> tuple[int, int, int]:
        """Build the format-v2/v2.1 export plan (block skip entries,
        packed postings/tf words, doc lengths, and — when ``score_bits``
        is 8 or 16 — the saturated max-tf / min-doc-length columns) and
        return the section sizes the layout needs: ``(num_blocks,
        post_data_bytes, tf_data_bytes)``.  ``block_size`` must be a
        power of two >= 2."""
        nb = ctypes.c_int64(0)
        pb = ctypes.c_int64(0)
        tb = ctypes.c_int64(0)
        rc = self._lib.mri_hidxm_export_v2_prepare(
            self._handle, ctypes.c_int32(block_size),
            ctypes.c_int32(score_bits),
            ctypes.byref(nb), ctypes.byref(pb), ctypes.byref(tb))
        if rc == -2:
            raise MemoryError("native v2 export allocation failure")
        if rc != 0:
            raise RuntimeError(f"native v2 export prepare failed (rc={rc})")
        return int(nb.value), int(pb.value), int(tb.value)

    def export_v2_payload(self, buf: np.ndarray, offsets: dict) -> None:
        """Fill a format-v2/v2.1 ``index.mri`` file buffer from the
        prepared plan (:meth:`export_v2_prepare` first) and release the
        plan.  ``offsets`` maps every payload section name to its
        absolute byte offset in ``buf``; the v2.1 max-score sections
        ride between ``blk_tf_width`` and ``post_data`` when present."""
        names = ["letter_dir", "term_offsets", "term_blob", "df",
                 "blk_max", "blk_first", "blk_width", "blk_tf_width",
                 "post_data", "tf_data", "doc_lens", "df_order"]
        if "blk_max_tf" in offsets:
            names[8:8] = ["blk_max_tf", "blk_min_dl"]
        offs = np.array([offsets[name] for name in names], dtype=np.int64)
        rc = self._lib.mri_hidxm_export_v2_payload(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int32(len(offs)))
        if rc == -2:
            raise MemoryError("native v2 artifact export allocation failure")
        if rc != 0:
            raise RuntimeError(f"native v2 artifact export failed (rc={rc})")

    def audit(self) -> tuple[int, int]:
        """Walk every global term's worker runs checking the merge
        invariants (df sums, per-run monotonicity) in C++.  Returns
        ``(rc, bad_term)`` — rc 0 ok, 1 df-sum mismatch, 2 non-monotonic
        run; interpretation (and the raised :class:`~..audit.AuditError`)
        lives in audit.py, keeping this layer exception-vocabulary-free.
        """
        bad = ctypes.c_int32(-1)
        rc = self._lib.mri_hidxm_audit(self._handle, ctypes.byref(bad))
        return int(rc), int(bad.value)

    def close(self):
        if self._handle:
            self._lib.mri_hidxm_free(self._handle)
            self._handle = None
        self._streams = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def emit_native(out_dir, vocab: np.ndarray, order, df, offsets, postings,
                letter_range: tuple[int, int] = (0, 26),
                idx_bounds: tuple[int, int] | None = None) -> int:
    """Native letter-file emit; byte-identical to the Python writer in
    ``text.formatter.emit_index``.  ``vocab`` is the sorted 'S' array;
    postings may be uint16 or int32.  ``letter_range`` restricts the
    emit to letters ``[lo, hi)`` with ``idx_bounds`` the matching slice
    of ``order`` (required for a partial range; defaults to the whole
    permutation) — the multi-shard per-owner emit.  Returns total bytes
    written."""
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
        ctypes.c_int32(letter_range[0]), ctypes.c_int32(letter_range[1]),
        ctypes.c_int64(idx_bounds[0] if idx_bounds is not None else 0),
        ctypes.c_int64(idx_bounds[1] if idx_bounds is not None else vocab_size))
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


# -- serve kernels (mri_serve_*) -------------------------------------------

#: planner mode -> mri_serve_topk_bm25's mode code, and back
_SERVE_MODES = {"exhaustive": 0, "bmw": 1, "maxscore": 2}
_SERVE_MODE_NAMES = ("exhaustive", "bmw", "maxscore")


def _serve_ptr(arr, ctype):
    if arr is None:
        return _null(ctype)
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeServe:
    """One ``mri_serve_*`` handle over a v2/v2.1 artifact's columns (the
    JAX package's ``NativeServe``).

    The handle borrows every pointer it is given, so this wrapper keeps
    the buffers alive (the artifact's map views from
    ``serve.artifact.serve_columns`` and the engine's float64 doc-length
    column): close it before the artifact.  Calls are not thread-safe;
    the engine serializes them.
    """

    #: planner mode -> C mode code and back, so the engine can memoize
    #: the code beside a prep id and count a coalesced batch's modes
    MODES = _SERVE_MODES
    MODE_NAMES = _SERVE_MODE_NAMES

    def __init__(self, cols: dict, doc_lens: np.ndarray, avgdl: float,
                 k1: float, b: float, cache_cap: int = 4096):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native serve unavailable: {_lib_error}")
        self._lib = lib
        self._cols = cols  # keeps the map views alive
        self._doc_lens = np.ascontiguousarray(doc_lens, dtype=np.float64)
        self.block_size = int(cols["block_size"])
        self.score_bits = int(cols["score_bits"])
        self._h = lib.mri_serve_new(
            _serve_ptr(cols["blk_max"], ctypes.c_int32),
            _serve_ptr(cols["blk_first"], ctypes.c_int32),
            _serve_ptr(cols["blk_width"], ctypes.c_uint8),
            _serve_ptr(cols["blk_tf_width"], ctypes.c_uint8),
            _serve_ptr(cols["blk_max_tf"], ctypes.c_uint8),
            _serve_ptr(cols["blk_min_dl"], ctypes.c_uint8),
            _serve_ptr(cols["post_words"], ctypes.c_uint32),
            _serve_ptr(cols["tf_words"], ctypes.c_uint32),
            _serve_ptr(self._doc_lens, ctypes.c_double),
            _serve_ptr(cols["term_block_off"], ctypes.c_int64),
            _serve_ptr(cols["blk_cnt"], ctypes.c_int32),
            _serve_ptr(cols["blk_woff"], ctypes.c_int64),
            _serve_ptr(cols["blk_tf_woff"], ctypes.c_int64),
            ctypes.c_int32(int(cols["vocab"])),
            ctypes.c_int64(int(cols["num_blocks"])),
            ctypes.c_int32(self.block_size),
            ctypes.c_int32(self.score_bits),
            ctypes.c_int64(len(self._doc_lens)),
            ctypes.c_double(float(avgdl)), ctypes.c_double(float(k1)),
            ctypes.c_double(float(b)), ctypes.c_int32(int(cache_cap)),
        )
        if not self._h:
            raise RuntimeError("mri_serve_new rejected the artifact columns")
        # ranked-path output buffers, grown on demand and registered on
        # the handle once: the per-query call then passes 4 scalars
        self._f_run = lib.mri_serve_topk_run
        self._f_batch = lib.mri_serve_topk_batch
        self._stats = np.zeros(3, dtype=np.int64)
        self._p_stats = _serve_ptr(self._stats, ctypes.c_int64)
        self._batch_bufs = None
        self._grow_topk(256)

    def _grow_topk(self, cap: int) -> None:
        self._topk_cap = cap
        self._out_d = np.empty(cap, dtype=np.int32)
        self._out_s = np.empty(cap, dtype=np.float64)
        self._p_out_d = _serve_ptr(self._out_d, ctypes.c_int32)
        self._p_out_s = _serve_ptr(self._out_s, ctypes.c_double)
        self._lib.mri_serve_set_topk_out(self._h, self._p_out_d, self._p_out_s,
                                         self._p_stats)

    def close(self) -> None:
        h, self._h = self._h, None
        if h:
            self._lib.mri_serve_free(h)
        self._cols = None
        self._doc_lens = None

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.mri_serve_free(self._h)
                self._h = None
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- ops ---------------------------------------------------------------

    def decode_blocks(self, sel, want_tf: bool = True):
        """``(ids, tf|None, cnt)`` of the selected global blocks: the
        numpy ``Artifact.decode_blocks`` / ``decode_tf_blocks`` matrices,
        padding included (tf past a block's count is 1).  ``None`` on a
        rejected call."""
        sel = np.ascontiguousarray(sel, dtype=np.int64)
        n = len(sel)
        B = self.block_size
        ids = np.empty((max(n, 1), B), dtype=np.int32)
        tfm = np.empty((max(n, 1), B), dtype=np.int32) if want_tf else None
        cnt = np.empty(max(n, 1), dtype=np.int32)
        rc = self._lib.mri_serve_decode_blocks(
            self._h, _serve_ptr(sel, ctypes.c_int64), ctypes.c_int64(n),
            _serve_ptr(ids, ctypes.c_int32), _serve_ptr(tfm, ctypes.c_int32),
            _serve_ptr(cnt, ctypes.c_int32))
        if rc != 0:
            return None
        return ids[:n], (tfm[:n] if want_tf else None), cnt[:n]

    def decode_postings(self, idx: int, df: int, want_tf: bool = True):
        """``(docs, tf|None)`` of one term, or ``None`` on error."""
        docs = np.empty(max(df, 1), dtype=np.int32)
        tf = np.empty(max(df, 1), dtype=np.int32) if want_tf else None
        got = self._lib.mri_serve_decode_postings(
            self._h, ctypes.c_int32(int(idx)), _serve_ptr(docs, ctypes.c_int32),
            _serve_ptr(tf, ctypes.c_int32))
        if got != df:
            return None
        return docs[:df], (tf[:df] if want_tf else None)

    def query_and(self, acc, idx: int):
        """``(survivors, blocks_decoded, blocks_skipped)`` of the
        ascending candidates intersected with term ``idx``, or ``None``
        on error."""
        acc = np.ascontiguousarray(acc, dtype=np.int32)
        out = np.empty(max(len(acc), 1), dtype=np.int32)
        stats = np.zeros(2, dtype=np.int64)
        m = self._lib.mri_serve_and(
            self._h, _serve_ptr(acc, ctypes.c_int32), ctypes.c_int64(len(acc)),
            ctypes.c_int32(int(idx)), _serve_ptr(out, ctypes.c_int32),
            _serve_ptr(stats, ctypes.c_int64))
        if m < 0:
            return None
        return out[:m], int(stats[0]), int(stats[1])

    def top_k_bm25(self, occ, idfs, k: int, mode: str):
        """``(docs, scores, blocks_scored, blocks_skipped, candidates)``
        for the occurrence list, byte-equal to the numpy engine's
        ``top_k_scored``; ``None`` on error."""
        occ_a = np.ascontiguousarray(occ, dtype=np.int32)
        idf_a = np.ascontiguousarray(idfs, dtype=np.float64)
        kk = max(int(k), 0)
        out_d = np.empty(max(kk, 1), dtype=np.int32)
        out_s = np.empty(max(kk, 1), dtype=np.float64)
        stats = np.zeros(3, dtype=np.int64)
        n = self._lib.mri_serve_topk_bm25(
            self._h, _serve_ptr(occ_a, ctypes.c_int32), ctypes.c_int32(len(occ_a)),
            _serve_ptr(idf_a, ctypes.c_double), ctypes.c_int32(kk),
            ctypes.c_int32(_SERVE_MODES[mode]), _serve_ptr(out_d, ctypes.c_int32),
            _serve_ptr(out_s, ctypes.c_double), _serve_ptr(stats, ctypes.c_int64))
        if n < 0:
            return None
        return out_d[:n], out_s[:n], int(stats[0]), int(stats[1]), int(stats[2])

    def prep_query(self, occ, idfs):
        """Freeze one query's (occ, idf) arrays into the handle and
        return the prep id :meth:`top_k_bm25_fast` runs (``None`` on
        rejection): the engine memoizes it per query key."""
        occ_a = np.ascontiguousarray(occ, dtype=np.int32)
        idf_a = np.ascontiguousarray(idfs, dtype=np.float64)
        pid = self._lib.mri_serve_topk_prep(
            self._h, _serve_ptr(occ_a, ctypes.c_int32), len(occ_a),
            _serve_ptr(idf_a, ctypes.c_double))
        return int(pid) if pid > 0 else None

    def clear_preps(self) -> None:
        """Drop every prepared query."""
        if self._h:
            self._lib.mri_serve_topk_prep_clear(self._h)

    def free_prep(self, pid: int) -> None:
        """Drop one prepared query."""
        if self._h:
            self._lib.mri_serve_topk_prep_free(self._h, pid)

    def top_k_bm25_fast(self, pid: int, k: int, mode: str):
        """A ranked query over a :meth:`prep_query` id into the handle's
        registered buffers: ``(pairs, scored, skipped, candidates)`` with
        ``pairs`` the engine's ``[(doc, score), ...]``; ``None`` on
        error."""
        if k > self._topk_cap:
            self._grow_topk(max(k, 2 * self._topk_cap))
        n = self._f_run(self._h, pid, k, _SERVE_MODES[mode])
        if n < 0:
            return None
        stats = self._stats
        return (list(zip(self._out_d[:n].tolist(), self._out_s[:n].tolist())),
                int(stats[0]), int(stats[1]), int(stats[2]))

    def top_k_bm25_batch(self, pids, modes, nq: int, k: int):
        """``nq`` prepared queries in one library call: ``pids`` an
        ``array.array('q')`` of prep ids, ``modes`` an
        ``array.array('i')`` of :attr:`MODES` codes.  Returns
        ``(pairs_list, scored, skipped, candidates)``, the stats summed
        over the batch; ``None`` on any error (the caller re-runs per
        query)."""
        need = nq * k
        bb = self._batch_bufs
        if bb is None or bb[8] < need or bb[9] < nq:
            docs = np.empty(max(need, 256), dtype=np.int32)
            scores = np.empty(max(need, 256), dtype=np.float64)
            nhits = np.empty(max(nq, 64), dtype=np.int32)
            stats = np.zeros(3, dtype=np.int64)
            bb = (docs, scores, nhits, stats, docs.ctypes.data, scores.ctypes.data,
                  nhits.ctypes.data, stats.ctypes.data, len(docs), len(nhits))
            self._batch_bufs = bb
        rc = self._f_batch(self._h, pids.buffer_info()[0], modes.buffer_info()[0],
                           nq, k, bb[4], bb[5], bb[6], bb[7])
        if rc < 0:
            return None
        dl = bb[0][:need].tolist()
        sl = bb[1][:need].tolist()
        nl = bb[2][:nq].tolist()
        pairs_list = [list(zip(dl[lo:lo + n], sl[lo:lo + n]))
                      for lo, n in zip(range(0, need, k), nl)]
        s0, s1, s2 = bb[3].tolist()
        return pairs_list, s0, s1, s2
