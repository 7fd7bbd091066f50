"""``index.mri`` — the compact, memory-mappable serving artifact.

The port's copy of the JAX package's ``serve/artifact.py``: the same
formats, byte for byte, so either package reads what the other writes.
The letter files are the conformance surface; this is the serving
surface, one columnar file the query engine maps and reads with
zero-copy numpy views.

Format v1, little-endian throughout:

    header (96 bytes)
      magic            8s   b"MRIIDX01"
      version          u32  1
      width            u32  fixed term-row width (max term length)
      vocab            i64  V — number of terms
      num_postings     i64  P — total (term, doc) pairs
      max_doc_id       i64
      term_blob_bytes  i64
      payload_bytes    i64  everything after the header
      payload_adler32  u32  over the payload bytes
      reserved         32 zero bytes
      header_adler32   u32  over header bytes [0, 92)

    payload — fixed section order, each section 16-byte aligned:
      letter_dir    i64[27]   lex term-index bounds per first letter
      term_offsets  i64[V+1]  exclusive prefix into term_blob
      term_blob     u8[...]   term bytes, lex order, no separators
      df            i32[V]    document frequency per term
      post_offsets  i64[V+1]  exclusive prefix into postings
      postings      i32[P]    per-term runs, delta-encoded: first doc id
                              absolute, the rest diffs (>= 1)
      df_order      i32[V]    emit-order permutation over lex indices
                              (letter asc, df desc, word asc)

Format v2 (version 2) stores postings as fixed-size blocks of
``block_size`` doc ids; the reserved header bytes gain, at offset 60,
``block_size u32, score_bits u32, num_blocks i64, post_data_bytes i64,
tf_data_bytes i64``, and the payload after ``df`` becomes:

      blk_max       i32[NB]   last doc id per block
      blk_first     i32[NB]   first doc id per block (absolute)
      blk_width     u8[NB]    bit width of the block's packed deltas
      blk_tf_width  u8[NB]    bit width of the block's packed tf
      post_data     u8[...]   per block: (count-1) values of (delta - 1)
                              at blk_width bits, LSB-first little-endian,
                              zero-padded to a 4-byte boundary per block
      tf_data       u8[...]   per block: count values of (tf - 1) at
                              blk_tf_width bits, same packing
      doc_lens      i32[max_doc_id + 1]  tokens per document (BM25)
      df_order      i32[V]    as v1

Format v2.1 (version 3, the default) is v2 plus ``blk_max_tf`` and
``blk_min_dl`` (u8 or u16 per block, ``score_bits``, saturating) between
``blk_tf_width`` and ``post_data``: the per-block BM25 upper-bound inputs
of the ranked planner.  Writes are atomic (tmp + rename); loads verify
both checksums before any answer is served, and a torn artifact raises
:class:`ArtifactError`.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils import envknobs
from ..utils.checksum import file_checksum

#: Written next to a.txt..z.txt by ``--artifact`` runs.
ARTIFACT_NAME = "index.mri"

MAGIC = b"MRIIDX01"
VERSION = 1
VERSION_V2 = 2
VERSION_V21 = 3
HEADER_BYTES = 96
_ALIGN = 16
_HEADER_FMT = "<8sIIqqqqqI"  # ... + 32 reserved + u32 header_adler32
_HEADER_V2_FMT = "<IIqqq"    # v2+: packed into the 32 reserved bytes
_HEADER_V2_OFF = struct.calcsize(_HEADER_FMT)  # 60

FORMAT_ENV = "MRI_SERVE_FORMAT"
BLOCK_ENV = "MRI_SERVE_BLOCK_SIZE"
SCORE_BITS_ENV = "MRI_SERVE_SCORE_BITS"

#: Present in a directory whose live truth is a segment manifest (the
#: JAX package's incremental-indexing layer); its root index.mri may be
#: stale, so the engine refuses it.
SEGMENTS_MANIFEST_NAME = "segments.manifest.json"

_POW2 = np.int64(1) << np.arange(32, dtype=np.int64)


class ArtifactError(RuntimeError):
    """The artifact is missing, torn, or not an artifact at all."""


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _place(sections) -> tuple[dict[str, tuple[int, int]], int]:
    """Section name -> (file offset, byte length), plus the total file
    size, each section 16-byte aligned after the header."""
    out: dict[str, tuple[int, int]] = {}
    cur = HEADER_BYTES
    for name, nbytes in sections:
        cur = _align(cur)
        out[name] = (cur, nbytes)
        cur += nbytes
    return out, _align(cur)


def _layout(vocab: int, num_postings: int, blob_bytes: int):
    """v1 layout, deterministic from the header scalars."""
    return _place([
        ("letter_dir", 27 * 8),
        ("term_offsets", (vocab + 1) * 8),
        ("term_blob", blob_bytes),
        ("df", vocab * 4),
        ("post_offsets", (vocab + 1) * 8),
        ("postings", num_postings * 4),
        ("df_order", vocab * 4),
    ])


def _layout_v2(vocab: int, blob_bytes: int, num_blocks: int,
               post_data_bytes: int, tf_data_bytes: int, max_doc_id: int,
               score_bits: int = 0):
    """v2/v2.1 layout; ``score_bits`` 0 is plain v2, 8/16 inserts the
    v2.1 max-score columns."""
    sections = [
        ("letter_dir", 27 * 8),
        ("term_offsets", (vocab + 1) * 8),
        ("term_blob", blob_bytes),
        ("df", vocab * 4),
        ("blk_max", num_blocks * 4),
        ("blk_first", num_blocks * 4),
        ("blk_width", num_blocks),
        ("blk_tf_width", num_blocks),
        ("post_data", post_data_bytes),
        ("tf_data", tf_data_bytes),
        ("doc_lens", (max_doc_id + 1) * 4),
        ("df_order", vocab * 4),
    ]
    if score_bits:
        sections[8:8] = [
            ("blk_max_tf", num_blocks * (score_bits // 8)),
            ("blk_min_dl", num_blocks * (score_bits // 8)),
        ]
    return _place(sections)


def resolve_format(fmt: int | None = None) -> int:
    """The artifact version to write: the argument, else
    ``$MRI_SERVE_FORMAT`` (default 3)."""
    fmt = int(envknobs.get(FORMAT_ENV) if fmt is None else fmt)
    if fmt not in (VERSION, VERSION_V2, VERSION_V21):
        raise ValueError(f"unsupported artifact format {fmt}")
    return fmt


def resolve_score_bits(bits: int | None = None) -> int:
    """The v2.1 max-score column width: the argument, else
    ``$MRI_SERVE_SCORE_BITS``.  Must be 8 or 16."""
    b = int(envknobs.get(SCORE_BITS_ENV) if bits is None else bits)
    if b not in (8, 16):
        raise ValueError(f"{SCORE_BITS_ENV}={b} is not 8 or 16")
    return b


def resolve_block_size(block_size: int | None = None) -> int:
    """The v2 postings block size: the argument, else
    ``$MRI_SERVE_BLOCK_SIZE``.  Must be a power of two >= 2."""
    b = int(envknobs.get(BLOCK_ENV) if block_size is None else block_size)
    if b < 2 or b > (1 << 20) or b & (b - 1):
        raise ValueError(
            f"{BLOCK_ENV}={b} is not a power of two in [2, 2**20]")
    return b


def artifact_path(index_dir: str | Path) -> Path:
    return Path(index_dir) / ARTIFACT_NAME


def is_segment_managed(path) -> bool:
    """Whether ``path`` is a directory (or the root ``index.mri`` of one)
    managed by a segment manifest rather than by its root artifact."""
    p = Path(path)
    if p.is_dir():
        return (p / SEGMENTS_MANIFEST_NAME).exists()
    return (p.name == ARTIFACT_NAME
            and (p.parent / SEGMENTS_MANIFEST_NAME).exists())


def _letter_dir(term_blob: np.ndarray, term_offsets: np.ndarray, vocab: int) -> np.ndarray:
    first_bytes = term_blob[term_offsets[:-1]] if vocab else term_blob[:0]
    return np.searchsorted(first_bytes, np.arange(ord("a"), ord("a") + 27)).astype(np.int64)


def pack(path, *, term_blob: np.ndarray, term_offsets: np.ndarray,
         df: np.ndarray, post_offsets: np.ndarray, postings: np.ndarray,
         df_order: np.ndarray, max_doc_id: int, width: int | None = None,
         fmt: int | None = None, tf: np.ndarray | None = None,
         doc_lens: np.ndarray | None = None, block_size: int | None = None
         ) -> int:
    """Write the artifact from lex-order arrays; returns bytes written.

    ``postings`` arrives ABSOLUTE (ascending per term); the wire
    encoding (v1 deltas or v2 bitpacked blocks, per ``fmt`` /
    ``$MRI_SERVE_FORMAT``) happens here.  ``tf``/``doc_lens`` only matter
    for v2; absent, every tf is 1 and doc lengths fall back to the
    per-doc posting count.
    """
    fmt = resolve_format(fmt)
    if fmt != VERSION:
        return pack_v2(
            path, term_blob=term_blob, term_offsets=term_offsets, df=df,
            post_offsets=post_offsets, postings=postings, df_order=df_order,
            max_doc_id=max_doc_id, width=width, tf=tf, doc_lens=doc_lens,
            block_size=block_size, fmt=fmt)
    term_offsets = np.ascontiguousarray(term_offsets, dtype=np.int64)
    post_offsets = np.ascontiguousarray(post_offsets, dtype=np.int64)
    term_blob = np.ascontiguousarray(term_blob, dtype=np.uint8)
    df = np.ascontiguousarray(df, dtype=np.int32)
    df_order = np.ascontiguousarray(df_order, dtype=np.int32)
    postings = np.asarray(postings, dtype=np.int32)
    vocab = len(df)
    num_postings = int(post_offsets[-1]) if len(post_offsets) else 0
    blob_bytes = int(term_offsets[-1]) if len(term_offsets) else 0
    if width is None:
        width = int(np.diff(term_offsets).max()) if vocab else 1

    deltas = postings.copy()
    if num_postings:
        deltas[1:] -= postings[:-1]
        starts = post_offsets[:-1][np.diff(post_offsets) > 0]
        deltas[starts] = postings[starts]

    layout, total = _layout(vocab, num_postings, blob_bytes)
    buf = np.zeros(total, dtype=np.uint8)

    def put(name: str, arr: np.ndarray) -> None:
        off, nbytes = layout[name]
        buf[off:off + nbytes] = np.frombuffer(arr.tobytes(), dtype=np.uint8)

    put("letter_dir", _letter_dir(term_blob, term_offsets, vocab))
    put("term_offsets", term_offsets)
    put("term_blob", term_blob)
    put("df", df)
    put("post_offsets", post_offsets)
    put("postings", deltas)
    put("df_order", df_order)
    return _write(path, buf, width=width, vocab=vocab,
                  num_postings=num_postings, max_doc_id=max_doc_id,
                  blob_bytes=blob_bytes)


def _header(*, width: int, vocab: int, num_postings: int, max_doc_id: int,
            blob_bytes: int, payload_len: int, payload_crc: int,
            version: int = VERSION, v2: dict | None = None) -> bytes:
    header = struct.pack(
        _HEADER_FMT, MAGIC, version, int(max(width, 1)), vocab,
        num_postings, int(max_doc_id), blob_bytes, payload_len, payload_crc)
    if v2 is not None:
        header += struct.pack(
            _HEADER_V2_FMT, v2["block_size"], v2.get("score_bits", 0),
            v2["num_blocks"], v2["post_data_bytes"], v2["tf_data_bytes"])
    header = header + b"\0" * (HEADER_BYTES - 4 - len(header))
    return header + struct.pack("<I", zlib.adler32(header))


def _write(path, buf: np.ndarray, *, width: int, vocab: int,
           num_postings: int, max_doc_id: int, blob_bytes: int,
           version: int = VERSION, v2: dict | None = None) -> int:
    """Checksum and header a filled file buffer, write it atomically."""
    path = Path(path)
    payload = buf[HEADER_BYTES:]
    header = _header(width=width, vocab=vocab, num_postings=num_postings,
                     max_doc_id=max_doc_id, blob_bytes=blob_bytes,
                     payload_len=len(payload), payload_crc=zlib.adler32(payload),
                     version=version, v2=v2)
    buf[:HEADER_BYTES] = np.frombuffer(header, dtype=np.uint8)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(memoryview(buf))
    os.replace(tmp, path)
    return len(buf)


def _pack_bits(vals: np.ndarray, w: int) -> np.ndarray:
    """Pack ``vals`` (< 2**w each) at ``w`` bits LSB-first into a
    word-aligned little-endian uint8 array (the C++ BitPacker's wire
    form; width 0 packs to nothing) — one block's stream, the per-block
    form that :func:`_pack_stream` packs for all blocks at once."""
    if w == 0 or not len(vals):
        return np.zeros(0, dtype=np.uint8)
    bits = np.unpackbits(
        np.ascontiguousarray(vals, dtype="<u4").view(np.uint8).reshape(-1, 4),
        axis=1, bitorder="little")[:, :w].ravel()
    pad = (-len(bits)) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(bits, bitorder="little")


def _bit_length(v: np.ndarray) -> np.ndarray:
    """``int.bit_length`` of each value in ``[0, 2**32)``."""
    return np.searchsorted(_POW2, v, side="right").astype(np.int64)


def _pack_stream(vals: np.ndarray, blk: np.ndarray, j: np.ndarray,
                 widths: np.ndarray, nvals: np.ndarray) -> np.ndarray:
    """Bit-pack every block at once: block ``b`` holds ``nvals[b]``
    values at ``widths[b]`` bits, LSB-first, zero-padded to a 32-bit
    boundary; value ``i`` (< 2**widths[blk[i]]) is the ``j[i]``-th of
    block ``blk[i]``.  Returns the little-endian bytes of all blocks in
    order — the JAX package's per-block ``_pack_bits`` concatenated.

    A value spans at most two words; its two parts land in disjoint bit
    fields of their words, so one float64 ``bincount`` per part sums
    them exactly (every word stays below 2**32 < 2**53)."""
    wlen = (nvals * widths + 31) >> 5
    total = int(wlen.sum())
    if not total:
        return np.zeros(0, dtype=np.uint8)
    woff = np.cumsum(wlen) - wlen
    keep = widths[blk] > 0
    vals, blk, j = vals[keep].astype(np.uint64), blk[keep], j[keep]
    bitpos = woff[blk] * 32 + j * widths[blk]
    word = bitpos >> 5
    shifted = vals << (bitpos & 31).astype(np.uint64)
    lo = (shifted & np.uint64(0xFFFFFFFF)).astype(np.float64)
    hi = (shifted >> np.uint64(32)).astype(np.float64)
    words = (np.bincount(word, weights=lo, minlength=total)
             + np.bincount(word + 1, weights=hi, minlength=total + 1)[:total])
    return words.astype("<u4").view(np.uint8)


def pack_v2(path, *, term_blob: np.ndarray, term_offsets: np.ndarray,
            df: np.ndarray, post_offsets: np.ndarray, postings: np.ndarray,
            df_order: np.ndarray, max_doc_id: int, width: int | None = None,
            tf: np.ndarray | None = None,
            doc_lens: np.ndarray | None = None,
            block_size: int | None = None, fmt: int | None = None,
            score_bits: int | None = None) -> int:
    """Write a format-v2/v2.1 artifact from lex-order ABSOLUTE postings.

    ``tf`` aligns with ``postings`` (default all ones); ``doc_lens``
    defaults to each doc's tf sum.  ``fmt`` 3 (the default) adds the
    per-block saturated max-tf / min-doc-length columns.  Every block is
    packed in one vectorized pass; the bytes equal the JAX package's
    block-by-block writer's.
    """
    fmt = resolve_format(fmt)
    if fmt == VERSION:
        raise ValueError("pack_v2 writes formats 2 and 3, not 1")
    bits = resolve_score_bits(score_bits) if fmt == VERSION_V21 else 0
    B = resolve_block_size(block_size)
    term_offsets = np.ascontiguousarray(term_offsets, dtype=np.int64)
    post_offsets = np.ascontiguousarray(post_offsets, dtype=np.int64)
    term_blob = np.ascontiguousarray(term_blob, dtype=np.uint8)
    df = np.ascontiguousarray(df, dtype=np.int32)
    df_order = np.ascontiguousarray(df_order, dtype=np.int32)
    postings = np.asarray(postings, dtype=np.int32)
    vocab = len(df)
    num_postings = int(post_offsets[-1]) if len(post_offsets) else 0
    blob_bytes = int(term_offsets[-1]) if len(term_offsets) else 0
    if width is None:
        width = int(np.diff(term_offsets).max()) if vocab else 1
    if tf is None:
        tf = np.ones(num_postings, dtype=np.int32)
    tf = np.ascontiguousarray(tf, dtype=np.int32)
    if doc_lens is None:
        doc_lens = np.bincount(postings, weights=tf, minlength=max_doc_id + 1).astype(np.int32)
    doc_lens = np.ascontiguousarray(doc_lens, dtype=np.int32)
    if len(doc_lens) != max_doc_id + 1:
        out = np.zeros(max_doc_id + 1, dtype=np.int32)
        out[:len(doc_lens)] = doc_lens[:max_doc_id + 1]
        doc_lens = out

    # block geometry: each term's run cut into B-sized blocks, which
    # tile [0, P) in order
    lens = np.diff(post_offsets)
    bpt = -(-lens // B)
    num_blocks = int(bpt.sum())
    bterm = np.repeat(np.arange(vocab, dtype=np.int64), bpt)
    bidx = np.arange(num_blocks, dtype=np.int64) - np.repeat(np.cumsum(bpt) - bpt, bpt)
    bstart = post_offsets[bterm] + bidx * B
    cnt = np.minimum(bstart + B, post_offsets[bterm + 1]) - bstart
    P = int(cnt.sum())
    docs = postings[:P].astype(np.int64)
    tfs = tf[:P].astype(np.int64)
    pblk = np.repeat(np.arange(num_blocks, dtype=np.int64), cnt)
    pj = np.arange(P, dtype=np.int64) - bstart[pblk]
    dm1 = np.zeros(P, dtype=np.int64)  # delta - 1, 0 at each block's slot 0
    if P:
        dm1[1:] = docs[1:] - docs[:-1] - 1
        dm1[bstart] = 0
    if num_blocks:
        blk_w = _bit_length(np.maximum.reduceat(dm1, bstart))
        max_tf = np.maximum.reduceat(tfs, bstart)
        blk_tw = _bit_length(max_tf - 1)
    else:
        blk_w = blk_tw = max_tf = np.zeros(0, dtype=np.int64)
    tail = pj > 0
    post_data = _pack_stream(dm1[tail], pblk[tail], pj[tail] - 1, blk_w, cnt - 1)
    tf_data = _pack_stream(tfs - 1, pblk, pj, blk_tw, cnt)

    layout, total = _layout_v2(vocab, blob_bytes, num_blocks,
                               len(post_data), len(tf_data), max_doc_id,
                               score_bits=bits)
    buf = np.zeros(total, dtype=np.uint8)

    def put(name: str, arr: np.ndarray) -> None:
        off, nbytes = layout[name]
        buf[off:off + nbytes] = np.frombuffer(arr.tobytes(), dtype=np.uint8)

    put("letter_dir", _letter_dir(term_blob, term_offsets, vocab))
    put("term_offsets", term_offsets)
    put("term_blob", term_blob)
    put("df", df)
    put("blk_max", docs[bstart + cnt - 1].astype(np.int32))
    put("blk_first", docs[bstart].astype(np.int32))
    put("blk_width", blk_w.astype(np.uint8))
    put("blk_tf_width", blk_tw.astype(np.uint8))
    if bits:
        # saturated integer columns, never floats
        cap = (1 << bits) - 1
        sdt = "<u1" if bits == 8 else "<u2"
        min_dl = (np.minimum.reduceat(doc_lens[docs].astype(np.int64), bstart)
                  if num_blocks else np.zeros(0, dtype=np.int64))
        put("blk_max_tf", np.minimum(max_tf, cap).astype(sdt))
        put("blk_min_dl", np.minimum(min_dl, cap).astype(sdt))
    put("post_data", post_data)
    put("tf_data", tf_data)
    put("doc_lens", doc_lens)
    put("df_order", df_order)
    return _write(path, buf, width=width, vocab=vocab,
                  num_postings=num_postings, max_doc_id=max_doc_id,
                  blob_bytes=blob_bytes, version=fmt,
                  v2={"block_size": B, "num_blocks": num_blocks,
                      "score_bits": bits,
                      "post_data_bytes": len(post_data),
                      "tf_data_bytes": len(tf_data)})


class Artifact:
    """Zero-copy numpy views over a verified, mapped ``index.mri``.

    Every format presents the same decode API; v2 also exposes the block
    skip table, the derived block geometry (``term_block_off``,
    ``blk_cnt``, word-offset prefix sums) and the BM25 columns.
    """

    _VIEW_NAMES = ("letter_dir", "term_offsets", "term_blob", "df",
                   "post_offsets", "postings", "df_order",
                   "blk_max", "blk_first", "blk_width", "blk_tf_width",
                   "blk_max_tf", "blk_min_dl",
                   "post_words", "tf_words", "doc_lens")

    def __init__(self, path: Path, mm: mmap.mmap, meta: dict,
                 views: dict[str, np.ndarray]):
        self.path = path
        self._mm = mm
        self.version = meta.get("version", VERSION)
        self.vocab = meta["vocab"]
        self.num_postings = meta["num_postings"]
        self.max_doc_id = meta["max_doc_id"]
        self.width = meta["width"]
        self.nbytes = meta["nbytes"]
        for name in self._VIEW_NAMES:
            setattr(self, name, views.get(name))
        self.block_size = meta.get("block_size", 0)
        self.num_blocks = meta.get("num_blocks", 0)
        self.score_bits = meta.get("score_bits", 0)
        self.term_block_off = meta.get("term_block_off")
        self.blk_cnt = meta.get("blk_cnt")
        self.blk_woff = meta.get("blk_woff")
        self.blk_tf_woff = meta.get("blk_tf_woff")

    @property
    def has_block_scores(self) -> bool:
        """Whether the v2.1 per-block max-score columns are present (the
        planner's precondition for Block-Max WAND / MaxScore)."""
        return self.blk_max_tf is not None

    def term(self, idx: int) -> bytes:
        lo, hi = self.term_offsets[idx], self.term_offsets[idx + 1]
        return self.term_blob[lo:hi].tobytes()

    def _gather_packed(self, sel: np.ndarray, words: np.ndarray,
                       woff: np.ndarray, widths: np.ndarray,
                       nvals: np.ndarray) -> np.ndarray:
        """Decode variable-width packed values for the selected blocks:
        block i holds ``nvals[i]`` values at ``widths[i]`` bits from word
        ``woff[i]``.  Returns an (len(sel), max(nvals)) int64 matrix,
        0 past each block's count."""
        n = len(sel)
        J = int(nvals.max()) if n else 0
        out = np.zeros((n, max(J, 1)), dtype=np.int64)
        if not n or not J:
            return out
        W = int(widths.max())
        wlen = (nvals * widths + 31) >> 5
        total = int(wlen.sum())
        if not W or not total:
            return out
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(wlen[:-1], out=starts[1:])
        word_src = np.repeat(woff - starts, wlen) + np.arange(total)
        bits = np.unpackbits(np.ascontiguousarray(words[word_src]).view(np.uint8),
                             bitorder="little")
        j = np.arange(J)
        k = np.arange(W)
        bitpos = (starts * 32)[:, None] + j[None, :] * widths[:, None]
        idx3 = bitpos[:, :, None] + k[None, None, :]
        np.clip(idx3, 0, bits.size - 1, out=idx3)
        valid = (j[None, :, None] < nvals[:, None, None]) & \
                (k[None, None, :] < widths[:, None, None])
        g = np.where(valid, bits[idx3], 0)
        out[:, :J] = g @ (np.int64(1) << k)
        return out

    def decode_blocks(self, sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """v2: absolute doc ids of the selected (global) blocks, an
        (len(sel), block_size) int32 matrix (garbage past ``cnt[i]``),
        and the per-block counts."""
        sel = np.asarray(sel, dtype=np.int64)
        cnt = self.blk_cnt[sel].astype(np.int64)
        w = self.blk_width[sel].astype(np.int64)
        deltas = self._gather_packed(sel, self.post_words, self.blk_woff[sel], w, cnt - 1)
        B = self.block_size
        out = np.zeros((len(sel), B), dtype=np.int64)
        out[:, 0] = self.blk_first[sel]
        out[:, 1:deltas.shape[1] + 1] = np.where(
            np.arange(deltas.shape[1])[None, :] < (cnt - 1)[:, None], deltas + 1, 0)
        np.cumsum(out, axis=1, out=out)
        return out.astype(np.int32), cnt

    def decode_tf_blocks(self, sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """v2: per-doc term frequencies of the selected blocks, aligned
        row for row with :meth:`decode_blocks`."""
        sel = np.asarray(sel, dtype=np.int64)
        cnt = self.blk_cnt[sel].astype(np.int64)
        tw = self.blk_tf_width[sel].astype(np.int64)
        vals = self._gather_packed(sel, self.tf_words, self.blk_tf_woff[sel], tw, cnt)
        B = self.block_size
        tfm = (vals + 1)[:, :B]
        if tfm.shape[1] < B:
            tfm = np.pad(tfm, ((0, 0), (0, B - tfm.shape[1])))
        return tfm, cnt

    def decode_postings(self, idx: int) -> np.ndarray:
        """One term's absolute ascending doc ids (a fresh array)."""
        if self.version == VERSION:
            lo, hi = self.post_offsets[idx], self.post_offsets[idx + 1]
            return np.cumsum(self.postings[lo:hi], dtype=np.int64).astype(np.int32)
        b0, b1 = self.term_block_off[idx], self.term_block_off[idx + 1]
        if b0 == b1:
            return np.zeros(0, dtype=np.int32)
        ids, cnt = self.decode_blocks(np.arange(b0, b1))
        return ids[np.arange(self.block_size)[None, :] < cnt[:, None]]

    def decode_tf(self, idx: int) -> np.ndarray:
        """One term's per-document term frequencies, aligned with
        :meth:`decode_postings` (v1 carries no tf: all ones)."""
        if self.version == VERSION:
            df = int(self.post_offsets[idx + 1] - self.post_offsets[idx])
            return np.ones(df, dtype=np.int32)
        b0, b1 = self.term_block_off[idx], self.term_block_off[idx + 1]
        if b0 == b1:
            return np.zeros(0, dtype=np.int32)
        tfm, cnt = self.decode_tf_blocks(np.arange(b0, b1))
        return tfm[np.arange(tfm.shape[1])[None, :] < cnt[:, None]].astype(np.int32)

    def close(self) -> None:
        # drop the views before the map: numpy holds buffer references
        for name in self._VIEW_NAMES:
            setattr(self, name, None)
        self.term_block_off = self.blk_cnt = None
        self.blk_woff = self.blk_tf_woff = None
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # a caller still holds a view: the map frees with it
                pass
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_artifact(path: str | Path) -> Artifact:
    """Map and verify an artifact (a directory means its ``index.mri``).

    Every structural and checksum violation raises :class:`ArtifactError`
    with a one-line reason — the contract the CLI maps to exit 2.
    """
    path = Path(path)
    if path.is_dir():
        path = path / ARTIFACT_NAME
    try:
        f = open(path, "rb")
    except OSError as e:
        msg = f"{path}: cannot open artifact ({e})"
        if path.name == ARTIFACT_NAME and not path.exists() \
                and (path.parent / "a.txt").exists():
            msg += ("; directory holds a letter-file index built "
                    "without --artifact — rebuild with --artifact "
                    "to pack index.mri")
        raise ArtifactError(msg) from e
    with f:
        try:
            size = os.fstat(f.fileno()).st_size
            if size < HEADER_BYTES:
                raise ArtifactError(
                    f"{path}: {size} bytes is smaller than the "
                    f"{HEADER_BYTES}-byte header")
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError) as e:
            raise ArtifactError(f"{path}: cannot map artifact ({e})") from e
    try:
        return _parse(path, mm, size)
    except BaseException:
        mm.close()
        raise


def _parse(path: Path, mm: mmap.mmap, size: int) -> Artifact:
    head = bytes(mm[:HEADER_BYTES])
    (want_crc,) = struct.unpack_from("<I", head, HEADER_BYTES - 4)
    if zlib.adler32(head[:HEADER_BYTES - 4]) != want_crc:
        raise ArtifactError(f"{path}: header checksum mismatch")
    (magic, version, width, vocab, num_postings, max_doc_id,
     blob_bytes, payload_bytes, payload_crc) = struct.unpack_from(_HEADER_FMT, head)
    if magic != MAGIC:
        raise ArtifactError(f"{path}: bad magic {magic!r} (not an index.mri)")
    if version not in (VERSION, VERSION_V2, VERSION_V21):
        raise ArtifactError(
            f"{path}: unsupported artifact version {version} "
            f"(this reader knows versions {VERSION}-{VERSION_V21})")
    v2 = None
    score_bits = 0
    if version >= VERSION_V2:
        (block_size, score_bits, num_blocks, post_data_bytes,
         tf_data_bytes) = struct.unpack_from(_HEADER_V2_FMT, head, _HEADER_V2_OFF)
        if block_size < 2 or block_size & (block_size - 1):
            raise ArtifactError(f"{path}: invalid v2 block size {block_size}")
        if version == VERSION_V2:
            score_bits = 0  # v2 writers zeroed this slot
        elif score_bits not in (8, 16):
            raise ArtifactError(f"{path}: invalid v2.1 score_bits {score_bits}")
        v2 = (block_size, num_blocks, post_data_bytes, tf_data_bytes)
        layout, total = _layout_v2(vocab, blob_bytes, num_blocks, post_data_bytes,
                                   tf_data_bytes, max_doc_id, score_bits=score_bits)
    else:
        layout, total = _layout(vocab, num_postings, blob_bytes)
    if total != size or payload_bytes != size - HEADER_BYTES:
        raise ArtifactError(
            f"{path}: truncated artifact — header promises "
            f"{total} bytes, file has {size}")
    if zlib.adler32(mm[HEADER_BYTES:]) != payload_crc:
        raise ArtifactError(f"{path}: payload checksum mismatch")

    raw = np.frombuffer(mm, dtype=np.uint8)
    dtypes = {"letter_dir": np.int64, "term_offsets": np.int64,
              "term_blob": np.uint8, "df": np.int32,
              "post_offsets": np.int64, "postings": np.int32,
              "df_order": np.int32,
              "blk_max": np.int32, "blk_first": np.int32,
              "blk_width": np.uint8, "blk_tf_width": np.uint8,
              "blk_max_tf": "<u1" if score_bits == 8 else "<u2",
              "blk_min_dl": "<u1" if score_bits == 8 else "<u2",
              "post_words": np.uint32, "tf_words": np.uint32,
              "doc_lens": np.int32}
    names = {"post_data": "post_words", "tf_data": "tf_words"}
    views = {}
    for name, (off, nbytes) in layout.items():
        name = names.get(name, name)
        views[name] = raw[off:off + nbytes].view(dtypes[name])
    meta = {"version": version, "vocab": vocab, "num_postings": num_postings,
            "max_doc_id": max_doc_id, "width": width, "nbytes": size}
    if v2 is not None:
        block_size, num_blocks, post_data_bytes, tf_data_bytes = v2
        df = views["df"].astype(np.int64)
        bpt = -(-df // block_size)  # ceil(df / B); 0 for df == 0
        term_block_off = np.zeros(vocab + 1, dtype=np.int64)
        np.cumsum(bpt, out=term_block_off[1:])
        if term_block_off[-1] != num_blocks:
            raise ArtifactError(
                f"{path}: v2 geometry mismatch — df implies "
                f"{int(term_block_off[-1])} blocks, header says {num_blocks}")
        blk_cnt = np.full(num_blocks, block_size, dtype=np.int32)
        last = term_block_off[1:][bpt > 0] - 1
        blk_cnt[last] = df[bpt > 0] - (bpt[bpt > 0] - 1) * block_size
        cnt64 = blk_cnt.astype(np.int64)
        pw = (np.maximum(cnt64 - 1, 0) * views["blk_width"].astype(np.int64) + 31) >> 5
        tw = (cnt64 * views["blk_tf_width"].astype(np.int64) + 31) >> 5
        blk_woff = np.zeros(num_blocks + 1, dtype=np.int64)
        np.cumsum(pw, out=blk_woff[1:])
        blk_tf_woff = np.zeros(num_blocks + 1, dtype=np.int64)
        np.cumsum(tw, out=blk_tf_woff[1:])
        if blk_woff[-1] * 4 != post_data_bytes or blk_tf_woff[-1] * 4 != tf_data_bytes:
            raise ArtifactError(
                f"{path}: v2 geometry mismatch — widths imply "
                f"{int(blk_woff[-1]) * 4}/{int(blk_tf_woff[-1]) * 4} "
                f"packed bytes, header says {post_data_bytes}/{tf_data_bytes}")
        meta.update(block_size=block_size, num_blocks=num_blocks,
                    score_bits=score_bits, term_block_off=term_block_off,
                    blk_cnt=blk_cnt, blk_woff=blk_woff, blk_tf_woff=blk_tf_woff)
    return Artifact(path, mm, meta, views)


def term_table(art: Artifact) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(rows, terms, key8)``: NUL-padded (max(V,1), width) uint8 term
    rows, their (V,) ``S{width}`` view, and each term's NUL-padded 8-byte
    prefix (V, 8) — read big-endian, numeric order is lexicographic
    order, so it is the binary-search key."""
    V, width = art.vocab, max(art.width, 1)
    lens = np.diff(art.term_offsets)
    rows = np.zeros((max(V, 1), width), dtype=np.uint8)
    if V:
        rows[np.arange(width) < lens[:, None]] = art.term_blob
    terms = rows.view(f"S{width}").ravel()[:V]
    pad = rows if width >= 8 else np.pad(rows, ((0, 0), (0, 8 - width)))
    key8 = np.ascontiguousarray(pad[:, :8])[:V]
    return rows, terms, key8


def device_columns(art: Artifact) -> dict:
    """Host-side staging of every column the device engine uploads.

    The 8-byte big-endian prefix key becomes ONE int64 per term: terms
    are ``[a-z]`` bytes, so its top byte is at most 0x7a and the signed
    order equals the unsigned one (guarded).  Offsets narrow to int32
    (guarded); the packed v2 streams are int32 tensors holding uint32
    bits, each with two zero pad words, so the two-word bit-window
    gather always has a word after the one it starts in.  ``max_prefix_group`` is
    the largest set of terms sharing one key: the trip count of the
    lookup's shared-prefix fixup.
    """
    if art.num_postings >= 2 ** 31 or art.vocab >= 2 ** 31:
        raise ArtifactError(
            f"{art.path}: {art.num_postings} postings / {art.vocab} terms "
            f"exceed the device engine's int32 addressing")
    rows, _, key8 = term_table(art)
    V = art.vocab
    if V:
        if int(key8[:, 0].max()) >= 0x80:
            raise ArtifactError(
                f"{art.path}: a term starts with a byte >= 0x80, outside "
                f"the device engine's int64 key order")
        key = key8.view(">u8").ravel().astype(np.int64)
        max_group = int(np.unique(key, return_counts=True)[1].max())
    else:
        key = np.zeros(0, dtype=np.int64)
        max_group = 1
    cols = {
        "format": art.version,
        "rows": rows[:V],
        "key": key,
        "df": np.ascontiguousarray(art.df, dtype=np.int32),
        "df_order": np.ascontiguousarray(art.df_order, dtype=np.int32),
        "letter_dir": np.ascontiguousarray(art.letter_dir, dtype=np.int32),
        "max_prefix_group": max_group,
        "vocab": V,
        "width": max(art.width, 1),
        "max_doc_id": art.max_doc_id,
    }
    if art.version == VERSION:
        cols["post_offsets"] = np.ascontiguousarray(art.post_offsets, dtype=np.int32)
        # one pad element: the window gather never indexes an empty column
        cols["postings"] = np.concatenate([art.postings, np.zeros(1, np.int32)])
        return cols
    if art.blk_woff[-1] >= 2 ** 31 - 1 or art.blk_tf_woff[-1] >= 2 ** 31 - 1:
        raise ArtifactError(
            f"{art.path}: packed postings exceed the device engine's "
            f"int32 word addressing")
    pad = np.zeros(2, dtype=np.uint32)
    cols.update({
        "block_size": art.block_size,
        "term_block_off": np.ascontiguousarray(art.term_block_off, dtype=np.int32),
        "blk_first": np.ascontiguousarray(art.blk_first, dtype=np.int32),
        "blk_width": np.ascontiguousarray(art.blk_width, dtype=np.int32),
        "blk_tf_width": np.ascontiguousarray(art.blk_tf_width, dtype=np.int32),
        "blk_woff": np.ascontiguousarray(art.blk_woff, dtype=np.int32),
        "blk_tf_woff": np.ascontiguousarray(art.blk_tf_woff, dtype=np.int32),
        "post_words": np.concatenate([art.post_words, pad]).view(np.int32),
        "tf_words": np.concatenate([art.tf_words, pad]).view(np.int32),
    })
    return cols


def serve_columns(art: Artifact) -> dict:
    """Zero-copy column views for the native serve kernels (the host
    engine's ``NativeServe``): every entry is a view into the artifact's
    map, or a geometry array the loader built, so the dict is valid only
    while the artifact is open.  The native unpack reads one u32 word
    past each block's payload; that read stays in the file because the
    v2 layout puts ``tf_data`` / ``doc_lens`` / ``df_order`` after
    ``post_data`` and ``doc_lens`` / ``df_order`` after ``tf_data``, so
    no pad word is added — and a trimmed copy (``np.fromfile``,
    ``.copy()``) must never stand in for a view.  ``blk_max_tf`` /
    ``blk_min_dl`` go as raw bytes (``None`` on plain v2): the C side
    reads u8 or u16-LE by ``score_bits``.
    """
    if art.version < VERSION_V2:
        raise ArtifactError(
            f"{art.path}: native serve kernels need a v2+ artifact "
            f"(got version {art.version})")
    has_scores = art.score_bits != 0
    return {
        "blk_max": art.blk_max,
        "blk_first": art.blk_first,
        "blk_width": art.blk_width,
        "blk_tf_width": art.blk_tf_width,
        "blk_max_tf": art.blk_max_tf.view(np.uint8) if has_scores else None,
        "blk_min_dl": art.blk_min_dl.view(np.uint8) if has_scores else None,
        "post_words": art.post_words,
        "tf_words": art.tf_words,
        "term_block_off": art.term_block_off,
        "blk_cnt": art.blk_cnt,
        "blk_woff": art.blk_woff,
        "blk_tf_woff": art.blk_tf_woff,
        "vocab": art.vocab,
        "num_blocks": art.num_blocks,
        "block_size": art.block_size,
        "score_bits": art.score_bits,
    }


def bm25_corpus(art: Artifact) -> tuple[np.ndarray, int, float]:
    """``(doc_lens float64, ndocs, avgdl)`` for BM25 scoring.

    v2 reads the doc-length column; v1 carries none, so lengths are
    rebuilt from the postings (each stored pair counts 1, the tf=1
    fallback the scorer uses)."""
    if art.version >= VERSION_V2:
        doc_lens = art.doc_lens.astype(np.float64)
    elif art.num_postings:
        flat = art.postings.astype(np.int64)
        starts = art.post_offsets[:-1]
        csum = np.cumsum(flat)
        # undo the per-term delta encoding in one pass
        base = np.repeat(csum[starts] - flat[starts], np.diff(art.post_offsets))
        doc_lens = np.bincount((csum - base).astype(np.int64),
                               minlength=art.max_doc_id + 1).astype(np.float64)
    else:
        doc_lens = np.zeros(art.max_doc_id + 1, dtype=np.float64)
    ndocs = int(np.count_nonzero(doc_lens))
    avgdl = float(doc_lens[doc_lens > 0].mean()) if ndocs else 1.0
    return doc_lens, ndocs, avgdl


def checksum(path: str | Path) -> tuple[str, int]:
    """``(adler32_hex, size)`` of the artifact file."""
    return file_checksum(path)


# -- builders: lex arrays from the build plans' shapes --------------------


def build_from_merge(path, merge, *, fmt: int | None = None,
                     block_size: int | None = None) -> int:
    """Pack straight off a live :class:`native.HostIndexMerge`: one C++
    pass fills every payload section of the final file buffer at the
    layout's offsets — compact blob, delta-encoded postings and all —
    leaving only checksums, the header, and the atomic write here.  The
    cpu backend's fast path: the two-step ``export_arrays`` +
    :func:`build_from_export` route costs ~2x more on the pack-time
    budget (<= 10 % of the unaudited e2e).

    ``fmt``/``block_size`` default to the ``MRI_SERVE_FORMAT`` /
    ``MRI_SERVE_BLOCK_SIZE`` knobs; format 2 runs the native two-call
    v2 export (prepare sizes the packed streams, payload fills them).
    """
    vocab, width, num_pairs, blob_bytes, max_doc_id = merge.export_info()
    fmt = resolve_format(fmt)
    if fmt >= VERSION_V2:
        block_size = resolve_block_size(block_size)
        bits = resolve_score_bits() if fmt == VERSION_V21 else 0
        num_blocks, post_bytes, tf_bytes = \
            merge.export_v2_prepare(block_size, bits)
        layout, total = _layout_v2(vocab, blob_bytes, num_blocks,
                                   post_bytes, tf_bytes, max_doc_id,
                                   score_bits=bits)
        buf = np.zeros(total, dtype=np.uint8)
        merge.export_v2_payload(
            buf, {n: off for n, (off, _) in layout.items()})
        return _write(path, buf, width=width, vocab=vocab,
                      num_postings=num_pairs, max_doc_id=max_doc_id,
                      blob_bytes=blob_bytes, version=fmt,
                      v2={"block_size": block_size,
                          "num_blocks": num_blocks,
                          "score_bits": bits,
                          "post_data_bytes": post_bytes,
                          "tf_data_bytes": tf_bytes})
    layout, total = _layout(vocab, num_pairs, blob_bytes)
    buf = np.zeros(total, dtype=np.uint8)
    merge.export_payload(buf, {n: off for n, (off, _) in layout.items()})
    return _write(path, buf, width=width, vocab=vocab,
                  num_postings=num_pairs, max_doc_id=max_doc_id,
                  blob_bytes=blob_bytes)


def build_from_export(path, export: dict) -> int:
    """Pack from :meth:`native.HostIndexMerge.export_arrays` output —
    the cpu backend's no-text-round-trip path."""
    vocab_packed = export["vocab_packed"]
    word_lens = np.asarray(export["word_lens"], dtype=np.int64)
    term_offsets = np.zeros(len(word_lens) + 1, dtype=np.int64)
    np.cumsum(word_lens, out=term_offsets[1:])
    if len(word_lens):
        # trim the NUL padding out of the fixed-width rows, vectorized:
        # keep column j of row i when j < word_lens[i]
        width = vocab_packed.shape[1]
        mask = np.arange(width) < word_lens[:, None]
        term_blob = vocab_packed[mask]
    else:
        term_blob = np.zeros(0, dtype=np.uint8)
    return pack(
        path, term_blob=term_blob, term_offsets=term_offsets,
        df=export["df"], post_offsets=export["offsets"],
        postings=export["postings"], df_order=export["df_order"],
        max_doc_id=export["max_doc_id"], width=export["width"])


def build_from_emit_arrays(path, *, vocab: np.ndarray, order: np.ndarray,
                           df: np.ndarray, offsets: np.ndarray,
                           postings: np.ndarray, max_doc_id: int) -> int:
    """Pack from ``formatter.emit_index``'s argument shapes: 'S' terms in
    ANY order (re-sorted to the lex invariant here), ``order`` the emit
    permutation over those indices, ``offsets``/``df`` addressing
    absolute postings in a possibly oversized buffer."""
    vocab = np.asarray(vocab)
    df = np.asarray(df, dtype=np.int64)
    order = np.asarray(order, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    postings = np.asarray(postings, dtype=np.int32)
    V = len(vocab)
    perm = np.argsort(vocab, kind="stable")
    inv = np.empty(V, dtype=np.int64)
    inv[perm] = np.arange(V)
    vocab = vocab[perm]
    df_lex = df[perm]
    starts_lex = offsets[perm]
    lens = np.char.str_len(vocab).astype(np.int64) if V else np.zeros(0, dtype=np.int64)
    term_offsets = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(lens, out=term_offsets[1:])
    if V:
        width = vocab.dtype.itemsize
        rows = np.ascontiguousarray(vocab).view(np.uint8).reshape(V, width)
        term_blob = rows[np.arange(width) < lens[:, None]]
    else:
        term_blob = np.zeros(0, dtype=np.uint8)
    post_offsets = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(df_lex, out=post_offsets[1:])
    P = int(post_offsets[-1])
    flat = np.zeros(0, dtype=np.int32)
    if P:
        src = (np.repeat(starts_lex, df_lex)
               + (np.arange(P) - np.repeat(post_offsets[:-1], df_lex)))
        flat = postings[src]
    return pack(path, term_blob=term_blob, term_offsets=term_offsets, df=df_lex,
                post_offsets=post_offsets, postings=flat,
                df_order=inv[order], max_doc_id=int(max_doc_id))


def build_from_grouped(path, per_letter: dict) -> int:
    """Pack from the oracle/empty-path grouped form: per-letter lists of
    ``(word_bytes, ids)`` already in emit order."""
    words: list[bytes] = []
    ids: list[list[int]] = []
    for letter in sorted(per_letter):
        for word, docs in per_letter[letter]:
            words.append(word)
            ids.append(list(docs))
    emit_to_lex = np.argsort(np.array(words, dtype="S") if words
                             else np.zeros(0, dtype="S1"), kind="stable")
    lex_words = [words[i] for i in emit_to_lex]
    df_order = np.empty(len(words), dtype=np.int64)
    df_order[emit_to_lex] = np.arange(len(words))
    term_blob = np.frombuffer(b"".join(lex_words), dtype=np.uint8)
    term_offsets = np.zeros(len(words) + 1, dtype=np.int64)
    np.cumsum([len(w) for w in lex_words], out=term_offsets[1:])
    df = np.array([len(ids[i]) for i in emit_to_lex], dtype=np.int64)
    post_offsets = np.zeros(len(words) + 1, dtype=np.int64)
    np.cumsum(df, out=post_offsets[1:])
    flat = (np.concatenate([np.asarray(ids[i], dtype=np.int32) for i in emit_to_lex])
            if words else np.zeros(0, dtype=np.int32))
    max_doc_id = int(flat.max()) if len(flat) else 0
    return pack(path, term_blob=term_blob, term_offsets=term_offsets, df=df,
                post_offsets=post_offsets, postings=flat, df_order=df_order,
                max_doc_id=max_doc_id)
