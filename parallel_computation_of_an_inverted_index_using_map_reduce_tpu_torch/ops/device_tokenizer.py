"""Device-side tokenizer: the whole map phase as one device program.

Every other plan of this package keeps the reference's split: the host
scans text (main.c:102-117 re-expressed in C++/numpy), the device sorts
integers.  This module takes the host off the compute path: raw corpus
bytes go up, the finished index comes down.

    bytes (uint8, N) ──► classify: space/letter as compares
        ──► token segmentation: start mask, letter-count cumsum
        ──► letter compaction: every cleaned letter moves to the front
            in byte order (the byte stream with non-letters deleted,
            main.c:105-111) by a rank scatter (segment.compact)
        ──► per-token offsets/lengths: token start bytes by rank
            scatter (segment.set_bit_positions), then one gather of the
            exclusive letter cumsum; each token's document by a binary
            search of its start byte in the document ends
        ──► word rows: windowed gathers off the compacted letter stream
            pack 5-bit letter codes, 12 per (hi, lo) int32 pair
            (order-preserving, so int order == strcmp order)
        ──► LSD radix passes of stable ``torch.sort`` over (word groups…,
            doc), each pass one int64 key
        ──► boundary-diff word/pair dedup ► df ► postings ► unique rows

Exactness without strings on the host: rows are the *actual cleaned
bytes* (no hashing, no collisions); sorted-row order IS strcmp order
because rows are zero-padded (0x00 < any letter, so shorter words sort
first).  Words longer than ``width`` cleaned letters cannot be
represented exactly; the program returns the global max cleaned length
and the caller MUST fall back to a host path when it exceeds ``width``
(:class:`WidthOverflow`).  The reference's own cap is 299 (main.c:105).

Every function takes tensors on one device, the card or (for tests) the
CPU, and keeps int32 arithmetic throughout; int64 appears only in sort
keys and gather and scatter indices.  Every size is fixed by the host
(``tok_cap``, ``n``), so nothing here waits for the card: the caller
reads the five counts with one sync.  This is the counterpart of the JAX package's
``ops/device_tokenizer.py``, whose TPU-specific rules (no large
scatters, one-key/two-key letter compaction) do not carry over; its
outputs do, byte for byte.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import segment

INT32_MAX = 2**31 - 1


class WidthOverflow(Exception):
    """A cleaned token exceeded the row width — the device rows would be
    truncated (inexact); the caller must fall back to a host tokenizer."""


@functools.lru_cache(maxsize=1)
def _byte_tables():
    """(space, lower) 256-entry numpy tables — the exact C-locale
    contract of the native scan (native/tokenizer.cc ByteTables)."""
    space = np.zeros(256, np.bool_)
    for b in b" \t\n\v\f\r":
        space[b] = True
    lower = np.zeros(256, np.uint8)
    for b in range(ord("a"), ord("z") + 1):
        lower[b] = b
    for b in range(ord("A"), ord("Z") + 1):
        lower[b] = b + 32
    return space, lower


def _tokenize_front(data, doc_ends, doc_id_values, *, tok_cap: int, num_docs: int):
    """Shared front half of both tokenizer frontends: byte classify,
    token segmentation, letter compaction, per-token offsets/lengths
    and doc ids.  Returns ``(letters, F0, tok_len, max_word_len,
    doc_of_tok, valid_tok, num_tokens, n)`` — everything the word-row
    packers (:func:`tokenize_rows`, :func:`tokenize_groups`) need."""
    n = data.shape[0]
    dev = data.device
    # Exact C-locale contract of native/tokenizer.cc ByteTables: space =
    # {0x20, 0x09..0x0D}; A-Z|0x20 lands in [a-z] and no non-letter
    # byte does (the only preimages of [0x61,0x7A] under |0x20 are the
    # two letter ranges).
    is_space = (data == 0x20) | ((data >= 0x09) & (data <= 0x0D))
    lc = data | 0x20
    is_letter = (lc >= 0x61) & (lc <= 0x7A)
    lowered = torch.where(is_letter, lc, 0).to(torch.int32)

    # first byte of each document forces a token break (tokens never
    # span documents).  Padded ends equal n: they are out of range and
    # dropped — sent to a spare slot n, cut off below — never clamped
    # onto byte n-1.
    inner = doc_ends[:-1]
    doc_starts = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    # index_fill_ takes its value as a scalar argument, so nothing is
    # copied from the host: the streaming plan calls this with work queued
    doc_starts.index_fill_(0, inner.to(torch.int64).clamp(max=n), True)
    doc_starts = doc_starts[:n]
    doc_starts[:1].fill_(True)
    prev_space = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), is_space[:-1]])
    token_start = ~is_space & (prev_space | doc_starts)

    cs = torch.cumsum(is_letter, 0, dtype=torch.int32)
    # compacted letter stream: letters in byte order, then zeros (no
    # consumer relies on the tail: every unmasked window read below
    # stays inside its own token's letters)
    letters = segment.compact(lowered, is_letter, n, 0)

    # F[t] = letters strictly before token t's start byte = first
    # compacted slot of token t's letters.  Every letter between token
    # t's start byte and token t+1's belongs to token t (the gap is
    # spaces / non-letters); a letterless token ("42", skipped at
    # main.c:113) gets F[t] == F[t+1] => length 0 => masked invalid.
    # Slots past num_tokens hold INT32_MAX -> clamp to n -> F = total
    # letters => length 0.
    sb = segment.set_bit_positions(token_start, tok_cap + 1)
    sbc = torch.clamp(sb, max=n).to(torch.int64)
    cse = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), cs])  # exclusive
    F = cse[sbc]
    tok_len = F[1:] - F[:-1]
    F0 = F[:-1]
    # true cleaned length, NO width clip (the exactness guard; the
    # reference's own cap is 299, enforced by the caller)
    max_word_len = (tok_len.max() if tok_cap
                    else torch.zeros((), dtype=torch.int32, device=dev))

    # doc id per token: start byte -> manifest slot -> 1-based id.  The
    # slot is the count of inner doc ends at or before the start byte
    # (the ends ascend): searchsorted side="right", so of the
    # zero-length docs that share a start byte the last one owns it —
    # what the JAX package's per-byte scatter-max + cummax gives, here
    # only at token starts (a byte-scale torch.cummax is one launch that
    # took 334 ms at n = 127 M on the H100)
    start = torch.clamp(sb[:-1], 0, n - 1)
    slot = torch.searchsorted(inner, start, right=True)
    doc_of_tok = doc_id_values[torch.clamp(slot, max=num_docs - 1)]

    num_tokens = token_start.sum(dtype=torch.int32)
    valid_tok = (tok_len > 0) & (torch.arange(tok_cap, device=dev) < num_tokens)
    return letters, F0, tok_len, max_word_len, doc_of_tok, valid_tok, num_tokens, n


def tokenize_rows(data, doc_ends, doc_id_values, *, width: int, tok_cap: int,
                  num_docs: int):
    """bytes -> big-endian int32 word-row byte columns + doc column.

    The byte-column frontend: ``width // 4`` columns per word row.
    :func:`tokenize_groups` (the 5-bit frontend the plan runs) is
    tested against it: ``pack_groups(tokenize_rows(x)) ==
    tokenize_groups(x)``.  Returns ``(cols, doc_col, max_word_len,
    num_tokens)``: ``cols[0]`` carries INT32_MAX on empty/padding rows
    (sorts last), ``doc_col`` likewise.
    """
    dev = data.device
    # made before any work is queued: a copy from pageable host memory
    # waits for the stream, so made later it would be a hidden sync
    masktab = torch.tensor([0, -16777216, -65536, -256, -1], dtype=torch.int32, device=dev)
    (letters, F0, tok_len, max_word_len, doc_of_tok, valid_tok,
     num_tokens, n) = _tokenize_front(data, doc_ends, doc_id_values,
                                      tok_cap=tok_cap, num_docs=num_docs)
    # 4-byte packs of the letter stream at every alignment, then one
    # gather per column at F[t] + 4c, masked by how many of the
    # window's 4 bytes belong to the token (uint32 byte prefixes as int32)
    lp = torch.cat([letters, torch.zeros(3, dtype=torch.int32, device=dev)])
    l4 = (lp[0:n] << 24) | (lp[1:n + 1] << 16) | (lp[2:n + 2] << 8) | lp[3:n + 3]
    cols = []
    for c in range(width // 4):
        idx = torch.clamp(F0 + 4 * c, 0, n - 1).to(torch.int64)
        nbytes = torch.clamp(tok_len - 4 * c, 0, 4).to(torch.int64)
        cols.append(l4[idx] & masktab[nbytes])
    # valid rows (>= 1 letter) have column 0's top byte in [a-z] =>
    # positive int32; empty/padding rows sort after every real word
    col0 = torch.where(valid_tok, cols[0], INT32_MAX)
    doc_col = torch.where(valid_tok, doc_of_tok, INT32_MAX)
    return (col0, *cols[1:]), doc_col, max_word_len, num_tokens


def num_groups_for(width: int) -> int:
    """Total (hi, lo) group pairs a ``width``-byte word row packs into
    (12 chars per group — see :func:`pack_groups`)."""
    return (width // 4 + 2) // 3


def clamp_sort_cols(sort_cols: int | None, ncols: int) -> int:
    """The ONE clamp every consumer of ``sort_cols`` shares: the number
    of leading word columns that can be non-constant.  Sorting and fetch
    rely on the same bound — a desynchronized copy would silently drop
    live columns."""
    return ncols if sort_cols is None else max(1, min(sort_cols, ncols))


def live_groups_for(sort_cols: int | None, width: int) -> int:
    """Group pairs that can be non-constant given the host-exact
    ``sort_cols`` byte-column bound (:func:`clamp_sort_cols`, lifted to
    groups)."""
    return (clamp_sort_cols(sort_cols, width // 4) + 2) // 3


def tokenize_groups(data, doc_ends, doc_id_values, *, width: int, tok_cap: int,
                    num_docs: int, sort_cols: int | None = None):
    """bytes -> 5-bit word-row group pairs + doc column.

    Word rows come out directly as the ``(hi, lo)`` 30-bit code pairs of
    :func:`pack_groups` (12 chars per pair, order-preserving,
    injective), built by TWO windowed gathers per group off a 6-char
    packed letter stream.  Groups past the host-exact ``sort_cols``
    bound are constant zeros and never built.  Group 0 pins INT32_MAX
    on empty/padding rows so they sort last; ``doc_col`` likewise.

    Returns ``(groups, doc_col, max_word_len, num_tokens)`` with
    ``groups`` a tuple of ``num_groups_for(width)`` pairs, exactly
    ``pack_groups(tokenize_rows(...), nsort)`` padded with zero pairs.
    """
    dev = data.device
    full = (1 << 30) - 1
    # masktab6[m] keeps the top m of 6 chars: full ^ ((1 << (30 - 5m)) - 1),
    # 0 at m = 0.  Computed on the card, not copied from pageable host
    # memory: the streaming plan calls this with earlier windows' work
    # queued, where such a copy would wait for the card
    shift = 30 - 5 * torch.arange(7, dtype=torch.int32, device=dev)
    masktab6 = full ^ ((torch.ones(7, dtype=torch.int32, device=dev) << shift) - 1)
    (letters, F0, tok_len, max_word_len, doc_of_tok, valid_tok,
     num_tokens, n) = _tokenize_front(data, doc_ends, doc_id_values,
                                      tok_cap=tok_cap, num_docs=num_docs)
    # 6-char packed stream: l6[i] = letters[i..i+5] as 5-bit codes
    # (byte & 31: pad 0, a=1 .. z=26 — order-preserving), char k at
    # shift 25-5k (the largest, 26 << 25, fits int32).  One gather at
    # F[t]+12g yields group g's hi half, one at F[t]+12g+6 its lo half;
    # the mask keeps only the token's own chars (the compacted stream
    # runs straight into the next token's letters).
    codes = letters & 31
    cp = torch.cat([codes, torch.zeros(5, dtype=torch.int32, device=dev)])
    l6 = ((cp[0:n] << 25) | (cp[1:n + 1] << 20) | (cp[2:n + 2] << 15)
          | (cp[3:n + 3] << 10) | (cp[4:n + 4] << 5) | cp[5:n + 5])
    # cap at width too: when 12 * num_groups_for(width) > width, the
    # last group's window reaches past the row — the byte-column
    # frontend drops those chars, so the mask must as well
    tok_len_w = torch.clamp(tok_len, max=width)

    def half(char_off):
        idx = torch.clamp(F0 + char_off, 0, n - 1).to(torch.int64)
        nchars = torch.clamp(tok_len_w - char_off, 0, 6).to(torch.int64)
        return l6[idx] & masktab6[nchars]

    groups = []
    for g in range(live_groups_for(sort_cols, width)):
        hi, lo = half(12 * g), half(12 * g + 6)
        if g == 0:
            hi = torch.where(valid_tok, hi, INT32_MAX)
            lo = torch.where(valid_tok, lo, INT32_MAX)
        groups.append((hi, lo))
    zero = torch.zeros(tok_cap, dtype=torch.int32, device=dev)
    groups.extend((zero, zero) for _ in range(num_groups_for(width) - len(groups)))
    doc_col = torch.where(valid_tok, doc_of_tok, INT32_MAX)
    return tuple(groups), doc_col, max_word_len, num_tokens


def pack_groups(cols, nsort: int):
    """Radix compression of word-row byte columns: cleaned bytes are
    only 0 or a..z, and ``byte & 31`` maps them order-preservingly to
    5-bit codes (pad 0, a=1 .. z=26).  Three byte columns (12 chars)
    repack into one 30-bit (hi, lo) int32 pair.  Returns
    ``ceil(nsort/3)`` pairs; group 0 pins INT32_MAX padding rows so they
    sort last.  The mapping is injective on the charset, so group
    equality == column equality (:func:`unpack_groups` inverts it)."""
    col0 = cols[0]

    def _codes(c):
        return ((c >> 24) & 31, (c >> 16) & 31, (c >> 8) & 31, c & 31)

    zero_col = torch.zeros_like(col0)
    groups = []
    for g in range((nsort + 2) // 3):
        ga = cols[3 * g]
        gb = cols[3 * g + 1] if 3 * g + 1 < nsort else zero_col
        gc = cols[3 * g + 2] if 3 * g + 2 < nsort else zero_col
        a0, a1, a2, a3 = _codes(ga)
        b0, b1, b2, b3 = _codes(gb)
        c0, c1, c2, c3 = _codes(gc)
        hi = (a0 << 25) | (a1 << 20) | (a2 << 15) | (a3 << 10) | (b0 << 5) | b1
        lo = (b2 << 25) | (b3 << 20) | (c0 << 15) | (c1 << 10) | (c2 << 5) | c3
        if g == 0:
            pad = col0 == INT32_MAX
            hi = torch.where(pad, INT32_MAX, hi)
            lo = torch.where(pad, INT32_MAX, lo)
        groups.append((hi, lo))
    return groups


def unpack_groups(groups, ncols: int):
    """Exact inverse of :func:`pack_groups` for non-padding rows: (hi,
    lo) code pairs back to big-endian byte columns.  Padding rows decode
    to garbage; callers mask them."""
    zero = torch.zeros_like(groups[0][0])

    def _byte(code):
        return torch.where(code > 0, code + 96, 0)

    cols = []
    for c in range(ncols):
        g, r = divmod(c, 3)
        if g >= len(groups):
            cols.append(zero)
            continue
        hi, lo = groups[g]
        if r == 0:
            codes = (hi >> 25, hi >> 20, hi >> 15, hi >> 10)
        elif r == 1:
            codes = (hi >> 5, hi, lo >> 25, lo >> 20)
        else:
            codes = (lo >> 15, lo >> 10, lo >> 5, lo)
        b = [_byte(x & 31) for x in codes]
        cols.append((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3])
    return tuple(cols)


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key for a (hi, lo) pair: both are nonnegative int32 (at
    most INT32_MAX), so ``hi << 31 | lo`` orders exactly like the pair."""
    return (hi.to(torch.int64) << 31) | lo.to(torch.int64)


def groups_sort_perm(groups, doc_col) -> torch.Tensor:
    """Sort permutation (int64) for lexicographic ((group pairs…), doc)
    order: LSD radix from the least-significant field — a stable pass
    on ``doc``, then one stable pass per group pair from the last to
    the first, each pass one int64 key."""
    perm = torch.sort(doc_col, stable=True).indices
    for hi, lo in reversed(groups):
        perm = perm[torch.sort(_pair_key(hi[perm], lo[perm]), stable=True).indices]
    return perm


def _neq_prev(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones(1, dtype=torch.bool, device=a.device), a[1:] != a[:-1]])


def sort_dedup_groups(groups, doc_col, cap: int, live: int):
    """Sorted, deduped index from 5-bit group pairs.

    Lexicographic ((group pairs…), doc) order via the radix passes of
    :func:`groups_sort_perm`; INT32_MAX rows (padding / empty) sort
    last and are dropped by the validity mask.  ``live``: group pairs
    that can be non-constant (:func:`live_groups_for`); constant-zero
    tail pairs are left out of the radix passes (a stable pass over a
    constant key is the identity) and returned as zeros.

    Returns ``(num_words, num_pairs, df, postings, unique_groups)`` with
    ``unique_groups`` shaped like ``groups``; every array is ``cap``
    long with a valid prefix of ``num_words`` / ``num_pairs``.
    """
    dev = doc_col.device
    live_pairs = list(groups[:max(1, live)])
    perm = groups_sort_perm(live_pairs, doc_col)
    s_groups = [(hi[perm], lo[perm]) for hi, lo in live_pairs]
    s_docs = doc_col[perm]

    word_valid = s_groups[0][0] != INT32_MAX
    first_word = word_valid & functools.reduce(
        torch.logical_or, (_neq_prev(h) for pair in s_groups for h in pair))
    first_pair = word_valid & (first_word | _neq_prev(s_docs))
    num_words = first_word.sum(dtype=torch.int32)
    num_pairs = first_pair.sum(dtype=torch.int32)

    # W: first row of each unique word (then cap), P: first row of each
    # unique pair; df is the pair-rank difference across a word's rows
    pair_rank = torch.cumsum(first_pair, 0, dtype=torch.int32) - 1
    slots = torch.arange(cap, device=dev)
    W = torch.cat([torch.clamp(segment.set_bit_positions(first_word, cap), max=cap),
                   torch.full((1,), cap, dtype=torch.int32, device=dev)]).to(torch.int64)
    P = torch.clamp(segment.set_bit_positions(first_pair, cap), max=cap).to(torch.int64)
    word_live = slots < num_words
    pair_live = slots < num_pairs
    Wg = torch.clamp(W[:-1], 0, cap - 1)
    Pg = torch.clamp(P, 0, cap - 1)

    pair_excl = torch.cat([pair_rank + 1 - first_pair.to(torch.int32), num_pairs.reshape(1)])
    df = torch.where(word_live, pair_excl[W[1:]] - pair_excl[Wg], 0)
    postings = torch.where(pair_live, s_docs[Pg], 0)
    zero = torch.zeros(cap, dtype=torch.int32, device=dev)
    unique_groups = tuple(
        [(torch.where(word_live, hi[Wg], 0), torch.where(word_live, lo[Wg], 0))
         for hi, lo in s_groups]
        + [(zero, zero)] * (len(groups) - len(live_pairs)))
    return num_words, num_pairs, df, postings, unique_groups


def index_bytes_device(data, doc_ends, doc_id_values, *, width: int, tok_cap: int,
                       num_docs: int, sort_cols: int | None = None) -> dict:
    """bytes -> sorted, deduped index, entirely on ``data``'s device.

    ``data``: uint8 (N,) — concatenated documents, padded with spaces
    (0x20).  ``doc_ends``: int32 (num_docs,) exclusive end offsets.
    ``doc_id_values``: int32 (num_docs,) 1-based ids.  ``width``:
    word-row bytes, a multiple of 4.  ``tok_cap``: token capacity — must
    be > the true token count (callers compute it exactly with
    :func:`host_token_stats`; doc boundaries split tokens, so up to one
    token per byte can exist).  ``sort_cols``: optional radix-pass bound
    from the host-exact max cleaned length.

    Returns a dict of fixed-size tensors; valid prefixes are bounded by
    ``num_words`` / ``num_pairs`` of the 5-int ``counts``.
    ``max_word_len`` must be checked against ``width`` on the host
    (the :class:`WidthOverflow` contract).  Word rows return as the
    5-bit ``unique_groups`` pairs; the host decodes them at vocab scale
    (:func:`decode_word_groups`).
    """
    groups, doc_col, max_word_len, num_tokens = tokenize_groups(
        data, doc_ends, doc_id_values, width=width, tok_cap=tok_cap,
        num_docs=num_docs, sort_cols=sort_cols)
    num_words, num_pairs, df, postings, unique_groups = sort_dedup_groups(
        groups, doc_col, tok_cap, live_groups_for(sort_cols, width))
    # words needing any tail group (cleaned length > 12): group 1's hi
    # is nonzero iff char 13 exists.  The count rides with the other
    # counts so the fetch can size a sparse tail-group transfer
    if len(unique_groups) > 1:
        slots = torch.arange(tok_cap, device=data.device)
        long_mask = (slots < num_words) & (unique_groups[1][0] != 0)
        num_long = long_mask.sum(dtype=torch.int32)
    else:
        num_long = torch.zeros((), dtype=torch.int32, device=data.device)
    return {
        # one 5-int tensor: ONE host sync reads every count; num_tokens
        # lets the caller verify its tok_cap bound held
        "counts": torch.stack([num_words, num_pairs, max_word_len.to(torch.int32),
                               num_tokens, num_long]),
        "df": df,                    # (tok_cap,) valid prefix num_words
        "postings": postings,        # (tok_cap,) valid prefix num_pairs
        # num_groups_for(width) x (hi, lo), valid prefix num_words
        "unique_groups": unique_groups,
    }


def doc_pack_width(max_doc_id: int) -> int:
    """Doc ids per packed int32 for the postings fetch: 3 when ids fit
    10 bits, else 1 (below 2^16 the 16-bit cast already gives
    2-per-4-bytes; above it ids must travel as int32 untouched)."""
    return 3 if 0 < max_doc_id < (1 << 10) else 1


def pack_postings(post: torch.Tensor, k: int) -> torch.Tensor:
    """Postings packer: ``k`` doc ids per int32 in 10-bit fields
    (``k == 1`` passes through).  :func:`unpack_postings` is its
    inverse."""
    if k == 1:
        return post
    npairs = post.shape[0]
    pad = (-npairs) % k
    p = torch.cat([post, torch.zeros(pad, dtype=post.dtype, device=post.device)]).reshape(-1, k)
    return p[:, 0] | (p[:, 1] << 10) | (p[:, 2] << 20) if k == 3 else p[:, 0]


def gather_long_tails(halves, nu: int, nlong: int):
    """Sparse tail-group gather: set-bit indices of the >12-char rows
    (group 1's hi is nonzero exactly there; tail halves are zero past
    ``num_words``, so padding never matches) and every tail half
    gathered at them.  Returns ``(idx, gathered_halves)`` with ``idx``
    INT32_MAX past the true long count — callers slice by the count
    they read from the counts tensor."""
    long_mask = halves[0][:nu] != 0
    idx = segment.set_bit_positions(long_mask, nlong)
    gi = torch.clamp(idx, 0, nu - 1).to(torch.int64)
    return idx, tuple(h[:nu][gi] for h in halves)


def fetch_pack(out: dict, *, nu: int, npairs: int, nlong: int, k: int, live: int,
               narrow: bool) -> dict:
    """Device-side fetch packer for the all-device plan's tail.

    Returns the minimal transfer set, on the card:

    - ``df``: valid prefix, 16 bits when ``narrow`` (df <= max_doc_id),
      int32 otherwise;
    - ``post``: postings packed ``k`` ids per int32 (10-bit fields,
      :func:`doc_pack_width`), else 16 bits when ``narrow``, else
      untouched int32 (doc ids >= 2^16 MUST travel wide);
    - ``g0``: group 0's (hi, lo) prefix — every word's first 12 chars;
    - ``long_idx`` + ``tail``: row indices and tail-group halves for
      ONLY the words longer than 12 chars — the dense tail arrays are
      zero everywhere else, so the host rebuilds them by scatter
      (:func:`rebuild_tail_groups`).

    The 16-bit arrays are int16 tensors holding uint16 bits (torch has
    no uint16 arithmetic on the card); the host reads them as uint16.
    """
    df = out["df"][:nu]
    post = out["postings"][:npairs]
    if narrow:
        df = df.to(torch.int16)
    if k > 1:
        post = pack_postings(post, k)
    elif narrow:
        post = post.to(torch.int16)
    hi0, lo0 = out["unique_groups"][0]
    res = {"df": df, "post": post, "g0": (hi0[:nu], lo0[:nu])}
    if live > 1 and nlong > 0:
        halves = [h for pair in out["unique_groups"][1:live] for h in pair]
        idx, gathered = gather_long_tails(halves, nu, nlong)
        res["long_idx"] = idx  # INT32_MAX past num_long; caller slices
        res["tail"] = tuple((gathered[2 * g], gathered[2 * g + 1]) for g in range(live - 1))
    return res


def rebuild_tail_groups(num_words: int, ngroups_fetch: int, *, idx=None, tails=(),
                        num_long: int = 0):
    """Host-side inverse of the sparse tail-group transfer
    (:func:`gather_long_tails`): dense (hi, lo) pairs for groups
    1..ngroups_fetch-1, zeros everywhere except the ``num_long`` long
    words' rows scattered back at ``idx``."""
    out = []
    for g in range(ngroups_fetch - 1):
        h = np.zeros(num_words, np.int32)
        l = np.zeros(num_words, np.int32)
        if num_long:
            h[idx] = np.asarray(tails[g][0])[:num_long]
            l[idx] = np.asarray(tails[g][1])[:num_long]
        out.append((h, l))
    return out


def unpack_postings(packed: np.ndarray, num_pairs: int, k: int) -> np.ndarray:
    """Host-side inverse of :func:`fetch_pack`'s postings packing.
    ``k == 1`` input is the uint16/int32 passthrough."""
    if k == 1:
        return np.asarray(packed)[:num_pairs].astype(np.int32)
    pw = np.asarray(packed).astype(np.int64)
    return np.stack(
        [pw & 1023, (pw >> 10) & 1023, (pw >> 20) & 1023],
        axis=1).reshape(-1)[:num_pairs].astype(np.int32)


def _host_start_mask(buf: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Token-start mask, host side.  MUST mirror the device classifier
    in :func:`_tokenize_front` byte for byte (same whitespace set, same
    doc-boundary break rule); divergence is asserted loudly by callers."""
    sp = ((buf == 0x20) | (buf == 0x09) | (buf == 0x0A)
          | (buf == 0x0B) | (buf == 0x0C) | (buf == 0x0D))
    prev_sp = np.empty_like(sp)
    prev_sp[0] = True
    prev_sp[1:] = sp[:-1]
    start = ~sp & prev_sp
    start[0] = not sp[0]
    de = ends[:-1][ends[:-1] < buf.shape[0]]
    start[de] |= ~sp[de]
    return start


def host_token_stats(buf: np.ndarray, ends: np.ndarray) -> tuple[int, int]:
    """``(token_count, max_cleaned_len)`` in ONE pass over the buffer.

    The count sizes ``tok_cap`` (the device's ``num_tokens`` is asserted
    against it, so classifier divergence fails loudly instead of
    silently dropping tokens).  The exact max cleaned (letters-only)
    length lets callers raise :class:`WidthOverflow` before paying for
    a doomed launch and pass a tight ``sort_cols`` bound; the device's
    own ``max_word_len`` is asserted equal by callers.

    Runs the native SIMD scan when the library loads, else the numpy
    mirror below (which is also the cross-check reference in tests).
    """
    from .. import native

    res = native.token_stats(buf, ends)
    if res is not None:
        return res
    return _host_token_stats_numpy(buf, ends)


def _host_token_stats_numpy(buf: np.ndarray, ends: np.ndarray) -> tuple[int, int]:
    """Portable numpy mirror of ``mri_token_stats``."""
    start = _host_start_mask(buf, ends)
    count = int(np.count_nonzero(start))
    if count == 0:
        return 0, 0
    _, lower_np = _byte_tables()
    is_letter = lower_np[buf] > 0
    excl = np.cumsum(is_letter, dtype=np.int64) - is_letter
    total = int(excl[-1]) + int(is_letter[-1])
    lens = np.diff(np.append(excl[np.flatnonzero(start)], total))
    return count, int(lens.max())


def decode_word_groups(groups, width: int) -> np.ndarray:
    """Fetched (hi, lo) 5-bit group pairs -> numpy 'S(width)' word array
    — the host-side inverse of :func:`tokenize_groups`'s packing, at
    vocab scale.  Padding rows must already be sliced off by the caller
    (their codes decode to garbage)."""
    u = np.asarray(groups[0][0]).shape[0]
    out = np.zeros((u, width), np.uint8)
    for g, (hi, lo) in enumerate(groups):
        for half_idx, arr in ((0, hi), (1, lo)):
            a = np.asarray(arr).astype(np.int64)
            for k in range(6):
                ch = 12 * g + 6 * half_idx + k
                if ch >= width:
                    break
                code = (a >> (25 - 5 * k)) & 31
                out[:, ch] = np.where(code > 0, code + 96, 0)
    return np.ascontiguousarray(out).view(f"S{width}").reshape(u)
