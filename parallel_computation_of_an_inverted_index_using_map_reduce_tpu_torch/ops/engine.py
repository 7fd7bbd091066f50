"""Device engine: the whole reduce phase as a few torch calls on the card.

The reference's reduce phase — re-parse spill text, linear-scan dict
dedup, qsort by (df desc, word asc), bubble-sort postings, format
(main.c:126-242) — becomes a program over integer tensors:

    sort packed (term, doc) keys          ->  torch.sort
    per-(term, doc) dedup + unique count  ->  unique_mask_count kernel
    document frequency                    ->  run-edge cumsum differences
    postings lists (ascending, compact)   ->  rank scatter (ops/segment.py)
    final emit order (letter, -df, term)  ->  one int64 key sort

Padding keys sort to the tail and fall out of the run edges.  Control
crosses host<->device twice: feed the pairs, fetch the postings.  Each
function takes and returns tensors on one device, the card or (for
tests) the CPU, where the kernels run their plain versions.

Feeds the native combiner already deduped (each (term, doc) pair once)
need only the sort: :func:`index_prededuped_u16` (one-shot) and
:func:`sort_prov_chunks` (the pipelined plan's provisional-key
windows).  Their postings come back narrowed to 16 bits on the card
(an int16 tensor holding uint16 bits, :func:`host_u16` reads it), and
:func:`upload` / :class:`PendingFetch` move the windows and the result
through pinned host memory so both copies overlap host work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import timing
from . import keys as K
from .kernels import unique_mask_count
from .segment import compact, first_occurrence_mask, sorted_segment_counts

_INT64_MAX = 2**63 - 1


def emit_order(letter_of_term: torch.Tensor, df: torch.Tensor, vocab_size: int,
               max_doc_id: int) -> torch.Tensor:
    """Term ids ordered (letter asc, df desc, term asc), int64.

    Within a letter file: df descending, then word ascending — term ids
    are assigned in sorted-vocab order, so ``term id asc == word asc``
    and no strings are needed on the card.  One int64 key holds all
    three fields wherever the JAX package needs an int32 key or a
    stable three-key sort; keys are distinct, so any sort gives the
    same order.
    """
    stride = max_doc_id + 2
    if 26 * stride * (vocab_size + 1) >= _INT64_MAX:
        raise ValueError(
            f"emit key overflows int64 (vocab {vocab_size}, max doc {max_doc_id})")
    neg_df = (max_doc_id + 1) - df.to(torch.int64)  # df <= max_doc_id + 1
    terms = torch.arange(vocab_size, dtype=torch.int64, device=df.device)
    emit_key = (letter_of_term.to(torch.int64) * stride + neg_df) * vocab_size + terms
    return torch.sort(emit_key).indices


def host_order_offsets(letter_of_term, df) -> tuple[np.ndarray, np.ndarray]:
    """Emit order + postings offsets computed on the host from fetched df.

    Both are vocab-sized and derive from df alone, so fetching df is
    enough.  ``np.lexsort`` is stable, so full ties fall back to term id
    ascending == word ascending, matching main.c:55-64.
    """
    df64 = np.asarray(df).astype(np.int64)
    order = np.lexsort((-df64, np.asarray(letter_of_term)))
    offsets = np.cumsum(df64) - df64
    return order.astype(np.int64), offsets


def dedup_df_postings(keys_s: torch.Tensor, *, vocab_size: int, max_doc_id: int):
    """Shared post-sort block: per-(term, doc) dedup, document frequency,
    compacted postings — from an ascending packed-key array (may contain
    ``K.INT32_MAX`` padding, which sorts last and is dropped).

    Returns ``(first, df, postings, num_unique)``; the mask and the
    unique count come from the ``unique_mask_count`` kernel."""
    valid_limit = vocab_size * (max_doc_id + 2)
    term_s, doc_s = K.unpack_pairs(keys_s, max_doc_id)
    first, num_unique = unique_mask_count(keys_s, valid_limit)
    df = sorted_segment_counts(term_s, first.to(torch.int32), vocab_size)
    postings = compact(doc_s, first, keys_s.shape[0], 0)
    return first, df, postings, num_unique


def postings_from_sorted(keys_s: torch.Tensor, letter_of_term: torch.Tensor, *,
                         vocab_size: int, max_doc_id: int) -> dict:
    """Postings/df/order from an ascending packed-key array."""
    _, df, postings, num_unique = dedup_df_postings(
        keys_s, vocab_size=vocab_size, max_doc_id=max_doc_id)
    return {
        "postings": postings,
        "df": df,
        "order": emit_order(letter_of_term, df, vocab_size, max_doc_id),
        "offsets": torch.cumsum(df, 0, dtype=df.dtype) - df,
        "num_unique": num_unique,
    }


def index_packed(keys: torch.Tensor, letter_of_term: torch.Tensor, *,
                 vocab_size: int, max_doc_id: int) -> dict:
    """Index a batch of packed (term, doc) int32 keys.

    ``keys`` may be padded with ``K.INT32_MAX`` (sorts after every valid
    key since ``can_pack`` guarantees headroom).
    """
    return postings_from_sorted(
        torch.sort(keys).values, letter_of_term,
        vocab_size=vocab_size, max_doc_id=max_doc_id)


def pack_u16_feed(terms, docs, padded: int) -> np.ndarray:
    """Host-side encode of the half-bandwidth uint16 feed buffer:
    ``[terms | docs]``, each half ``padded`` long, 0xFFFF padding — the
    layout :func:`u16_feed_to_keys` decodes on the device."""
    buf = np.full(2 * padded, 0xFFFF, dtype=np.uint16)
    n = len(terms)
    buf[:n] = terms
    buf[padded : padded + n] = docs
    return buf


def u16_feed_tensor(buf_u16: np.ndarray, device) -> torch.Tensor:
    """Upload a :func:`pack_u16_feed` buffer.  Torch's uint16 coverage on
    the card is thin, so the bytes travel as an int16 view."""
    return torch.from_numpy(buf_u16.view(np.int16)).to(device)


def u16_feed_to_keys(feed_i16: torch.Tensor, max_doc_id: int) -> torch.Tensor:
    """``[terms | docs]`` int16 view of the uint16 feed (0xFFFF padding)
    -> packed int32 keys, widened on the device with ``& 0xFFFF``."""
    stride = max_doc_id + 2
    half = feed_i16.shape[0] // 2
    wide = feed_i16.to(torch.int32) & 0xFFFF
    term, doc = wide[:half], wide[half:]
    return torch.where(term == 0xFFFF, K.INT32_MAX, term * stride + doc)


def index_u16(feed_i16: torch.Tensor, *, vocab_size: int, max_doc_id: int) -> dict:
    """Transfer-minimized path for corpora with vocab_size <= 65535 and
    max_doc_id <= 65534 (the reference's whole envelope, MAX_FILES=360 at
    main.c:8).

    The input is ONE buffer: term ids in the first half, doc ids in the
    second, 0xFFFF padding; keys are packed on the device.  The output
    is the single int32 array ``combined = [df | postings]``, whose values
    all fit uint16: the host narrows what it fetches (:func:`narrow_u16`)
    and derives ``order``/``offsets``/``num_unique`` from df
    (:func:`host_order_offsets`).
    """
    keys = u16_feed_to_keys(feed_i16, max_doc_id)
    _, df, postings, _ = dedup_df_postings(
        torch.sort(keys).values, vocab_size=vocab_size, max_doc_id=max_doc_id)
    return {"combined": torch.cat([df, postings])}


def narrow_u16(t: torch.Tensor) -> np.ndarray:
    """Fetch an int32 tensor whose values fit uint16 and narrow it on the
    host."""
    return t.cpu().numpy().astype(np.uint16)


def index_pairs(term_ids: torch.Tensor, doc_ids: torch.Tensor,
                letter_of_term: torch.Tensor, *, vocab_size: int, max_doc_id: int) -> dict:
    """General path for corpora too large to pack into one int32 key.

    Sorts one int64 key ``term << 31 | doc`` (both fields are
    nonnegative int32), otherwise identical semantics to
    :func:`index_packed`.  Padding: term = doc = INT32_MAX.
    """
    key = torch.sort((term_ids.to(torch.int64) << 31) | doc_ids.to(torch.int64)).values
    term_s = (key >> 31).to(torch.int32)
    doc_s = (key & K.INT32_MAX).to(torch.int32)
    valid = term_s < vocab_size
    first = first_occurrence_mask(key) & valid
    df = sorted_segment_counts(
        torch.where(valid, term_s, vocab_size), first.to(torch.int32), vocab_size)
    return {
        "postings": compact(doc_s, first, term_s.shape[0], 0),
        "df": df,
        "order": emit_order(letter_of_term, df, vocab_size, max_doc_id),
        "offsets": torch.cumsum(df, 0, dtype=df.dtype) - df,
        "num_unique": first.sum(dtype=torch.int32),
    }


def upload(host: np.ndarray, device: torch.device, keep: list) -> torch.Tensor:
    """Start copying one feed buffer to ``device`` and return the device
    tensor.  On the card the bytes are staged in pinned memory so the
    copy runs asynchronously, overlapping the host's next window; the
    pinned tensor goes into ``keep``, which the caller holds until the
    copy has been consumed.  On the CPU the buffer is used in place."""
    t = torch.from_numpy(host)
    if device.type != "cuda":
        return t
    pinned = t.pin_memory()
    keep.append(pinned)
    return pinned.to(device, non_blocking=True)


class PendingFetch:
    """A device->host copy in flight: on the card a ``non_blocking`` copy
    into pinned memory plus a CUDA event, so the host works meanwhile;
    :meth:`wait` blocks on the event and returns the numpy array (never
    read the buffer before that — the bytes are not there yet).  Inside a
    build the block's time adds to ``card_wait_ms``
    (``obs.timing.wait_on_card``)."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            # on the stream of the tensor's own card, which runs the copy
            # (a mesh shard may live on another card than the current one)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def wait(self) -> np.ndarray:
        if self._event is not None:
            timing.wait_on_card(self._event.synchronize)
        return self._host.numpy()


def host_u16(a: np.ndarray) -> np.ndarray:
    """The uint16 values of a fetched int16 tensor (the bits are the
    same; torch has no uint16 arithmetic on the card)."""
    return a.view(np.uint16)


def host_view(a: np.ndarray) -> np.ndarray:
    """A fetched array as the host reads it: int16 tensors carry uint16
    bits (no uint16 arithmetic on the card), so they are read as uint16."""
    return host_u16(a) if a.dtype == np.int16 else a


def leaves(v) -> list:
    """The tensors of a tensor or a nested tuple of them, in order."""
    return [v] if isinstance(v, torch.Tensor) else [t for x in v for t in leaves(x)]


def index_prededuped_u16(feed_i16: torch.Tensor, *, max_doc_id: int,
                         out_size: int | None = None) -> torch.Tensor:
    """Minimal device program for a combiner-deduped one-shot feed.

    When the host map phase already emitted each (term, doc) pair once,
    the reduce phase is exactly one sort: postings = doc component of
    the ascending pair keys.  df, order and offsets derive from the
    deduped term ids on the host (vocab-sized).  ``out_size`` limits the
    result to the valid prefix, so the fetch carries no padding beyond
    the rounding granule.  Returns int16 holding uint16 doc ids.
    """
    keys = u16_feed_to_keys(feed_i16, max_doc_id)
    docs = torch.sort(keys).values
    if out_size is not None:
        docs = docs[:out_size]
    return (docs % (max_doc_id + 2)).to(torch.int16)


def sort_prov_chunks(chunks, *, stride: int, out_size: int) -> torch.Tensor:
    """Pipelined plan: sort packed *provisional*-id keys fed per window.

    Each element of ``chunks`` is one upload window, copied while the
    host was still scanning later documents — provisional ids are
    first-occurrence ids, stable the moment a window is scanned, so this
    program never depends on the final sorted vocab.  A window is either
    int32 ``prov_id * stride + doc`` keys (INT32_MAX padding) or, while
    its prov ids still fit, the int16 view of a uint16 ``[terms | docs]``
    buffer (0xFFFF padding) packed into the same keys here.  Postings
    only need *grouping* by term and docs ascending, which the key sort
    gives; the host resolves emit order and offsets in prov space.

    Combiner-deduped feeds only.  Returns the doc component of the first
    ``out_size`` ascending keys — the concatenated postings lists in
    prov-id order — as int16 holding uint16 (callers guarantee
    ``stride <= 0x10000``).
    """
    as_keys = [u16_feed_to_keys(c, stride - 2) if c.dtype == torch.int16 else c
               for c in chunks]
    keys = as_keys[0] if len(as_keys) == 1 else torch.cat(as_keys)
    return (torch.sort(keys).values[:out_size] % stride).to(torch.int16)
