"""The 26 letter files of an inverted index, from the documents' bytes.

Written from the definition the reference program (main.c) gives and the
configuration states, in plain PyTorch and numpy, with nothing of the
port:

- a token is a maximal run of bytes other than C-locale whitespace
  (space, \\t, \\n, \\v, \\f, \\r); inside it every byte that is not a
  letter is deleted and letters are lowercased; at most 299 letters are
  kept; a token with no letter is skipped;
- document ``i`` of the list has id ``i + 1``; a word's postings are the
  ids of the documents it occurs in, ascending, each once;
- ``<letter>.txt`` holds the words that begin with that letter, one line
  ``word:[id id ...]`` each, by document frequency descending and then by
  the word ascending; all 26 files exist, empty or not.

The tokens are worked out with torch on the device it is given (the card
once the window has closed, the CPU in the tests); the files are
formatted with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_LETTERS = 299
_WHITESPACE = np.zeros(256, dtype=bool)
_WHITESPACE[list(b" \t\n\v\f\r")] = True
_LOWER = np.zeros(256, dtype=np.uint8)
_LOWER[ord("a"):ord("z") + 1] = np.arange(ord("a"), ord("z") + 1)
_LOWER[ord("A"):ord("Z") + 1] = np.arange(ord("a"), ord("z") + 1)
#: letters a word may have for its base-27 key to fit in int64
_PACKED = 13


class Index:
    """Words (sorted), their document frequencies and postings."""

    def __init__(self, words: list[bytes], df: np.ndarray, offsets: np.ndarray,
                 docs: np.ndarray):
        self.words = words
        self.df = df
        self.offsets = offsets
        self.docs = docs

    @property
    def unique_pairs(self) -> int:
        return int(self.offsets[-1])


def _join(buf: np.ndarray, starts: np.ndarray, stops: np.ndarray):
    """The documents one after another with a newline after each, and
    each document's length in bytes with its newline."""
    lens = (stops - starts).astype(np.int64)
    out = np.full(int(lens.sum() + len(lens)), ord("\n"), dtype=np.uint8)
    pos = np.concatenate([[0], np.cumsum(lens + 1)[:-1]]).astype(np.int64)
    for s, e, p in zip(starts.tolist(), stops.tolist(), pos.tolist()):
        out[p:p + e - s] = buf[s:e]
    return out, lens + 1


def index(buf: np.ndarray, starts: np.ndarray, stops: np.ndarray, *, dedup: bool = True,
          device: str = "cpu") -> Index:
    """The inverted index of documents ``buf[starts[i]:stops[i]]``.

    ``dedup=False`` is the control: the per-document dedup left out, so a
    word's postings list a document once per occurrence and its frequency
    counts occurrences.  It breaks the exactness the configuration
    states."""
    text_np, doc_bytes = _join(buf, starts, stops)
    text = torch.from_numpy(text_np).to(device).long()
    ws = torch.from_numpy(_WHITESPACE).to(device)[text]
    begins = ~ws & torch.cat([ws.new_ones(1), ws[:-1]])
    token_of_byte = torch.cumsum(begins, 0, dtype=torch.int64) - 1
    low = torch.from_numpy(_LOWER).to(device)[text]
    del text, ws, begins
    doc_of_byte = torch.repeat_interleave(
        torch.arange(1, len(doc_bytes) + 1, device=device),
        torch.from_numpy(doc_bytes).to(device))
    at = torch.nonzero(low).squeeze(1)
    if not len(at):
        return Index([], np.zeros(0, np.int64), np.zeros(1, np.int64), np.zeros(0, np.int64))
    tok, ch, tdoc = token_of_byte[at], low[at], doc_of_byte[at]
    del token_of_byte, low, doc_of_byte, at
    ordinal = torch.arange(len(tok), device=device)
    first = torch.cat([tok.new_ones(1, dtype=torch.bool), tok[1:] != tok[:-1]])
    pos = ordinal - torch.cummax(torch.where(first, ordinal, 0), 0).values
    keep = pos < MAX_LETTERS
    ch, tdoc, pos, first = ch[keep], tdoc[keep], pos[keep], first[keep]
    row = torch.cumsum(first, 0) - 1
    n_tok = int(row[-1]) + 1
    width = int(pos.max()) + 1
    mat = torch.zeros((n_tok, width), dtype=torch.uint8, device=device)
    mat[row, pos] = ch
    words_doc = tdoc[first]
    if width <= _PACKED:
        keys = torch.zeros(n_tok, dtype=torch.int64, device=device)
        for j in range(width):
            keys += (mat[:, j].long() - 96).clamp_(min=0) * 27 ** (_PACKED - 1 - j)
        uniq, term = torch.unique(keys, sorted=True, return_inverse=True)
        powers = 27 ** np.arange(_PACKED - 1, -1, -1, dtype=np.int64)
        digits = (uniq.cpu().numpy()[:, None] // powers[None, :]) % 27
        words = [bytes((d[d > 0] + 96).astype(np.uint8)) for d in digits]
    else:
        rows = np.ascontiguousarray(mat.cpu().numpy())
        uniq_np, term_np = np.unique(rows.view(f"S{width}").ravel(), return_inverse=True)
        words = [bytes(w) for w in uniq_np]
        term = torch.from_numpy(term_np.ravel()).to(device)
    ndocs = len(starts) + 1
    pairs = term * ndocs + words_doc
    pairs = torch.unique(pairs, sorted=True) if dedup else torch.sort(pairs).values
    df = torch.bincount(pairs // ndocs, minlength=len(words)).cpu().numpy()
    docs = (pairs % ndocs).cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(df)])
    return Index(words, df, offsets, docs)


def _rows(strings: list[bytes], width: int) -> np.ndarray:
    """Byte strings as zero-padded rows."""
    flat = np.frombuffer(b"".join(strings), dtype=np.uint8)
    lens = np.array([len(s) for s in strings], dtype=np.int64)
    out = np.zeros((len(strings), width), dtype=np.uint8)
    col = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    out[np.repeat(np.arange(len(strings)), lens), col] = flat
    return out


def letter_files(ix: Index) -> list[bytes]:
    """The 26 files' bytes, ``a.txt`` first: each line's word and ``:[``,
    then each id with the space or ``]\\n`` after it, laid out as
    zero-padded rows in file order, the zeros then dropped."""
    if not ix.words:
        return [b""] * 26
    first_letter = np.array([w[0] - ord("a") for w in ix.words], dtype=np.int64)
    order = np.lexsort((np.arange(len(ix.words)), -ix.df, first_letter))
    heads = _rows([w + b":[" for w in ix.words], max(len(w) for w in ix.words) + 2)
    top = int(ix.docs.max())
    id_text = _rows([str(i).encode() for i in range(top + 1)], len(str(top)))
    width = max(heads.shape[1], id_text.shape[1] + 2)
    df = ix.df[order]
    line_rows = 1 + df
    line_at = np.cumsum(line_rows) - line_rows
    mat = np.zeros((int(line_rows.sum()), width), dtype=np.uint8)
    mat[line_at, :heads.shape[1]] = heads[order]
    pair_rank = np.arange(int(df.sum())) - np.repeat(np.cumsum(df) - df, df)
    pair_docs = ix.docs[np.repeat(ix.offsets[order], df) + pair_rank]
    pair_at = np.repeat(line_at + 1, df) + pair_rank
    digits = id_text[pair_docs]
    mat[pair_at, :id_text.shape[1]] = digits
    ends = (digits != 0).sum(axis=1)
    last = pair_rank == np.repeat(df - 1, df)
    mat[pair_at, ends] = np.where(last, ord("]"), ord(" "))
    mat[pair_at[last], ends[last] + 1] = ord("\n")
    row_end = np.cumsum((mat != 0).sum(axis=1))
    out = mat[mat != 0]
    line_end = row_end[line_at + line_rows - 1]
    cut = np.searchsorted(first_letter[order], np.arange(27))
    bounds = np.concatenate([[0], line_end])[cut]
    return [out[bounds[i]:bounds[i + 1]].tobytes() for i in range(26)]
