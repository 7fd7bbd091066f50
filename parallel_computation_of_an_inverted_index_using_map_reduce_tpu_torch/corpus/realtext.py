"""Real-text corpus at magnitude: a directory of text files resharded
at paragraph granularity.

BASELINE.json config 5 names a "real-text streaming corpus (Wikipedia
abstracts)" regime; with no network the same regime is built from a
corpus on disk — the reference's six Gutenberg books (SURVEY.md §2.2:
355 chapter files, 5.79 MB), or any directory of ``.txt`` files —
split at blank-line paragraph boundaries and cycled to the target
document count.  Unlike the Zipf synthesizer (:mod:`.synthetic`), real
text keeps what synthetic text lacks: real vocabulary growth curves,
real word-length distribution, real letter skew (SURVEY.md §2.3),
punctuation/UTF-8 cleaning work, and natural paragraph-length variance.

Manifest-shaped like :class:`.synthetic.SyntheticManifest` (duck-types
``__len__`` / ``doc_id`` / ``read_doc`` / ``paths`` / ``sizes`` /
``total_bytes``, plus ``fingerprint_extra`` for stream checkpoints), so
every loader — streaming chunks, byte-balanced range plans, the host
backend's windows — works unchanged.  The JAX package's
``corpus/realtext.py``: the same directory gives the same documents,
sizes and fingerprint, byte for byte.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

from .virtualseq import VirtualSeq


def _cycle_tag(cycle: int, width: int) -> bytes:
    """FIXED-WIDTH base-26 letter tag for a repeat cycle.

    Letters only (digits would be deleted by the cleaning rule,
    main.c:105-111, and collide across cycles).  The width is fixed
    per manifest, NOT per cycle: variable-width tags make word+tag
    concatenation ambiguous across cycles ("web"+"a" == "we"+"ba"),
    silently undercounting the vocab growth the salting exists to
    create.  With one width, equal salted terms force equal word
    lengths, hence equal words and equal tags.
    """
    c = cycle - 1
    tag = bytearray()
    for _ in range(width):
        tag.insert(0, 97 + c % 26)
        c //= 26
    if c:
        raise ValueError(f"cycle {cycle} does not fit a {width}-letter tag")
    return bytes(tag)


class ParagraphManifest:
    """Paragraph-resharded real-text corpus, cycled to ``num_docs``.

    Holds the source paragraphs in memory once (~5.8 MB for the
    reference corpus) and serves document ``i`` as paragraph
    ``i % P`` — documents are never materialized as files.

    ``salt_cycles=True`` makes repeat cycles grow the vocabulary with
    real-text shape instead of freezing it after one pass (doc ``i``
    as plain paragraph ``i % P`` pins the term
    space at the source vocabulary — 33,262 terms for the reference
    corpus — after the first cycle, so "vocabulary growth curves", the
    regime's stated motivation, would be exercised for one cycle only).
    Cycle 0 stays the untouched real text; every whitespace token of
    cycle ``r >= 1`` gets the cycle's letter tag suffixed, so each
    cycle re-contributes the source vocabulary as NEW terms with the
    source's word-shape, first-letter skew (the letter-owner partition
    keys), and per-paragraph distinct-word counts intact.

    Growth is ~full-vocabulary per cycle, not exactly: letters-only
    tags cannot be collision-proof against cycle 0 (a raw word ``cab``
    equals salted ``c``+``ab``), and tokens that clean to nothing
    (digits/punctuation, main.c:105-111) survive salting as the bare
    tag — one extra term per cycle.  Salted-vs-salted ambiguity IS
    eliminated by the fixed tag width (see :func:`_cycle_tag`).  Both
    residuals are noise at corpus scale; the recorded ``vocab_curve``
    is the measured truth either way.

    Salting rebuilds each document as ``b" ".join(w + tag for w in
    para.split())``, so every whitespace RUN (newlines, tabs, multiple
    spaces) collapses to one space in cycles >= 1 — salted cycles are
    a few bytes smaller per paragraph than ``raw + tags`` and their
    byte layout differs from cycle 0's.  Token content is unaffected
    (the tokenizer treats any whitespace run as one separator,
    mirroring the reference's strtok at main.c:97-103), and the size
    accounting below already uses the collapsed formula — but don't
    expect cycle bytes to be comparable across the raw/salted boundary.
    """

    def __init__(self, src_dir: str | Path, num_docs: int | None = None,
                 repeats: int = 1, salt_cycles: bool = False):
        src_dir = Path(src_dir)
        files = sorted(p for p in src_dir.rglob("*.txt") if p.is_file())
        if not files:
            raise ValueError(f"no .txt files under {src_dir}")
        corpus_h = hashlib.md5()
        paras: list[bytes] = []
        for f in files:
            data = f.read_bytes()
            corpus_h.update(data)
            for p in data.replace(b"\r\n", b"\n").split(b"\n\n"):
                if p.strip():
                    paras.append(p)
        self._paras = paras
        self.salt_cycles = salt_cycles
        self.num_docs = (num_docs if num_docs is not None
                         else repeats * len(paras))
        if self.num_docs < 1:
            raise ValueError(f"num_docs must be >= 1, got {self.num_docs}")
        self.source_paragraphs = len(paras)
        self.source_files = len(files)
        # corpus identity for stream-checkpoint fingerprints (the
        # virtual path labels are not an identity — see
        # checkpoint.manifest_fingerprint)
        self.fingerprint_extra = (
            f"paras:{corpus_h.hexdigest()}:n{self.num_docs}"
            + (":salted" if salt_cycles else ""))
        lens = [len(p) for p in paras]
        P = len(paras)
        full, rem = divmod(self.num_docs, P)
        if not salt_cycles:
            self.total_bytes = full * sum(lens) + sum(lens[:rem])
            self._sizes = VirtualSeq(self.num_docs,
                                     lambda i: lens[i % P])
        else:
            # one tag width for the whole manifest (see _cycle_tag);
            # 2 letters cover 676 cycles — far past any bench regime
            n_cycles = full + (1 if rem else 0)
            self._tag_width = 2 if n_cycles <= 677 else 4
            tagw = self._tag_width
            # salted doc = b" ".join(w + tag for w in para.split()):
            # size = sum(word lens) + words * tag_width + (words - 1).
            # Precomputed per paragraph so sizes stay O(1) per lookup
            # (the planners index every doc) without materializing the
            # salted text.
            wc = [len(p.split()) for p in paras]
            wsum = [sum(len(w) for w in p.split()) for p in paras]

            def salted_size(j: int) -> int:
                return wsum[j] + wc[j] * tagw + wc[j] - 1

            salted_cycle_total = sum(
                salted_size(j) for j in range(P))
            total = sum(lens) if full else sum(lens[:rem])  # cycle 0 raw
            total += max(full - 1, 0) * salted_cycle_total
            if full and rem:
                total += sum(salted_size(j) for j in range(rem))
            self.total_bytes = total

            def size_of(i: int) -> int:
                r, j = divmod(i, P)
                return lens[j] if r == 0 else salted_size(j)

            self._sizes = VirtualSeq(self.num_docs, size_of)
        self._paths = VirtualSeq(self.num_docs,
                                 lambda i: f"<paragraph doc {i}>")

    def __len__(self) -> int:
        return self.num_docs

    def doc_id(self, index: int) -> int:
        return index + 1

    def read_doc(self, index: int) -> bytes:
        if not 0 <= index < self.num_docs:
            raise IndexError(index)
        cycle, j = divmod(index, len(self._paras))
        para = self._paras[j]
        if cycle == 0 or not self.salt_cycles:
            return para
        tag = _cycle_tag(cycle, self._tag_width)
        return b" ".join(w + tag for w in para.split())

    @property
    def paths(self):
        return self._paths

    @property
    def sizes(self):
        return self._sizes
