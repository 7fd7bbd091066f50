"""Build checkpoints: the one-shot plan's tokenized pairs and the
streaming all-device plan's stream state.

The reference's spill files persist after a run and make the reduce
phase re-runnable (main.c:332-341).  Here that is two first-class
artifacts, each saved atomically (tmp + rename):

- the pairs checkpoint (``checkpoint_path``): the tokenized (term_ids,
  doc_ids, vocab) triple, saved once between the map and reduce phases,
  so the device phase can be re-run without touching the corpus;
- the stream checkpoint (``stream_checkpoint``): the verified valid
  prefix of the device stream's row accumulator
  (ops/device_streaming.DeviceStreamEngine.snapshot) plus the stream
  position, saved every few windows so a rerun resumes at the last
  saved window.

The npz layouts, format versions and fingerprint strings are the JAX
package's, so a checkpoint written by either package loads in the
other.  After each save an armed fault injector may corrupt the file
(``ckpt-corrupt``, faults.py).
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
import zipfile
from pathlib import Path

import numpy as np

from .. import faults

log = logging.getLogger("mri_torch.checkpoint")

_FORMAT_VERSION = 2


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file exists but cannot be read back (truncated
    write, disk corruption, or a non-checkpoint file at the path).

    Wraps the opaque ``zipfile.BadZipFile``/EOF errors a damaged npz
    raises, naming the path and the remediation.
    """

    def __init__(self, path, cause):
        self.path = str(path)
        super().__init__(
            f"checkpoint {self.path!r} is corrupt or truncated "
            f"({cause.__class__.__name__}: {cause}); delete it, or move "
            f"it aside and rerun — --resume=auto quarantines it to "
            f"{self.path!r}.corrupt and restarts automatically")


# error classes a torn/garbage npz surfaces from np.load + member reads
_CORRUPT_ERRORS = (zipfile.BadZipFile, zipfile.LargeZipFile, EOFError,
                   KeyError, struct.error, OSError)


def quarantine(path: str | Path) -> str:
    """Move a corrupt checkpoint aside to ``<path>.corrupt`` (atomic
    rename; any previous quarantine at that name is replaced) so the
    run can start fresh without destroying the evidence."""
    dest = str(path) + ".corrupt"
    os.replace(path, dest)
    log.warning("quarantined corrupt checkpoint to %s", dest)
    return dest


def manifest_fingerprint(manifest) -> str:
    """Identity of the *file list* (count + paths), not file contents.

    Resume trusts the checkpoint over the corpus bytes, like the
    reference's leftover spill files; a changed file count or a renamed
    path is a different corpus and is rejected at load.

    A virtual manifest (corpus/synthetic.py) carries its identity in
    ``fingerprint_extra`` (the generator's parameters) and is hashed by
    that string alone: its paths are placeholders, equal for any two
    corpora of one size.  The JAX package hashes the same bytes, so the
    fingerprint of any manifest is equal in both packages.
    """
    h = hashlib.md5()
    h.update(str(len(manifest)).encode())
    extra = getattr(manifest, "fingerprint_extra", "")
    if extra:
        h.update(extra.encode())
    else:
        for p in manifest.paths:
            h.update(b"\0" + p.encode("utf-8", "surrogateescape"))
    return h.hexdigest()


def _saved(path: Path) -> None:
    """The post-save fault hook (``ckpt-corrupt:save=N``)."""
    inj = faults.active()
    if inj is not None:
        inj.on_checkpoint_saved(str(path))


def save_pairs(path: str | Path, corpus, fingerprint: str = "") -> None:
    """Atomically persist a TokenizedCorpus."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            version=np.int64(_FORMAT_VERSION),
            fingerprint=np.bytes_(fingerprint.encode()),
            term_ids=corpus.term_ids,
            doc_ids=corpus.doc_ids,
            vocab=corpus.vocab,
            letter_of_term=corpus.letter_of_term,
            pairs_deduped=np.int64(1 if corpus.pairs_deduped else 0),
            raw_tokens=np.int64(corpus.raw_tokens if corpus.raw_tokens is not None else -1),
        )
    os.replace(tmp, path)
    _saved(path)


def load_pairs(path: str | Path, expect_fingerprint: str | None = None):
    """Restore a TokenizedCorpus; reject a version or manifest mismatch
    (ValueError) and raise :class:`CheckpointCorrupt` for a damaged or
    truncated file."""
    from ..text.tokenizer import TokenizedCorpus

    try:
        with np.load(path) as z:
            version = int(z["version"])
            if version != _FORMAT_VERSION:
                raise ValueError(
                    f"checkpoint {path!r} has version {version}, expected {_FORMAT_VERSION}")
            saved_fp = bytes(z["fingerprint"]).decode()
            if expect_fingerprint is not None and saved_fp != expect_fingerprint:
                raise ValueError(
                    f"checkpoint {path!r} was written for a different manifest "
                    f"(saved {saved_fp[:12]}…, current {expect_fingerprint[:12]}…); "
                    "delete the checkpoint or restore the original file list")
            raw = int(z["raw_tokens"]) if "raw_tokens" in z.files else -1
            return TokenizedCorpus(
                term_ids=z["term_ids"],
                doc_ids=z["doc_ids"],
                vocab=z["vocab"],
                letter_of_term=z["letter_of_term"],
                pairs_deduped=(bool(int(z["pairs_deduped"]))
                               if "pairs_deduped" in z.files else False),
                raw_tokens=raw if raw >= 0 else None,
            )
    except FileNotFoundError:
        raise
    except _CORRUPT_ERRORS as e:
        raise CheckpointCorrupt(path, e) from e


# version 2: the JAX package's current stream format (its virtual
# manifests changed their fingerprints at the bump; file manifests, the
# only kind this package has, did not)
_STREAM_FORMAT_VERSION = 2


def stream_fingerprint(manifest, *, width: int, chunk_docs: int,
                       pad_multiple: int) -> str:
    """Identity of a resumable stream: the manifest plus every config
    knob that moves window boundaries or the row shape.  Resuming under
    another chunking would re-feed or skip documents; another width
    changes the row layout — both are rejected at load."""
    return (f"{manifest_fingerprint(manifest)}:w{width}"
            f":c{chunk_docs}:p{pad_multiple}")


def save_stream_state(path: str | Path, state: dict, fed_tokens: int,
                      window_pos: int, fingerprint: str) -> None:
    """Atomically persist a DeviceStreamEngine snapshot (tmp + rename).

    Uncompressed ``np.savez`` on purpose: the accumulator prefix can be
    hundreds of MB, and compression would cost far more than the disk.
    """
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    cols = {f"col_{i}": c for i, c in enumerate(state["columns"])}
    with open(tmp, "wb") as f:
        np.savez(
            f,
            version=np.int64(_STREAM_FORMAT_VERSION),
            fingerprint=np.bytes_(fingerprint.encode()),
            width=np.int64(state["width"]),
            count=np.int64(state["count"]),
            cap=np.int64(state["cap"]),
            live_groups=np.int64(state["live_groups"]),
            max_word_len=np.int64(state["max_word_len"]),
            windows_fed=np.int64(state["windows_fed"]),
            # loop position in the window iteration — distinct from
            # windows_fed, which skips empty (tok_count == 0) windows
            window_pos=np.int64(window_pos),
            fed_tokens=np.int64(fed_tokens),
            rows_curve=np.asarray(state["rows_curve"], np.int64),
            num_columns=np.int64(len(state["columns"])),
            **cols,
        )
    os.replace(tmp, path)
    _saved(path)


def load_stream_state(path: str | Path, expect_fingerprint: str) -> dict:
    """Restore a stream snapshot; reject a version or fingerprint
    mismatch (ValueError) and raise :class:`CheckpointCorrupt` — never
    a raw zipfile error — for a damaged or truncated file."""
    try:
        with np.load(path) as z:
            version = int(z["version"])
            if version != _STREAM_FORMAT_VERSION:
                raise ValueError(
                    f"stream checkpoint {path!r} has version {version}, "
                    f"expected {_STREAM_FORMAT_VERSION}")
            saved_fp = bytes(z["fingerprint"]).decode()
            if saved_fp != expect_fingerprint:
                raise ValueError(
                    f"stream checkpoint {path!r} was written for a different "
                    f"manifest or stream config (saved {saved_fp[:20]}…, "
                    f"current {expect_fingerprint[:20]}…); delete it or "
                    "restore the original run configuration")
            return {
                "width": int(z["width"]),
                "count": int(z["count"]),
                "cap": int(z["cap"]),
                "live_groups": int(z["live_groups"]),
                "max_word_len": int(z["max_word_len"]),
                "windows_fed": int(z["windows_fed"]),
                "window_pos": int(z["window_pos"]),
                "fed_tokens": int(z["fed_tokens"]),
                "rows_curve": (z["rows_curve"].tolist()
                               if "rows_curve" in z.files else []),
                "columns": [z[f"col_{i}"] for i in range(int(z["num_columns"]))],
            }
    except FileNotFoundError:
        raise
    except _CORRUPT_ERRORS as e:
        raise CheckpointCorrupt(path, e) from e
