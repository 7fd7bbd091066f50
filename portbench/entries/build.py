"""Build cells: whole builds of a configuration's corpus through the
port's command line, back to back in one process.

Set-up writes the corpus as one file per document with its manifest and
flushes it to disk, loads the port's native library (its ``g++`` build on
a checkout's first run, reported as ``compile_s``) and makes one build to
warm up.  The window then runs builds until one ends past ``--seconds``:
the window closes at the end of that build, so every build started in it
is counted, with all of its time.  Between builds the harness hashes the
build's 26 letter files, keeps its ``index.mri`` in memory and deletes
its output directory, so no build's writes are flushed under the next;
that time is taken out of the window.  Once the window has closed every
build's letter files are held against the reference's, byte for byte,
and every build's artifact is opened with the port's loader and held
against the reference's index.

On the card ``torch.profiler`` traces the window in every run, traced or
not: the card's busy time per build is ``device_ms_per_build``, and the
window's document bytes over its time ``index_mb_s.build``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import resource
import shutil
import sys
import time
from pathlib import Path

import numpy as np

from portbench import bench, gen
from portbench.reference import letters

#: terms of each build's artifact whose postings are decoded whole: the
#: most frequent, and a sample of the rest drawn from the seed
HEAD_TERMS = 16
SAMPLED_TERMS = 1024

#: the order in which the port's build plans run their phases (the
#: ``--stats`` dict comes with its keys sorted), for naming idle time
PHASE_ORDER = ("load", "tokenize", "feed", "stream", "stream_feed", "tokenize_feed",
               "finalize_vocab", "ingest_scan", "upload", "device_index", "fetch",
               "host_tail", "host_views", "index_emit", "finalize_emit", "emit")


def _build(cli, argv: list[str]) -> tuple[int, dict | None]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


def _phase_label(builds: list[dict]):
    """What the host was doing at a wall-clock instant: the phase of the
    build then running (phases laid end to end back from its end)."""

    def label(t: float) -> str:
        for b in builds:
            if b["wall"][0] <= t < b["wall"][1]:
                stats = b["stats"] or {}
                phases = stats.get("phases_ms", {})
                names = sorted(phases, key=lambda n: (PHASE_ORDER.index(n)
                                                      if n in PHASE_ORDER else len(PHASE_ORDER), n))
                at = b["wall"][1] - sum(phases.values()) / 1e3
                if t < at:
                    return "cli: manifest and set-up of a build"
                for n in names:
                    at += phases[n] / 1e3
                    if t < at:
                        return f"phase {n}"
                return "cli: after the last phase"
        return "harness: checks between builds"

    return label


def _cpu_s() -> tuple[float, float]:
    """This process's user and system CPU seconds, every thread."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime


def _keep(out: Path) -> dict:
    """What the comparison needs of a build's output directory, which is
    then deleted: each letter file's digest and the artifact's bytes."""
    digests = []
    for i in range(26):
        p = out / f"{chr(ord('a') + i)}.txt"
        digests.append(hashlib.sha256(p.read_bytes()).digest() if p.exists() else None)
    mri = out / "index.mri"
    kept = {"digests": digests, "artifact": mri.read_bytes() if mri.exists() else None,
            "bytes": bench.bytes_under(out) if out.exists() else 0}
    shutil.rmtree(out, ignore_errors=True)
    return kept


def sample_terms(ix: letters.Index, seed: int) -> np.ndarray:
    """The head terms by document frequency and a sample drawn from the seed."""
    head = np.argsort(-ix.df, kind="stable")[:HEAD_TERMS]
    rng = np.random.default_rng([seed, 3])
    rest = rng.choice(len(ix.words), min(SAMPLED_TERMS, len(ix.words)), replace=False)
    return np.unique(np.concatenate([head, rest]))


def artifact_wrong(path: Path | None, ix: letters.Index, ndocs: int,
                   sample: np.ndarray) -> tuple[int, int]:
    """``(terms, documents)`` that the artifact at ``path`` gets wrong
    against the reference index ``ix`` of ``ndocs`` documents.  Of every
    term: its word, its document frequency, its place in the emit order
    (letter, df descending, word), and the first and last doc id of each
    block of its postings (the v2 formats' blocks); of the terms in
    ``sample`` the postings decoded whole and their term frequencies,
    each 1 (a build packs no tf).  Of every document: its length, the
    number of its distinct words (the sum of its tf).  An artifact that
    is missing or does not load gets every term and document wrong."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        artifact)

    V = len(ix.words)
    if path is None:
        return V, ndocs
    try:
        art = artifact.load_artifact(path)
    except artifact.ArtifactError:
        return V, ndocs
    with art:
        if art.vocab != V:
            return max(V, art.vocab), ndocs
        lens = np.diff(art.term_offsets)
        bad = (artifact.term_table(art)[1] != np.array(ix.words, dtype="S")) \
            | (lens != np.array([len(w) for w in ix.words])) | (art.df != ix.df)
        first_letter = np.array([w[0] for w in ix.words])
        order = np.lexsort((np.arange(V), -ix.df, first_letter))
        bad[order[art.df_order != order]] = True
        ok = np.nonzero(~bad)[0]
        B = art.block_size
        bpt = -(-ix.df[ok] // B)
        rank = np.arange(int(bpt.sum())) - np.repeat(np.cumsum(bpt) - bpt, bpt)
        blk = np.repeat(art.term_block_off[ok], bpt) + rank
        lo = np.repeat(ix.offsets[ok], bpt) + rank * B
        hi = np.minimum(lo + B, np.repeat(ix.offsets[ok + 1], bpt)) - 1
        wrong = (art.blk_first[blk] != ix.docs[lo]) | (art.blk_max[blk] != ix.docs[hi])
        bad[np.repeat(ok, bpt)[wrong]] = True
        for t in sample[~bad[sample]].tolist():
            want = ix.docs[ix.offsets[t]:ix.offsets[t + 1]]
            got_docs, got_tf = art.decode_postings(t), art.decode_tf(t)
            bad[t] = len(got_docs) != len(want) or (got_docs != want).any() \
                or (got_tf != 1).any()
        want_lens = np.bincount(ix.docs, minlength=ndocs + 1)
        if len(art.doc_lens) != len(want_lens):
            wrong_docs = ndocs
        else:
            wrong_docs = int((art.doc_lens[1:] != want_lens[1:]).sum())
        return int(bad.sum()), wrong_docs


def run(c: dict, *, seed: int, seconds: float, trace: bool, device: str, t0: float) -> dict:
    import torch

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
        cli, native, write_manifest)

    cfg = c["config_params"]
    rd = bench.run_dir(c["name"])
    corpus = gen.corpus(cfg, seed)
    paths = gen.write_files(corpus, rd / "docs")
    list_path = rd / "list.txt"
    write_manifest(list_path, paths)
    os.sync()
    argv = [str(cfg["mappers"]), str(cfg["reducers"]), str(list_path), *c["mix"]["argv"],
            "--device", device, "--stats"]
    t = time.monotonic()
    native.load()
    compile_s = time.monotonic() - t
    rc, _ = _build(cli, [*argv, "--output-dir", str(rd / "warm")])
    if rc != 0:
        raise SystemExit(f"portbench: the warm-up build exited {rc}")
    shutil.rmtree(rd / "warm")
    os.sync()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t0

    builds: list[dict] = []
    checks_s = 0.0
    prof = bench.Profile(torch, rd) if device == "cuda" else None
    with prof or contextlib.nullcontext():
        w0 = time.perf_counter()
        wall0 = time.time()
        while True:
            wb0, c0 = time.time(), _cpu_s()
            out = rd / "out"
            rc, stats = _build(cli, [*argv, "--output-dir", str(out)])
            wb1, c1 = time.time(), _cpu_s()
            k0 = time.perf_counter()
            builds.append({"rc": rc, "stats": stats, "wall": (wb0, wb1),
                           "user_s": c1[0] - c0[0], "sys_s": c1[1] - c0[1], **_keep(out)})
            checks_s += time.perf_counter() - k0
            if time.perf_counter() - w0 - checks_s >= seconds:
                break
        traced_s = time.perf_counter() - w0
        window_s = traced_s - checks_s
        wall1 = time.time()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    dev = prof.read() if prof else None

    t = time.monotonic()
    ix = letters.index(corpus.buf, corpus.starts, corpus.stops, device=device)
    want = [hashlib.sha256(f).digest() for f in letters.letter_files(ix)]
    sample = sample_terms(ix, seed)
    wrong_files = wrong_terms = wrong_docs = failed = 0
    for i, b in enumerate(builds):
        ok = b["rc"] == 0 and b["stats"] is not None \
            and not b["stats"]["degradation"]["skipped_docs"] \
            and b["stats"]["documents"] == len(corpus)
        failed += not ok
        wrong_files += sum(g != w for g, w in zip(b["digests"], want))
        path = None
        if b["artifact"] is not None:
            path = rd / "artifacts" / f"{i}.mri"
            path.parent.mkdir(exist_ok=True)
            path.write_bytes(b["artifact"])
        terms, docs = artifact_wrong(path, ix, len(corpus), sample)
        wrong_terms += terms
        wrong_docs += docs
    reference_s = time.monotonic() - t
    written = corpus.total_bytes + sum(b["bytes"] for b in builds)
    shutil.rmtree(rd)
    done = sum(1 for b in builds if b["rc"] == 0)
    for i, b in enumerate(builds):
        phases = (b["stats"] or {}).get("phases_ms", {})
        print(f"portbench: build {i}: {b['wall'][1] - b['wall'][0]:.3f} s, cpu user "
              f"{b['user_s']:.3f} s and system {b['sys_s']:.3f} s, the port's "
              f"total_ms {(b['stats'] or {}).get('total_ms')}, phases_ms {json.dumps(phases)}",
              file=sys.stderr)
    print(f"portbench: {len(builds)} builds, {corpus.total_bytes} document bytes each, "
          f"window {window_s:.3f} s (checks between builds {checks_s:.3f} s taken out), "
          f"compile {compile_s:.3f} s, reference and comparison {reference_s:.3f} s, "
          f"{written} bytes written (the corpus and each build's output; the warm-up build "
          "not counted)", file=sys.stderr)

    busy_s = dev["busy_s"] if dev else None
    if busy_s:
        print(f"portbench: device {busy_s:.6f} s busy over {len(builds)} builds, index_mb_s.build "
              f"{done * corpus.total_bytes / 1e6 / window_s:.4f}", file=sys.stderr)
    record = {"builds": [b["stats"] for b in builds if b["stats"]], "window_s": window_s,
              "corpus_bytes": corpus.total_bytes, "unique_pairs": ix.unique_pairs,
              "peak_window_bytes": peak, "device_kind": (torch.cuda.get_device_name(0)
                                                         if device == "cuda" else None),
              "busy_s": busy_s, "traced_s": traced_s}
    result = {
        "setup_s": setup_s, "compile_s": compile_s, "attempted": len(builds), "failed": failed,
        "e2e": {"device_ms_per_build": 1e3 * busy_s / len(builds) if busy_s else None,
                "setup_s": setup_s},
        "record": record, "window_s": traced_s, "memory_peak": peak,
        "numbers": {"wrong_letter_files": wrong_files, "wrong_artifact_terms": wrong_terms,
                    "wrong_artifact_doc_lens": wrong_docs, "failed_builds": failed},
    }
    if dev and trace:
        result["busy_s"] = busy_s or 0.0
        result["breakdown"] = bench.breakdown(
            dev, bench.idle_gaps(dev["intervals"], wall0, wall1, _phase_label(builds)))
    return result


def control(c: dict, *, seed: int, seconds: float, device: str) -> dict:
    """The control's numbers for one build of the cell's corpus: the
    reference without its per-document dedup in the program's place, its
    index standing for the artifact too."""
    corpus = gen.corpus(c["config_params"], seed)
    ix = letters.index(corpus.buf, corpus.starts, corpus.stops, device=device)
    ctl = letters.index(corpus.buf, corpus.starts, corpus.stops, dedup=False, device=device)
    want, got = letters.letter_files(ix), letters.letter_files(ctl)
    lens = np.bincount(ix.docs, minlength=len(corpus) + 1)
    ctl_lens = np.bincount(ctl.docs, minlength=len(corpus) + 1)
    return {"wrong_letter_files": sum(a != b for a, b in zip(got, want)),
            "wrong_artifact_terms": int((ctl.df != ix.df).sum()),
            "wrong_artifact_doc_lens": int((ctl_lens != lens).sum()), "failed_builds": 0}
