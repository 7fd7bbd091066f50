"""``shard``: partition a corpus into D buildable doc-shards.

The partition tool is the cluster's build step: it splits one corpus
manifest into D per-shard manifests, runs the unchanged ``--artifact``
build once per shard, then computes the GLOBAL BM25 statistics and
writes them into each shard's ``cluster_shard.json`` sidecar — after
which every shard daemon answers with global doc ids and globally-
correct BM25 floats (see :mod:`.shard`), and the router stays
stateless about corpus content.

Assignment modes (both produce ascending per-shard gid lists, which
the monotone local→global map in :class:`~.shard.ShardEngine`
requires):

* ``round-robin`` (default) — doc ``g`` (1-based manifest position)
  goes to shard ``(g - 1) % D``; already ascending per shard.
* ``size-balanced`` — greedy LPT over file sizes (largest doc to the
  currently-lightest shard), then each shard's member list is sorted
  ascending before anything is written.

Global-stat computation mirrors
:func:`~..serve.artifact.bm25_corpus` operand for operand: the global
``doc_lens`` float64 array is reassembled from the per-shard doc-length
columns through the gid maps (same values, same ascending-gid order),
so ``ndocs = count_nonzero`` and ``avgdl = mean(doc_lens > 0)`` are
bit-equal to what a from-scratch monolithic build would compute.
Global df is the integer sum of per-shard dfs (every doc lives in
exactly one shard).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..corpus import manifest as corpus_manifest
from ..serve import artifact as artifact_mod
from . import CLUSTER_MANIFEST, SIDECAR_NAME

MODES = ("round-robin", "size-balanced")


class PartitionError(Exception):
    """Bad arguments or a failed/partial partition (CLI exit 2)."""


def shard_dir(out_dir, shard: int) -> Path:
    return Path(out_dir) / f"shard-{shard}"


def assign(paths: list[str], shards: int,
           mode: str = "round-robin") -> list[list[int]]:
    """Per-shard ascending 1-based gid lists covering every doc once."""
    if shards < 1:
        raise PartitionError(f"--shards must be >= 1, got {shards}")
    if mode not in MODES:
        raise PartitionError(
            f"unknown assignment mode {mode!r} (choices: {MODES})")
    if not paths:
        raise PartitionError("source manifest lists no documents")
    if shards > len(paths):
        raise PartitionError(
            f"--shards {shards} exceeds the corpus size ({len(paths)} "
            "docs) — every shard must own at least one document")
    if mode == "round-robin":
        return [list(range(s + 1, len(paths) + 1, shards))
                for s in range(shards)]
    # size-balanced: greedy LPT on byte sizes.  Ties go to the lowest
    # gid / lowest shard index, so the assignment is deterministic.
    sizes = corpus_manifest._stat_sizes(paths)
    order = sorted(range(len(paths)),
                   key=lambda i: (-int(sizes[i]), i))
    load = [0] * shards
    out: list[list[int]] = [[] for _ in range(shards)]
    for i in order:
        s = min(range(shards), key=lambda j: (load[j], j))
        out[s].append(i + 1)
        load[s] += int(sizes[i])
    for member in out:
        member.sort()
    return out


def _manifest_bytes(paths: list[str]) -> bytes:
    """The exact bytes ``write_manifest`` produces for ``paths`` —
    the byte-verification oracle for ``--verify``."""
    import io
    buf = io.StringIO()
    buf.write(f"{len(paths)}\n")
    for p in paths:
        buf.write(f"{p}\n")
    return buf.getvalue().encode("utf-8")


def _build_shard(list_path: Path, out: Path, *, mappers: int,
                 reducers: int) -> dict:
    from .. import IndexConfig, InvertedIndexModel
    return InvertedIndexModel(IndexConfig(
        num_mappers=mappers, num_reducers=reducers, backend="cpu",
        output_dir=str(out), artifact=True)).run(
            corpus_manifest.read_manifest(str(list_path)))


def partition(src_list, shards: int, out_dir, *,
              mode: str = "round-robin", mappers: int = 1,
              reducers: int = 2, progress=None) -> dict:
    """Partition + build + sidecar-stamp a whole cluster directory.

    Returns the top-level cluster manifest (also written to
    ``out_dir/cluster.json``).  Raises :class:`PartitionError` on bad
    arguments and propagates build failures.
    """
    try:
        paths = list(corpus_manifest.read_manifest(str(src_list)).paths)
    except Exception as e:
        raise PartitionError(f"cannot read corpus manifest "
                             f"{src_list}: {e}") from e
    members = assign(paths, shards, mode)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # 1. per-shard manifests + artifact builds (unchanged build path)
    arts = []
    for s, gids in enumerate(members):
        sd = shard_dir(out_dir, s)
        sd.mkdir(parents=True, exist_ok=True)
        list_path = sd / "docs.list"
        list_path.write_bytes(
            _manifest_bytes([paths[g - 1] for g in gids]))
        if progress is not None:
            progress(f"shard {s}: building {len(gids)} docs")
        _build_shard(list_path, sd, mappers=mappers, reducers=reducers)
        arts.append(artifact_mod.load_artifact(sd))

    try:
        # 2. global stats, reassembled exactly as bm25_corpus would
        # see them in a monolithic build of the same manifest
        span = len(paths)
        doc_lens = np.zeros(span + 1, dtype=np.float64)
        gdf: dict[bytes, int] = {}
        for s, (gids, art) in enumerate(zip(members, arts)):
            dl = artifact_mod.bm25_corpus(art)[0]
            g = np.asarray(gids, dtype=np.int64)
            n = min(len(dl) - 1, len(g))
            doc_lens[g[:n]] = dl[1:n + 1]
            df = np.asarray(art.df, dtype=np.int64)
            for i in range(art.vocab):
                t = art.term(i)
                gdf[t] = gdf.get(t, 0) + int(df[i])
        ndocs = int(np.count_nonzero(doc_lens))
        avgdl = float(doc_lens[doc_lens > 0].mean()) if ndocs else 1.0

        # 3. sidecars: each shard gets the stats plus the df of every
        # term IT stores (strict — a missing term at serve time means
        # sidecar/artifact drift and fails loudly)
        for s, (gids, art) in enumerate(zip(members, arts)):
            local_terms = [art.term(i).decode("ascii")
                           for i in range(art.vocab)]
            sidecar = {
                "shard": s,
                "shards": shards,
                "mode": mode,
                "total_docs": span,
                "ndocs": ndocs,
                "avgdl": avgdl,
                "gids": list(gids),
                "global_df": {t: gdf[t.encode("ascii")]
                              for t in local_terms},
            }
            _atomic_json(shard_dir(out_dir, s) / SIDECAR_NAME, sidecar)
    finally:
        for art in arts:
            art.close()

    cluster = {
        "shards": shards,
        "mode": mode,
        "total_docs": len(paths),
        "ndocs": ndocs,
        "avgdl": avgdl,
        "dirs": [f"shard-{s}" for s in range(shards)],
        "source": str(src_list),
    }
    _atomic_json(out_dir / CLUSTER_MANIFEST, cluster)
    return cluster


def _atomic_json(path: Path, doc) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(doc, indent=1) + "\n", encoding="utf-8")
    os.replace(tmp, path)


def verify(src_list, out_dir) -> dict:
    """Byte-verify a partition against its source manifest.

    Recomputes the assignment from ``cluster.json``'s recorded mode and
    checks (a) every per-shard ``docs.list`` matches the recomputed
    serialization BYTE for byte, (b) each sidecar's gid map matches the
    assignment, and (c) the shard gid lists tile ``1..N`` exactly once.
    Raises :class:`PartitionError` on any mismatch; returns a summary.
    """
    out_dir = Path(out_dir)
    try:
        cluster = json.loads(
            (out_dir / CLUSTER_MANIFEST).read_text(encoding="utf-8"))
    except (OSError, ValueError) as e:
        raise PartitionError(
            f"{out_dir}: cannot read {CLUSTER_MANIFEST} ({e})") from e
    try:
        paths = list(corpus_manifest.read_manifest(str(src_list)).paths)
    except Exception as e:
        raise PartitionError(f"cannot read corpus manifest "
                             f"{src_list}: {e}") from e
    shards = int(cluster["shards"])
    members = assign(paths, shards, str(cluster["mode"]))
    seen: set[int] = set()
    for s, gids in enumerate(members):
        sd = shard_dir(out_dir, s)
        want = _manifest_bytes([paths[g - 1] for g in gids])
        try:
            got = (sd / "docs.list").read_bytes()
        except OSError as e:
            raise PartitionError(
                f"shard {s}: missing manifest ({e})") from e
        if got != want:
            raise PartitionError(
                f"shard {s}: docs.list does not byte-match the "
                f"recomputed assignment (corrupt or hand-edited)")
        try:
            sidecar = json.loads(
                (sd / SIDECAR_NAME).read_text(encoding="utf-8"))
        except (OSError, ValueError) as e:
            raise PartitionError(
                f"shard {s}: bad sidecar ({e})") from e
        if [int(g) for g in sidecar.get("gids", [])] != gids:
            raise PartitionError(
                f"shard {s}: sidecar gid map drifted from the "
                "assignment")
        dup = seen.intersection(gids)
        if dup:
            raise PartitionError(
                f"shard {s}: doc ids {sorted(dup)[:5]} appear in more "
                "than one shard")
        seen.update(gids)
    if seen != set(range(1, len(paths) + 1)):
        missing = sorted(set(range(1, len(paths) + 1)) - seen)[:5]
        raise PartitionError(
            f"partition does not cover the corpus (first missing doc "
            f"ids: {missing})")
    return {"shards": shards, "docs": len(paths),
            "mode": cluster["mode"], "verified": True}
