"""Shard-side engine: a plain artifact serving its slice of a cluster.

A shard directory is an ordinary single-artifact build of the docs the
partition tool assigned it, plus a ``cluster_shard.json`` sidecar
holding everything the shard needs to answer *as if it were the whole
corpus*:

* ``gids`` — the ascending global doc id of every local doc (local id
  ``i`` ↔ ``gids[i-1]``).  Both assignment modes write ascending
  lists, so the local→global map is monotone: ascending local postings
  stay ascending, and the single-engine ``(-score, doc_id)`` tie order
  is preserved through the map.
* ``ndocs`` / ``avgdl`` — the GLOBAL corpus stats, computed by the
  partition tool exactly the way :func:`~..serve.artifact.bm25_corpus`
  computes them for a monolithic build (same float64 array, same
  ``mean()``), so they are bit-equal to the from-scratch values.
* ``global_df`` — the global document frequency of every term this
  shard stores (docs live in exactly one shard, so the global df is
  the plain integer sum of the per-shard dfs).

:class:`ShardEngine` wraps the unchanged single-artifact
:class:`~..serve.engine.Engine`, injects the global stats through
``set_corpus_override`` — the same seam the multi-segment engine uses —
and maps doc ids on the way out.  The scatter-gather router therefore
carries NO per-shard state: shards answer in global ids with global
BM25 floats already bit-identical to a monolithic build, and the
router only sums (df), merges (postings/AND/OR), or heap-merges
(ranked) the parts.

``df`` and letter ``top_k`` stay LOCAL on purpose: their global
answers need cross-shard aggregation (sum, threshold refinement) that
only the router can do.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..serve import artifact as artifact_mod
from ..serve import engine as engine_mod
from . import SIDECAR_NAME


def sidecar_path(path) -> Path:
    p = Path(path)
    if p.is_dir():
        return p / SIDECAR_NAME
    return p.parent / SIDECAR_NAME


def has_sidecar(path) -> bool:
    """Cheap create_engine routing probe (no JSON parse)."""
    return os.path.exists(sidecar_path(path))


def load_sidecar(path) -> dict:
    """Parse + structurally validate one shard sidecar."""
    sp = sidecar_path(path)
    try:
        doc = json.loads(sp.read_text(encoding="utf-8"))
    except OSError as e:
        raise artifact_mod.ArtifactError(
            f"{sp}: cannot read shard sidecar ({e})") from e
    except ValueError as e:
        raise artifact_mod.ArtifactError(
            f"{sp}: shard sidecar is not valid JSON ({e})") from e
    try:
        gids = np.asarray(doc["gids"], dtype=np.int64)
        out = {
            "shard": int(doc["shard"]),
            "shards": int(doc["shards"]),
            "mode": str(doc.get("mode", "round-robin")),
            "gids": gids,
            "total_docs": int(doc["total_docs"]),
            "ndocs": int(doc["ndocs"]),
            "avgdl": float(doc["avgdl"]),
            "global_df": {k.encode("ascii"): int(v)
                          for k, v in doc["global_df"].items()},
        }
    except (KeyError, TypeError, ValueError) as e:
        raise artifact_mod.ArtifactError(
            f"{sp}: malformed shard sidecar ({e})") from e
    if len(gids) and not (np.diff(gids) > 0).all():
        raise artifact_mod.ArtifactError(
            f"{sp}: sidecar gid map is not strictly ascending — the "
            "local→global doc map must be monotone")
    return out


class ShardEngine:
    """One cluster shard's engine: local artifact, global answers.

    Wraps the single-artifact :class:`~..serve.engine.Engine` (every
    unlisted attribute delegates to it — metrics, planner, caches,
    encode/lookup all behave identically) and overrides exactly the
    ops whose answers leave the process:

    * ``postings`` / ``query_and`` / ``query_or`` — local doc ids map
      through the monotone gid table.
    * ``top_k_scored`` / ``top_k_scored_batch`` — ranked answers carry
      global ids; scores are already global via the corpus override.
    * ``df`` / ``top_k`` — intentionally LOCAL (router aggregates).
    """

    engine_name = "shard"

    def __init__(self, path, cache_terms: int = 4096):
        self.info = load_sidecar(path)
        self._base = engine_mod.Engine(path, cache_terms=cache_terms)
        try:
            self._gids = self.info["gids"]
            # max_doc_id can trail len(gids) when tail docs are empty
            # (they never enter a posting); it may never exceed it
            docs = int(self._base.artifact.max_doc_id)
            if docs > len(self._gids):
                raise artifact_mod.ArtifactError(
                    f"{sidecar_path(path)}: sidecar maps "
                    f"{len(self._gids)} docs but the artifact "
                    f"references doc id {docs} — rebuild the shard "
                    "(mri-torch shard)")
            self._gdf = self.info["global_df"]
            self._base.set_corpus_override(
                self.info["ndocs"], self.info["avgdl"], self._df_fn)
        except BaseException:
            self._base.close()
            raise

    def _df_fn(self, idx: int) -> int:
        """Global scoring df for local lex index ``idx`` (strict: a
        term missing from the sidecar means the sidecar predates the
        artifact — fail loudly rather than serve divergent floats)."""
        term = self._base.artifact.term(int(idx))
        try:
            return self._gdf[term]
        except KeyError:
            raise artifact_mod.ArtifactError(
                f"shard sidecar has no global df for term "
                f"{term!r} — sidecar/artifact mismatch") from None

    def _to_global(self, docs: np.ndarray) -> np.ndarray:
        """Monotone local→global map; preserves ascending order."""
        if not len(docs):
            return np.zeros(0, dtype=np.int32)
        return self._gids[
            np.asarray(docs, dtype=np.int64) - 1].astype(np.int32)

    # -- ops with globally-visible doc ids ------------------------------

    def postings(self, batch):
        return [self._to_global(r) if r is not None else None
                for r in self._base.postings(batch)]

    def query_and(self, batch) -> np.ndarray:
        return self._to_global(self._base.query_and(batch))

    def query_or(self, batch) -> np.ndarray:
        return self._to_global(self._base.query_or(batch))

    def top_k_scored(self, batch, k: int):
        return [(int(self._gids[d - 1]), s)
                for d, s in self._base.top_k_scored(batch, k)]

    def top_k_scored_batch(self, batches, k: int):
        return [[(int(self._gids[d - 1]), s) for d, s in res]
                for res in self._base.top_k_scored_batch(batches, k)]

    # -- bookkeeping ----------------------------------------------------

    def bm25_stats(self) -> tuple[int, float]:
        """Global ``(ndocs, avgdl)`` every shard scores with."""
        return self.info["ndocs"], self.info["avgdl"]

    def describe(self) -> dict:
        out = self._base.describe()
        out["engine"] = self.engine_name
        out["cluster"] = {
            "shard": self.info["shard"],
            "shards": self.info["shards"],
            "mode": self.info["mode"],
            "local_docs": len(self._gids),
            "total_docs": self.info["total_docs"],
            "ndocs": self.info["ndocs"],
            "avgdl": self.info["avgdl"],
        }
        return out

    def close(self) -> None:
        self._base.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getattr__(self, name):
        # everything else (df, top_k, encode_batch, lookup, metrics,
        # planner, caches, artifact, ...) is the base engine's
        return getattr(self._base, name)
