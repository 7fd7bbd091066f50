"""Query planner: picks the evaluation strategy per query (the JAX
package's ``serve/planner.py``).

Ranked (BM25 top-k) queries choose between exhaustive scoring and the
two dynamic-pruning disciplines the v2.1 per-block max-score columns
enable: **MaxScore** (a term whose bounds cannot reach the threshold is
dropped whole) and **Block-Max WAND** (a block whose bound cannot reach
it is never decoded).  The host engine's AND steps choose between the
galloping ``searchsorted`` probe, a linear merge and the native kernel.
Every decision and its block economy is counted on the engine's
registry, so ``describe()`` shows what the planner did.
"""

from __future__ import annotations

import os

import numpy as np

from ..obs import attribution as obs_attrib
from ..utils import envknobs

PLANNER_ENV = "MRI_SERVE_PLANNER"
PLANNER_CHOICES = ("auto", "exhaustive", "bmw", "maxscore")

#: Relative slack on every theta comparison of the host path: the pruned
#: evaluators add the exhaustive scorer's float64 contributions in
#: bound order, and one part in 1e9 absorbs that associativity drift,
#: so a candidate on the threshold is never pruned.
THETA_MARGIN = 1.0 - 1e-9

#: The same slack for the device path, whose scores are float32.
DEVICE_MARGIN = 1.0 - 1e-5


def resolve_planner(mode: str | None = None) -> str:
    """Explicit mode, else ``$MRI_SERVE_PLANNER`` (default auto)."""
    mode = mode or envknobs.get(PLANNER_ENV)
    if mode not in PLANNER_CHOICES:
        raise ValueError(f"unknown planner {mode!r} (choices: {PLANNER_CHOICES})")
    return mode


def block_upper_bounds(art, idx: int, idf: float, avgdl: float,
                       k1: float, b: float) -> np.ndarray:
    """Per-block BM25 upper bounds of term ``idx`` (float64), from the
    saturating ``blk_max_tf`` / ``blk_min_dl`` columns: BM25 grows with
    tf and falls with doc length, so (max tf, min dl) bounds every doc of
    the block; a saturated max-tf cell takes the tf -> inf limit."""
    b0 = int(art.term_block_off[idx])
    b1 = int(art.term_block_off[idx + 1])
    cap = (1 << art.score_bits) - 1
    mtf = art.blk_max_tf[b0:b1].astype(np.float64)
    mdl = art.blk_min_dl[b0:b1].astype(np.float64)
    denom = mtf + k1 * (1.0 - b + b * mdl / avgdl)
    ub = idf * mtf * (k1 + 1.0) / denom
    return np.where(mtf >= cap, idf * (k1 + 1.0), ub)


class Planner:
    """Per-engine strategy picker with decision and block counters on
    the engine's registry; ``last_ranked`` keeps the latest decision."""

    def __init__(self, registry):
        self._c_ranked = {m: registry.counter(f"mri_planner_ranked_{m}_total")
                          for m in ("exhaustive", "bmw", "maxscore")}
        self._c_and = {m: registry.counter(f"mri_planner_and_{m}_total")
                       for m in ("gallop", "merge", "native")}
        self._c_scored = registry.counter("mri_planner_blocks_scored_total")
        self._c_skipped = registry.counter("mri_planner_blocks_skipped_total")
        self.last_ranked: dict | None = None
        self._raw_mode: object = -1
        self._resolved_mode = "auto"

    def resolve_cached(self) -> str:
        """:func:`resolve_planner`, re-parsed only when the raw
        ``$MRI_SERVE_PLANNER`` string changes."""
        raw = os.environ.get(PLANNER_ENV)
        if raw != self._raw_mode:
            self._resolved_mode = resolve_planner(None)
            self._raw_mode = raw
        return self._resolved_mode

    def plan_ranked(self, art, dfs, k: int, mode: str | None = None) -> str:
        """The ranked strategy (``mode``, else ``$MRI_SERVE_PLANNER``)
        for a query with term dfs ``dfs`` and cutoff ``k``: pruning needs
        the v2.1 columns and a cutoff that can drop something; ``auto``
        takes Block-Max WAND on long lists and MaxScore on short ones."""
        mode = self.resolve_cached() if mode is None else resolve_planner(mode)
        if not art.has_block_scores or k <= 0 or not dfs or k >= sum(dfs):
            return "exhaustive"
        if mode == "auto":
            mode = "bmw" if max(dfs) > 4 * art.block_size else "maxscore"
        return mode

    def plan_and(self, n_acc: int, df: int, native: bool = False) -> str:
        """Gallop (probe the partner run at the surviving candidates) or
        merge (a linear sorted-set intersection) for one AND step: merge
        when the runs are comparable.  With ``native`` the C kernel
        (block-max skips fused with in-block galloping) takes the gallop
        arm's territory."""
        mode = "merge" if df <= 2 * n_acc else "gallop"
        if native and mode == "gallop":
            mode = "native"
        self._c_and[mode].inc()
        coll = obs_attrib.active()
        if coll is not None:
            coll.and_arm(mode)
        return mode

    def note_ranked(self, mode: str, scored: int, skipped: int,
                    candidates: int, backend: str = "numpy") -> None:
        """Record one ranked query's decision and block economy;
        ``backend`` names who ran the plan (numpy, native, or torch for
        the device engine, which keeps no candidate set)."""
        self._c_ranked[mode].inc()
        if scored:
            self._c_scored.inc(scored)
        if skipped:
            self._c_skipped.inc(skipped)
        coll = obs_attrib.active()
        if coll is not None:
            coll.ranked(f"{mode}/native" if backend == "native" else mode,
                        scored, skipped, candidates)
        self.last_ranked = {"mode": mode, "backend": backend, "blocks_scored": scored,
                            "blocks_skipped": skipped, "candidates": candidates}

    def note_ranked_batch(self, counts: dict, last_mode: str, scored: int,
                          skipped: int, candidates: int,
                          backend: str = "native") -> None:
        """One coalesced ranked batch: each mode's counter advances by
        the queries that ran it (``counts``: mode -> queries), so the
        totals match the per-query path, and the batch's summed block
        economy lands once; ``last_ranked`` holds the last query's mode
        with the batch's sums."""
        for m, c in counts.items():
            self._c_ranked[m].inc(c)
        if scored:
            self._c_scored.inc(scored)
        if skipped:
            self._c_skipped.inc(skipped)
        self.last_ranked = {"mode": last_mode, "backend": backend, "blocks_scored": scored,
                            "blocks_skipped": skipped, "candidates": candidates}

    def describe(self) -> dict:
        return {
            "mode": envknobs.get(PLANNER_ENV),
            "ranked": {m: c.value for m, c in self._c_ranked.items()},
            "and": {m: c.value for m, c in self._c_and.items()},
            "blocks_scored": self._c_scored.value,
            "blocks_skipped": self._c_skipped.value,
            "last_ranked": self.last_ranked,
        }
