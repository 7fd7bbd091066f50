"""Scale-out serving: doc-sharded cluster with a scatter-gather router.

The reference paper's whole design is partitioned parallelism —
mappers split the corpus, reducers own disjoint key ranges — and this
package applies the same shape to the serving tier (the "Sorting,
Searching, and Simulation in the MapReduce Framework" simulation
argument, PAPERS.md): partition the corpus into D doc-shards, each its
own ``serve`` daemon over a plain artifact dir plus a
``cluster_shard.json`` sidecar, and run a router process that speaks
the identical JSON-lines protocol — scatter every data op to all
shards, gather with the same D-way merges
:class:`~..serve.multi_engine.MultiSegmentEngine` uses, stretched over
TCP.

Layout:

* :mod:`.partition` — ``shard``: doc assignment (round-robin /
  size-balanced), per-shard artifact builds, global BM25 stats, and
  the byte-verified manifests.
* :mod:`.shard` — the sidecar + :class:`~.shard.ShardEngine` wrapper a
  shard daemon serves through (global doc ids + injected global
  stats, so shard answers need no router-side remapping).
* :mod:`.pool` — persistent pipelined per-replica connections,
  health-probe state, and per-shard replica failover.
* :mod:`.hedge` — the hedging clock (fire a duplicate RPC after
  ``MRI_CLUSTER_HEDGE_MS`` or the shard's rolling p95).
* :mod:`.router` — the ``router`` daemon: admission, scatter,
  gather, fleet health, merged scrapes.

This is the JAX package's ``cluster/``: like it, every module runs on
the host (shards build with the host backend and serve through the host
engine), its cluster directories are byte-equal to the JAX package's,
and its router and shard daemons speak the same wire protocol, so each
package's router serves the other's shards.
"""

from __future__ import annotations

SIDECAR_NAME = "cluster_shard.json"
CLUSTER_MANIFEST = "cluster.json"

__all__ = ["SIDECAR_NAME", "CLUSTER_MANIFEST"]
