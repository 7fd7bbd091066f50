"""The multi-shard build: a mesh of logical shards.

With no process group, one Python process drives every shard, as the
JAX package's single-controller ``shard_map`` programs do: a per-shard
body becomes a plain function called in a loop over the shards, and
each collective (``all_to_all``, ``psum``, ``pmax``, :mod:`.mesh`) is
called between two such loops.  Shards are placed round-robin on the
visible cards, so N shards run on one card as well as on N.  After
:func:`.distributed.initialize`, the same library calls run in every
process of the group, each looping over its own block of shards, with
the collectives crossing the processes (the JAX package's
multi-controller runs).
"""
