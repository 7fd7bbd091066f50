"""The multi-shard build: a single-controller mesh of logical shards.

One Python process drives every shard, as the JAX package's
``shard_map`` programs do: a per-shard body becomes a plain function
called in a loop over the shards, and each collective (``all_to_all``,
``psum``, ``pmax``, :mod:`.mesh`) is called between two such loops.
Shards are placed round-robin on the visible cards, so N shards run on
one card as well as on N.
"""
