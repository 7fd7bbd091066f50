"""Inverted-index MapReduce on an NVIDIA GPU, in PyTorch and CUDA.

A port of the JAX package
``parallel_computation_of_an_inverted_index_using_map_reduce_tpu`` (kept
beside it as the reference), for its single-device build plans:

- host frontend: corpus manifest, then the native C++ scan
  (``native/``, the map phase with its per-(term, doc) combiner,
  main.c:85-124) or the vectorized numpy tokenizer
- device engine, by one of four plans (models/inverted_index.py):
  the pipelined plan (the default) uploads provisional-key windows
  while the scan runs and finalizes with one ``torch.sort``; the
  one-shot plan sorts packed (term, doc) pairs, dedups through the
  ``unique_mask_count`` CUDA kernel when the feed still holds
  duplicates, and derives run-edge document frequency, rank-scatter
  postings and the emit order (reference reduce phase,
  main.c:126-242), with ``--skew`` adding the ``bucket_histogram`` CUDA
  kernel; the streaming plan (``--stream-chunk-docs``) folds document
  windows into a bounded sorted accumulator on the card; the all-device
  plan (``--device-tokenize``) runs the whole map phase on the card
  from the raw bytes (ops/device_tokenizer.py)
- host emit: byte-identical ``<letter>.txt`` postings files, native or
  Python (format of main.c:227-234), and with ``--artifact`` the
  ``index.mri`` serving artifact (``serve/artifact.py``)
- serving: ``serve.DeviceEngine`` answers batched df / postings / AND /
  OR / top-k / BM25 queries from the artifact's columns on the card, its
  batches split over logical shards (``query DIR`` on the CLI), and the
  resident daemon ``serve.daemon.ServeDaemon`` serves them over a
  JSON-lines protocol with admission control, coalescing, a result
  cache, hot reload and the ``obs/`` layers (``serve DIR``, ``metrics``,
  ``flightdump``, ``top``)

- host backend (``backend="cpu"``): the whole build on the host in
  native C++, K scan workers pulling byte windows from a steal queue and
  M letter reducers over one merge (the reference's fork-join regime),
  with an out-of-core spill tier; no card
- the live index (``segments/``: immutable segments, tombstones, a
  WAL, compaction and replicas) and the doc-sharded cluster
  (``cluster/``: ``shard`` partitions a corpus into shard directories
  with global BM25 stats, ``router`` scatters the daemon's protocol over
  shard daemons and gathers exact answers), host code as in the JAX
  package

It imports torch and numpy, never jax and nothing of the JAX package.
"""

__version__ = "0.1.0"

from .config import IndexConfig
from .corpus.manifest import Manifest, read_manifest, write_manifest, manifest_from_dir
from .text.tokenizer import TokenizedCorpus, tokenize_corpus, clean_token
from .models.inverted_index import InvertedIndexModel, build_index
from .models.oracle import oracle_index

__all__ = [
    "IndexConfig",
    "Manifest",
    "read_manifest",
    "write_manifest",
    "manifest_from_dir",
    "TokenizedCorpus",
    "tokenize_corpus",
    "clean_token",
    "InvertedIndexModel",
    "build_index",
    "oracle_index",
    "__version__",
]
