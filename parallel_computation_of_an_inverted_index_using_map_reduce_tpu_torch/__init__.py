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
  OR / top-k / BM25 queries from the artifact's columns on the card
  (``query DIR`` on the CLI)

It imports torch and numpy, never jax and nothing of the JAX package.
"""

__version__ = "0.1.0"

from .config import IndexConfig
from .corpus.manifest import Manifest, read_manifest, write_manifest, manifest_from_dir
from .text.tokenizer import TokenizedCorpus, clean_token
from .models.inverted_index import InvertedIndexModel, build_index
from .models.oracle import oracle_index

__all__ = [
    "IndexConfig",
    "Manifest",
    "read_manifest",
    "write_manifest",
    "manifest_from_dir",
    "TokenizedCorpus",
    "clean_token",
    "InvertedIndexModel",
    "build_index",
    "oracle_index",
    "__version__",
]
