"""Read side of the index: the ``index.mri`` serving artifact and the
device query engine over it.

:mod:`~.artifact` packs the compact, memory-mappable columnar artifact
at emit time (``--artifact``) and reads it back verified;
:mod:`~.device_engine` uploads its columns to the card once and answers
batched df / postings / AND / OR / top-k / BM25 queries there
(``query DIR``, the port's CLI).  Both are the JAX package's
``serve/`` on torch, byte-compatible with it.
"""

from .artifact import ARTIFACT_NAME, ArtifactError, artifact_path, load_artifact
from .device_engine import DeviceEngine

__all__ = ["ARTIFACT_NAME", "ArtifactError", "DeviceEngine", "artifact_path",
           "load_artifact"]
