"""Read side of the index: the ``index.mri`` serving artifact and the
query engines over it.

:mod:`~.artifact` packs the compact, memory-mappable columnar artifact
at emit time (``--artifact``) and reads it back verified;
:mod:`~.engine` holds the host ``Engine`` (numpy, or the native
``mri_serve_*`` kernels), the crossover router ``AutoEngine`` and
``create_engine``; :mod:`~.device_engine` uploads the columns to the
card once and answers batched df / postings / AND / OR / top-k / BM25
queries there (``query DIR --engine host|device|auto``, the port's
CLI); :mod:`~.daemon` is the resident server over one artifact
(``serve DIR``) with its generation-keyed :mod:`~.result_cache`.  All
of it is the JAX package's ``serve/`` on torch, byte-compatible with it.
"""

from .artifact import ARTIFACT_NAME, ArtifactError, artifact_path, load_artifact
from .device_engine import DeviceEngine
from .engine import AutoEngine, Engine, create_engine

__all__ = ["ARTIFACT_NAME", "ArtifactError", "AutoEngine", "DeviceEngine", "Engine",
           "artifact_path", "create_engine", "load_artifact"]
