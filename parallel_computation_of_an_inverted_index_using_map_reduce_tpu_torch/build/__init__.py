"""Out-of-core build tier: spill-run files + streaming shard merge.

:mod:`.spill` owns the on-disk format (checksummed section files,
atomic writes, quarantine); :mod:`.ooc` owns the numpy merge / emit /
artifact assembly over those files.  The scan/reduce orchestration
lives in ``models/inverted_index.py::_run_cpu_parallel`` — it routes
here when ``MRI_BUILD_SPILL_BYTES`` is set.
"""

from . import ooc, spill  # noqa: F401
