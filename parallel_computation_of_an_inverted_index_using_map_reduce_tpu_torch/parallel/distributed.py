"""Multi-process runtime seam over ``torch.distributed``.

The reference is strictly single-process (SURVEY.md §4: "no multi-node
story at all").  The builds of this package drive every shard from one
process (parallel/mesh.py); this module is the thin seam a
multi-process run would join through, with the JAX package's
``runtime_info`` keys.  Nothing in the build calls it yet.
"""

from __future__ import annotations

import torch


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or start) a process group: NCCL when a card is visible,
    else gloo.  ``coordinator_address`` is ``host:port`` (or any
    ``init_method`` URL); with no arguments the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` environment is read."""
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def runtime_info() -> dict:
    """Structured view of the topology for logs and metrics; process 0
    of 1 when no process group was joined."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if joined else 1
    cuda = torch.cuda.is_available()
    local = torch.cuda.device_count() if cuda else 1
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
        "platform": "gpu" if cuda else "cpu",
    }
