"""The shard mesh and its collectives.

The reference's "mesh" is N pthreads in one address space
(main.c:348-384).  Here it is N logical shards driven by one process:
shard ``i`` lives on ``cuda:(i % cards)`` (several shards share a card
when there are fewer cards than shards) or on the CPU.  A per-shard
program is a function called once per shard; the collectives below
take the per-shard list of tensors and return what every shard of a
``shard_map`` body would see:

- :func:`all_to_all` — row ``d`` of shard ``s``'s ``(n, m)`` send
  buffer goes to shard ``d``, which receives the rows of every source
  in source order (``lax.all_to_all(x, axis, 0, 0, tiled=True)``);
- :func:`psum`, :func:`pmax` — one reduced value, on shard 0's device.

Nothing here waits for a card: copies between cards are queued like
any other work, so shards on different cards overlap.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.engine import upload

SHARD_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the device of each logical shard, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_shards: int, device: str = "cuda") -> Mesh:
    """``num_shards`` logical shards on ``device`` ("cuda" or "cpu").

    On "cuda" shard ``i`` goes on ``cuda:(i % torch.cuda.device_count())``;
    with no card it raises, never falling back to the CPU.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if device == "cuda":
        if not torch.cuda.is_available():
            from ..models.inverted_index import DeviceUnavailable

            raise DeviceUnavailable(
                "a mesh on device='cuda' but torch sees no CUDA device; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        cards = torch.cuda.device_count()
        return Mesh(tuple(torch.device("cuda", i % cards) for i in range(num_shards)))
    if device == "cpu":
        return Mesh((torch.device("cpu"),) * num_shards)
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


# Uploads go through ``engine.upload`` (pinned memory on a card, held in
# ``keep`` when the caller passes a list; torch's caching host allocator
# reuses a dropped pinned block only after its copy has completed).


def shard(host: np.ndarray, mesh: Mesh, keep: list | None = None) -> list[torch.Tensor]:
    """The ``n`` equal contiguous slices of ``host`` in shard order, each
    on its shard's device (``jax.device_put(x, NamedSharding(mesh,
    P(axis)))``).  Each slice is copied into a fresh host array first,
    so no later write to ``host`` can reach a queued copy."""
    n = mesh.size
    if host.shape[0] % n:
        raise ValueError(f"length {host.shape[0]} not divisible by mesh size {n}")
    step = host.shape[0] // n
    keep = [] if keep is None else keep
    return [upload(np.array(host[i * step:(i + 1) * step]), d, keep)
            for i, d in enumerate(mesh.devices)]


def shard_parts(parts, mesh: Mesh, keep: list | None = None) -> list[torch.Tensor]:
    """Per-shard host arrays (one per shard, equal lengths), each copied
    fresh and uploaded to its shard's device."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size}")
    keep = [] if keep is None else keep
    return [upload(np.array(p), d, keep) for p, d in zip(parts, mesh.devices)]


def replicate(host: np.ndarray, mesh: Mesh, keep: list | None = None) -> list[torch.Tensor]:
    """One copy of ``host`` per shard (shards on one device share it)."""
    fresh = np.array(host)
    keep = [] if keep is None else keep
    by_device: dict = {}
    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = upload(fresh, d, keep)
    return [by_device[d] for d in mesh.devices]


def all_to_all(sends: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Tiled all-to-all over per-shard ``(n, m)`` send buffers: shard
    ``d`` receives ``cat([sends[s][d] for s in range(n)])`` (length
    ``n * m``, source-major), on its own device."""
    n = mesh.size
    return [torch.cat([sends[s][d].to(mesh.devices[d], non_blocking=True) for s in range(n)])
            for d in range(n)]


def _reduce(parts, op, mesh: Mesh) -> torch.Tensor:
    dev = mesh.devices[0]
    return functools.reduce(op, (p.to(dev, non_blocking=True) for p in parts))


def psum(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise sum over the shards, on shard 0's device."""
    return _reduce(parts, torch.add, mesh)


def pmax(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise max over the shards, on shard 0's device."""
    return _reduce(parts, torch.maximum, mesh)


def gather_host(parts: list[torch.Tensor], mesh: Mesh) -> np.ndarray:
    """Stack per-shard tensors of one shape and read them on the host:
    one wait for the cards, however many shards."""
    dev = mesh.devices[0]
    return torch.stack([p.to(dev, non_blocking=True) for p in parts]).cpu().numpy()
