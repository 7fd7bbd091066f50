"""The shard mesh and its collectives.

The reference's "mesh" is N pthreads in one address space
(main.c:348-384).  Here it is a 1-D mesh of N positions (logical
shards).  With no process group joined, one process drives every
position: position ``i`` lives on ``cuda:(i % cards)`` (several share a
card when there are fewer cards than positions) or on the CPU.  Inside
a group of P processes (``parallel/distributed.initialize``), process
``p`` owns the contiguous block ``[p*N/P, (p+1)*N/P)``, as JAX's
``mesh.devices.flat`` order gives, and holds only those positions'
tensors.

A per-shard program is a function called once per local position; the
collectives below take the local positions' tensors and return what
each of them would see in a ``shard_map`` body:

- :func:`all_to_all` — row ``d`` of position ``s``'s ``(n, m)`` send
  buffer goes to position ``d``, which receives the rows of every source
  in source order (``lax.all_to_all(x, axis, 0, 0, tiled=True)``);
  inside a group, the rows for other processes' positions travel in one
  ``all_to_all_single``;
- :func:`psum`, :func:`pmax` — one reduced value, on the first local
  position's device (an ``all_reduce`` inside a group);
- :func:`gather_host` — every position's tensor on the host, the same
  array in every process (an ``all_gather`` inside a group).

Nothing here waits for a card without a group: copies between cards are
queued like any other work, so shards on different cards overlap.  A
gloo group moves host tensors, so its collectives stage through pinned
host memory; the compute stays on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.engine import upload
from . import distributed

SHARD_AXIS = "shards"


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D mesh of ``size`` positions: ``devices`` holds this
    process's positions' devices, in position order from ``first``.
    ``backend`` is the process group's, or None when one process holds
    every position.  ``sent_bytes`` counts what this process sent to
    others through ``all_to_all_single``."""

    devices: tuple[torch.device, ...]
    size: int | None = None
    first: int = 0
    backend: str | None = None
    sent_bytes: int = 0

    def __post_init__(self):
        if self.size is None:
            self.size = len(self.devices)

    @property
    def local_positions(self) -> range:
        """The global positions this process holds."""
        return range(self.first, self.first + len(self.devices))

    @property
    def all_local(self) -> bool:
        """Whether this process holds every position."""
        return len(self.devices) == self.size


def _place(count: int, device: str, local_rank: int = 0, local_count: int = 1):
    if device == "cuda":
        if not torch.cuda.is_available():
            from ..models.inverted_index import DeviceUnavailable

            raise DeviceUnavailable(
                "a mesh on device='cuda' but torch sees no CUDA device; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        cards = distributed.card_block(local_rank, local_count, torch.cuda.device_count())
        return tuple(torch.device("cuda", cards[i % len(cards)]) for i in range(count))
    if device == "cpu":
        return (torch.device("cpu"),) * count
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def make_mesh(num_shards: int, device: str = "cuda") -> Mesh:
    """A mesh of ``num_shards`` positions on ``device`` ("cuda" or "cpu").

    With no process group, every position is local and position ``i``
    goes on ``cuda:(i % torch.cuda.device_count())``.  Inside a group of
    P processes this process holds its block of ``num_shards / P``
    positions (P must divide ``num_shards``), placed round-robin on its
    own cards (``distributed.card_block``).  On "cuda" with no card it
    raises, never falling back to the CPU.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    topo = distributed.topology()
    if topo is None:
        return Mesh(_place(num_shards, device))
    if num_shards % topo.world:
        raise ValueError(f"a mesh of {num_shards} positions cannot be split over "
                         f"{topo.world} processes")
    local = num_shards // topo.world
    return Mesh(_place(local, device, topo.local_rank, topo.local_count), num_shards,
                topo.rank * local, topo.backend)


def local_mesh(num_shards: int, device: str = "cuda") -> Mesh:
    """A mesh whose positions are all this process's, in a group or not
    (the serving engine's batch mesh)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return Mesh(_place(num_shards, device))


# Uploads go through ``engine.upload`` (pinned memory on a card, held in
# ``keep`` when the caller passes a list; torch's caching host allocator
# reuses a dropped pinned block only after its copy has completed).


def shard(host: np.ndarray, mesh: Mesh, keep: list | None = None) -> list[torch.Tensor]:
    """This process's slices of the ``size`` equal contiguous slices of
    ``host``, each on its position's device (``jax.device_put(x,
    NamedSharding(mesh, P(axis)))``).  Each slice is copied into a fresh
    host array first, so no later write to ``host`` can reach a queued
    copy."""
    n = mesh.size
    if host.shape[0] % n:
        raise ValueError(f"length {host.shape[0]} not divisible by mesh size {n}")
    step = host.shape[0] // n
    keep = [] if keep is None else keep
    return [upload(np.array(host[i * step:(i + 1) * step]), d, keep)
            for i, d in zip(mesh.local_positions, mesh.devices)]


def shard_parts(parts, mesh: Mesh, keep: list | None = None) -> list[torch.Tensor]:
    """Per-position host arrays (one per position of the mesh, equal
    lengths; other processes' entries are not read and may be None),
    this process's each copied fresh and uploaded to its device."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size}")
    keep = [] if keep is None else keep
    return [upload(np.array(parts[i]), d, keep)
            for i, d in zip(mesh.local_positions, mesh.devices)]


def replicate(host: np.ndarray, mesh: Mesh, keep: list | None = None) -> list[torch.Tensor]:
    """One copy of ``host`` per local position (positions on one device
    share it)."""
    fresh = np.array(host)
    keep = [] if keep is None else keep
    by_device: dict = {}
    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = upload(fresh, d, keep)
    return [by_device[d] for d in mesh.devices]


def _to_group(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` where the group's backend reads it: a gloo group's through
    pinned host memory (when it lies on a card), an NCCL group's on the
    first local card."""
    if mesh.backend == "gloo":
        if t.device.type != "cuda":
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t.to(mesh.devices[0]).contiguous()


def all_to_all(sends: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Tiled all-to-all over the local positions' ``(n, ...)`` send
    buffers (one shape on every position): position ``d`` receives
    ``cat([sends[s][d] for s in range(n)])`` (source-major), on its own
    device."""
    n = mesh.size
    if mesh.backend is None:
        return [torch.cat([sends[s][d].to(mesh.devices[d], non_blocking=True)
                           for s in range(n)]) for d in range(n)]
    import torch.distributed as dist

    width = len(mesh.devices)
    procs = n // width
    me = mesh.first // width
    piece = tuple(sends[0].shape[1:])
    # to process q: its positions in order, then this process's sources
    # in order, as raw bytes (one collective whatever the dtype)
    blocks = [torch.stack([s[q * width:(q + 1) * width].to(mesh.devices[0]) for s in sends],
                          dim=1).reshape(-1).view(torch.uint8)
              for q in range(procs) if q != me]
    block_bytes = blocks[0].numel() if blocks else 0
    splits = [0 if q == me else block_bytes for q in range(procs)]
    recv_blocks = {}
    if blocks:
        send = _to_group(torch.cat(blocks), mesh)
        recv = torch.empty(send.shape, dtype=torch.uint8, device=send.device,
                           pin_memory=send.device.type == "cpu" and torch.cuda.is_available())
        dist.all_to_all_single(recv, send, splits, splits)
        mesh.sent_bytes += send.numel()
        at = 0
        for q in range(procs):
            if q != me:
                recv_blocks[q] = recv[at:at + block_bytes]
                at += block_bytes
    out = []
    for j, dev in enumerate(mesh.devices):
        parts = []
        for q in range(procs):
            if q == me:
                parts.extend(sends[s][mesh.first + j].to(dev, non_blocking=True)
                             for s in range(width))
            else:
                # (my positions, q's sources, *piece) -> position j's rows
                blk = recv_blocks[q].view(sends[0].dtype).reshape(width, width, *piece)[j]
                parts.append(blk.to(dev, non_blocking=True).flatten(0, 1))
        out.append(torch.cat(parts))
    return out


def _reduce(parts, op, mesh: Mesh, group_op: str) -> torch.Tensor:
    dev = mesh.devices[0]
    local = functools.reduce(op, (p.to(dev, non_blocking=True) for p in parts))
    if mesh.backend is None:
        return local
    import torch.distributed as dist

    # reduced in place: never the caller's own tensor
    t = _to_group(local.clone() if len(parts) == 1 else local, mesh)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, group_op))
    return t.to(dev, non_blocking=True)


def psum(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise sum over the positions, on the first local
    position's device."""
    return _reduce(parts, torch.add, mesh, "SUM")


def pmax(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise max over the positions, on the first local
    position's device."""
    return _reduce(parts, torch.maximum, mesh, "MAX")


def gather_host(parts: list[torch.Tensor], mesh: Mesh) -> np.ndarray:
    """Stack every position's tensor (one shape) and read them on the
    host, the same array in every process: one wait for the cards,
    however many positions."""
    dev = mesh.devices[0]
    local = torch.stack([p.to(dev, non_blocking=True) for p in parts])
    if mesh.backend is None:
        return local.cpu().numpy()
    import torch.distributed as dist

    t = _to_group(local, mesh)
    got = [torch.empty_like(t) for _ in range(mesh.size // len(mesh.devices))]
    dist.all_gather(got, t)
    return torch.cat(got).cpu().numpy()


def agree_max(values: list[int], mesh: Mesh) -> list[int]:
    """The elementwise max of host integers over the processes (the
    values themselves without a group): a host branch taken after a
    collective must be taken by every process alike."""
    if mesh.backend is None:
        return list(values)
    import torch.distributed as dist

    t = _to_group(torch.tensor(values, dtype=torch.int64), mesh)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [int(v) for v in t.cpu()]
