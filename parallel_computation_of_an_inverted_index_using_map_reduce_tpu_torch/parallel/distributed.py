"""Multi-process runtime seam over ``torch.distributed``.

The reference is strictly single-process (SURVEY.md §4: "no multi-node
story at all").  A multi-process run is the library API run in each
process after :func:`initialize`, as with the JAX package's
``jax.distributed`` seam: :func:`parallel.mesh.make_mesh` then gives a
global mesh whose positions are split over the processes, each process
feeds and fetches only its own positions, and the collectives cross
the processes through the process group.

The group's backend is decided once, at :func:`initialize`, by
:func:`choose_backend` from the processes on this host and the cards
it has: NCCL when each process has a card of its own, gloo when
processes share a card (NCCL refuses two ranks on one device) or when
there is no card.  An NCCL group carries host tensors (a mesh on the
CPU, a host-side agreement) through gloo beside it: each collective
goes by its tensor's device (:func:`group_backend`).
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    """This process's place in the joined group."""

    rank: int
    world: int
    local_rank: int   # among the processes of this host
    local_count: int  # processes on this host
    backend: str


_topology: Topology | None = None


def choose_backend(processes_on_host: int, cards: int) -> str:
    """``"nccl"`` when every process of the host has a card of its own,
    else ``"gloo"`` (processes share a card, or there is none)."""
    return "nccl" if cards >= processes_on_host >= 1 else "gloo"


def group_backend(backend: str) -> str:
    """The backend string a group of :func:`choose_backend`'s ``backend``
    is created with: NCCL for card tensors and gloo for host tensors, or
    gloo for both."""
    return "cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo"


def _address(coordinator_address: str | None) -> tuple[str, int]:
    if coordinator_address is None:
        return os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    addr = coordinator_address.removeprefix("tcp://")
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be host:port, got {coordinator_address!r}")
    return host, int(port)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or start) a process group of ``num_processes``, this one
    being ``process_id``.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``)
    of a store that process 0 serves; with no arguments the
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
    environment is read.  The processes first publish their host names
    through the store, which gives each its rank on the host, and the
    backend follows :func:`choose_backend` (:func:`group_backend`).  A
    group that fails to form raises."""
    import torch.distributed as dist

    global _topology
    host, port = _address(coordinator_address)
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    store = dist.TCPStore(host, port, world, is_master=rank == 0)
    store.set(f"mri_host/{rank}", socket.gethostname())
    hosts = [store.get(f"mri_host/{r}").decode() for r in range(world)]
    peers = [r for r in range(world) if hosts[r] == hosts[rank]]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    topo = Topology(rank=rank, world=world, local_rank=peers.index(rank),
                    local_count=len(peers), backend=choose_backend(len(peers), cards))
    kwargs = {}
    if topo.backend == "nccl":
        # bound to the process's first card, where the mesh runs every
        # collective: NCCL never guesses a card by rank
        card = card_block(topo.local_rank, topo.local_count, cards)[0]
        torch.cuda.set_device(card)
        kwargs["device_id"] = torch.device("cuda", card)
    dist.init_process_group(group_backend(topo.backend), store=store, world_size=world,
                            rank=rank, **kwargs)
    _topology = topo


def card_block(local_rank: int, local_count: int, cards: int) -> list[int]:
    """The cards of one process of the host: an equal block of its own
    when there are at least as many cards as processes, else one card
    shared round-robin."""
    if cards >= local_count:
        per = cards // local_count
        return list(range(local_rank * per, (local_rank + 1) * per))
    return [local_rank % cards]


def topology() -> Topology | None:
    """This process's :class:`Topology` while the group that
    :func:`initialize` joined stands, else None."""
    import torch.distributed as dist

    if _topology is None or not (dist.is_available() and dist.is_initialized()):
        return None
    return _topology


def runtime_info() -> dict:
    """Structured view of the topology for logs and metrics: the JAX
    package's keys, process 0 of 1 when no process group was joined,
    and the port-only ``backend`` (None without a group)."""
    topo = topology()
    count = topo.world if topo else 1
    cuda = torch.cuda.is_available()
    local = torch.cuda.device_count() if cuda else 1
    return {
        "process_index": topo.rank if topo else 0,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
        "platform": "gpu" if cuda else "cpu",
        "backend": topo.backend if topo else None,
    }
