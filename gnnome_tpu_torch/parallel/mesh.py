"""The ``(data, graph)`` process mesh of the sharded step, on torch.distributed.

Counterpart of ``gnnome_tpu/parallel/mesh.py``. Two axes, as there:

  * ``data``  — data parallelism over graphs (one graph per replica group,
                gradients summed over the world);
  * ``graph`` — graph partition parallelism: the nodes and edges of one
                graph sharded over the ranks of a group
                (``parallel/sharded.py``).

Global rank ``r`` sits at ``(r // graph, r % graph)``. Each axis has its
process subgroups (``dist.new_group``); an axis of size 1 has none, and at
world size 1 the mesh needs no process group at all, as
``make_mesh(data=1, graph=1)`` in JAX needs no second device.

The differentiable collectives the sharded step runs over these groups
are in ``core/collectives.py``. Every process group carries the timeout
given to :func:`initialize_distributed` (and :func:`make_mesh`), so a rank
that never arrives fails the call instead of hanging it.

The mesh's device is the rank's: the one :func:`initialize_distributed`
bound it to, else the current CUDA device. A mesh on the CPU comes only
from an explicit ``device="cpu"``, as everywhere in the port.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
_rank_device: Optional[torch.device] = None  # set by initialize_distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data × graph`` layout of ranks, this rank's place in it, its
    device and the subgroups of its two axes (``None`` where the axis has
    one rank). ``Mesh(data, graph)`` alone is a layout with no process
    group: ``prepare_batch`` reads only the two sizes."""

    data: int = 1
    graph: int = 1
    rank: int = 0
    device: torch.device = torch.device("cuda")
    graph_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    world_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.data * self.graph

    @property
    def data_index(self) -> int:
        return self.rank // self.graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.graph


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           device: str = "cuda", backend: Optional[str] = None,
                           local_rank: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """``init_process_group`` for this rank; returns its device.

    ``init_method`` is the rendezvous (``tcp://localhost:<port>``: nothing
    on the machine names a cluster). The backend follows the device,
    ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``, unless ``backend`` names
    one (``gloo`` runs two ranks on one card, which NCCL refuses). On
    ``cuda`` a rank takes ``cuda:(local_rank % device_count)``,
    ``local_rank`` defaulting to ``rank``. A backend that fails raises: there
    is no switch to another backend or to the CPU."""
    global _rank_device
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: device 'cuda' but no CUDA device")
        local = rank if local_rank is None else local_rank
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif device == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"initialize_distributed: device {device!r}; 'cuda' or 'cpu'")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _rank_device = dev
    return dev


def _default_device() -> torch.device:
    """The device :func:`initialize_distributed` bound this rank to, else the
    current CUDA device."""
    if _rank_device is not None and dist.is_initialized():
        return _rank_device
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cuda")


def make_mesh(data: Optional[int] = None, graph: Optional[int] = None,
              device: Optional[torch.device] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The ``(data, graph)`` mesh over the initialized process group (all
    ranks on the graph axis by default), or, with no process group, the
    one-rank mesh, on ``device`` (by default the rank's: see the module's
    docstring). Every rank must call it, with the same sizes: each creates
    every subgroup, in one order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None and graph is None:
        data, graph = 1, world
    elif data is None:
        data = world // graph
    elif graph is None:
        graph = world // data
    if data * graph != world:
        raise ValueError(f"mesh {data}x{graph} != {world} ranks")
    device = torch.device(device) if device is not None else _default_device()
    if world == 1:
        return Mesh(data, graph, 0, device)
    rank = dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    graph_group = data_group = None
    for d in range(data):  # every rank creates every group, in one order
        ranks = [d * graph + g for g in range(graph)]
        group = dist.group.WORLD if graph == world else (
            dist.new_group(ranks, timeout=timeout) if graph > 1 else None)
        if rank in ranks:
            graph_group = group
    for g in range(graph):
        ranks = [d * graph + g for d in range(data)]
        group = dist.group.WORLD if data == world else (
            dist.new_group(ranks, timeout=timeout) if data > 1 else None)
        if rank in ranks:
            data_group = group
    return Mesh(data, graph, rank, device, graph_group, data_group, dist.group.WORLD)

