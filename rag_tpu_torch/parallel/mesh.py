"""The world a data-parallel run spans, and its batches.

Counterpart of rag_tpu/parallel/mesh.py. rag_tpu's mesh is a grid of
devices inside one program; here each rank is a process driving one
device, joined by a torch.distributed process group
(``multihost.initialize_multihost`` starts it). ``Mesh`` describes that
world from this rank's side: its size, this rank, this rank's device and
the group. Steps built with a mesh take the global batch, the same on
every rank as rag_tpu's steps take a global array, and each rank runs on
its contiguous slice of it (``shard_batch``).

Only the data axis is ported: a model axis > 1 (the cost volume's
spatial sharding) raises, and ``cost_volume_spec`` has no counterpart
yet (ROADMAP.md Queue 1 item 7b).
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Dict, Optional

import torch
import torch.distributed as dist

MODEL_AXIS_ITEM = "ROADMAP.md Queue 1 item 7b"


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int             # ranks on the data axis: the world's size
    rank: int             # this process's rank
    device: torch.device  # this rank's device
    group: object         # the process group of the data axis
    model: int = 1
    hosts: int = 1        # machines the world spans

    def __post_init__(self):
        if self.model != 1:
            raise NotImplementedError(
                f"mesh model axis {self.model}: the spatial sharding of the "
                f"cost volume is not ported yet ({MODEL_AXIS_ITEM})")

    @property
    def size(self) -> int:
        return self.data * self.model


def _device(device) -> torch.device:
    """``device`` with a CUDA index filled in; by default the current CUDA
    device under NCCL, else the CPU."""
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """The mesh over the initialized process group's ranks: data defaults
    to world // model, and data * model must equal the world (a model
    axis > 1 raises). ``device`` defaults to the current CUDA device under
    NCCL, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "rag_tpu_torch.parallel.multihost."
                           "initialize_multihost first")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    mesh = Mesh(data=data, rank=dist.get_rank(), device=_device(device),
                group=dist.group.WORLD, model=model, hosts=len(set(names)))
    if mesh.size != world:
        raise ValueError(f"mesh {data}x{model} over a world of {world}")
    return mesh


def rank_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous part of x's leading axis, on its device."""
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"batch {n} does not divide over {mesh.data} ranks")
    per = n // mesh.data
    return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict:
    """Every tensor's rank_slice: rank r takes rows [r n/W, (r+1) n/W),
    the order in which rag_tpu's shard_map hands a batch to its devices."""
    return {k: rank_slice(v, mesh) for k, v in batch.items()}


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Rank 0's copy of a nested dict on every rank: each tensor broadcast
    in place on this rank's device, any other leaf (a genotype, a list of
    numpy arrays) pickled from rank 0. Returns the tree."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.to(mesh.device).contiguous()
        dist.broadcast(t, src=0, group=mesh.group)
        return t
    box = [tree]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=mesh.device)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh (nothing without one)."""
    if mesh is None:
        return
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)
