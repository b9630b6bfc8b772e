"""The world a data- or spatially-parallel run spans, and its batches.

Counterpart of rag_tpu/parallel/mesh.py. rag_tpu's mesh is a grid of
devices inside one program; here each rank is a process driving one
device, joined by a torch.distributed process group
(``multihost.initialize_multihost`` starts it). ``Mesh`` describes that
world from this rank's side: its size, this rank, this rank's device and
the groups. The ranks form a (data, model) grid with rank = d * model + m,
rag_tpu's ``devices.reshape(data, model)``: the data axis splits the batch,
the model axis splits the matching volumes' H rows (``slab_rows``, the
counterpart of ``cost_volume_spec``). Steps built with a mesh take the
global batch, the same on every rank as rag_tpu's steps take a global
array; each rank runs on its data index's contiguous slice of it
(``shard_batch``), and every model rank of a data index holds the same
images.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int             # ranks on the data axis
    rank: int             # this process's rank in the world
    device: torch.device  # this rank's device
    group: object         # the world's process group: every rank
    model: int = 1        # ranks on the model axis
    hosts: int = 1        # machines the world spans
    # the ranks with this rank's model index (the data axis); the world
    # where model == 1
    data_group: object = None
    # the ranks with this rank's data index (the model axis); None where
    # model == 1
    model_group: object = None

    def __post_init__(self):
        if self.model < 1 or self.data < 1:
            raise ValueError(f"mesh {self.data}x{self.model}")
        if self.model == 1 and self.data_group is None:
            object.__setattr__(self, "data_group", self.group)
        if self.model > 1 and (self.model_group is None
                               or self.data_group is None):
            raise ValueError(f"mesh model axis {self.model} needs its data "
                             "and model process groups (make_mesh builds "
                             "them)")

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def d(self) -> int:
        """This rank's index on the data axis."""
        return self.rank // self.model

    @property
    def m(self) -> int:
        """This rank's index on the model axis."""
        return self.rank % self.model

    @property
    def spatial(self) -> bool:
        """Whether the matching volumes' H splits over a model axis."""
        return self.model > 1


def slab_rows(h: int, model: int, m: int) -> Tuple[int, int]:
    """Rank m's rows [floor(m h / M), floor((m + 1) h / M)) of an H axis of
    h rows split over a model axis of M ranks, at any scale of the
    matching net (rag_tpu's cost_volume_spec shards H over 'model'). A
    slab would be empty where h < M: ValueError."""
    if h < model:
        raise ValueError(f"an H axis of {h} rows cannot split over a model "
                         f"axis of {model} ranks: a slab would be empty")
    return m * h // model, (m + 1) * h // model


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
    to world // model, and data * model must equal the world. With a
    model axis > 1 every rank creates the data and model groups of every
    index, in one order (``dist.new_group`` is collective). ``device``
    defaults to the current CUDA device under NCCL, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "rag_tpu_torch.parallel.multihost."
                           "initialize_multihost first")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} over a world of {world}")
    rank = dist.get_rank()
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    groups = {}
    if model > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                groups["data_group"] = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                groups["model_group"] = g
    return Mesh(data=data, rank=rank, device=_device(device),
                group=dist.group.WORLD, model=model, hosts=len(set(names)),
                **groups)


def rank_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's data index's contiguous part of x's leading axis, on
    its device."""
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"batch {n} does not divide over {mesh.data} ranks")
    per = n // mesh.data
    return x[mesh.d * per:(mesh.d + 1) * per].to(mesh.device)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict:
    """Every tensor's rank_slice: data index d takes rows [d n/D,
    (d+1) n/D), the order in which rag_tpu's shard_map hands a batch to
    its devices; the batch splits over the data axis only."""
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
