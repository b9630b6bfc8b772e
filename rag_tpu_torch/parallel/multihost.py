"""Starting the process group, and feeding a world whose ranks read only
their own part of the data.

Counterpart of rag_tpu/parallel/multihost.py. Recipe:

  1. every rank calls ``initialize_multihost(address, world, rank)``;
     it joins one torch.distributed process group (NCCL on CUDA
     devices, gloo on the CPU);
  2. ``mesh.make_mesh()`` describes the world;
  3. each rank reads only its shard of the dataset's indices
     (``host_local_indices``), and ``global_batch`` joins the ranks'
     local batches into the global batch every rank's step takes.

A process in rag_tpu drives every device of its host; here one process
drives one device, so the process index and count below are the rank
and the world size.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize_multihost(address: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         device=None) -> int:
    """Join the process group and return this rank.

    address: ``tcp://host:port`` of rank 0's store; world_size and rank
    explicit. Where all three are None, torch's own ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) give them. The backend
    is NCCL for a CUDA ``device`` (the current one when None and CUDA is
    available) and gloo for the CPU. A CUDA device is made the current
    one first. A group already initialized is kept."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if address is None and world_size is None and rank is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, init_method=address,
                                    world_size=world_size, rank=rank)
    return dist.get_rank()


def process_info():
    """(rank, world size) of the initialized group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_local_indices(n_items: int,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> np.ndarray:
    """The contiguous shard of dataset indices this rank owns. Every rank
    gets the same count per = ceil(n/pc); when pc does not divide n the
    tail shards wrap around to the start (a few items appear on two
    ranks, none is dropped)."""
    pi, pc = process_info()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    per = -(-n_items // pc)  # ceil division
    assert per > 0, (n_items, pc)
    start = pi * per
    return np.arange(start, start + per) % n_items


@torch.no_grad()
def global_batch(local: Dict[str, torch.Tensor], mesh) -> Dict:
    """The global batch from each rank's local batch: the data indices'
    batches in order along the leading axis, on every rank (an all-gather
    per tensor over the world; the model ranks of a data index read the
    same shard, and one of them is kept). Every rank's local batch must
    have the same shape."""
    out = {}
    for k, v in local.items():
        v = v.to(mesh.device).contiguous()
        parts = [torch.empty_like(v) for _ in range(mesh.size)]
        dist.all_gather(parts, v, group=mesh.group)
        out[k] = torch.cat(parts[::mesh.model])
    return out


class MultihostBatcher:
    """A dataset whose iteration yields global batches while each rank
    reads only its shard of the indices, the shards joined per step.

    Every rank must construct it with the same dataset length, batch and
    seed, so that the ranks' permutations stay aligned."""

    def __init__(self, dataset, mesh,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.mesh = mesh
        self.pi = mesh.d if process_index is None else process_index
        self.pc = mesh.data if process_count is None else process_count

    def __len__(self):
        return len(self.dataset)

    def batches(self, global_batch_size: int, shuffle: bool, seed: int = 0,
                indices=None, drop_last: bool = True):
        """indices: an optional subset of the dataset's indices (search
        splits); each rank takes its host_local_indices shard of it."""
        assert global_batch_size % self.pc == 0, \
            (global_batch_size, self.pc)
        local_bs = global_batch_size // self.pc
        n = len(self.dataset) if indices is None else len(indices)
        own = host_local_indices(n, self.pi, self.pc)
        if indices is not None:
            own = np.asarray(indices)[own]
        for b in self.dataset.batches(local_bs, shuffle, seed=seed,
                                      indices=own, drop_last=drop_last):
            yield global_batch(b, self.mesh)


def local_address() -> str:
    """``tcp://127.0.0.1:<port>`` on a port free at the time of the call:
    rank 0's store for a world on this machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"
