"""Cross-rank reductions for the data- and spatially-parallel steps.

Counterpart of rag_tpu/parallel/axis.py. With a mesh, every rank runs the
same step body on its slice of the global batch (and, with a model axis,
on its H slab of the matching volumes), and every batch-wide statistic
reduces across the ranks explicitly, so that the step gives the
single-process result:

  * BatchNorm batch statistics: the ranks' per-channel sums, sums of
    squares and counts (``ops.convbr.batch_stats`` reads ``bn_group()``),
    exact for equal batch slices and unequal H slabs alike: the matching
    net's sites reduce over the whole world, the feature net's, which
    every model rank computes whole, over the data axis only;
  * masked losses and metrics: sums of their numerators and denominators
    (the losses and metrics take ``group=``);
  * gradients: one flattened sum (``all_sum_tree``).

``all_sum_if`` and ``all_mean_if`` are autograd Functions whose backward
sums (or averages) the incoming gradient across the ranks: every rank's
loss depends on every rank's statistics. Every rank then holds the same
global loss L; differentiating L / world on each rank and summing the
gradients gives dL/dparams exactly, whatever L is (``train.trainer``).

``bn_collective`` sets the group for code run inside it on this thread.
The backward runs on another thread, so the forward passes the group it
read into the Function, and the backward takes it from there.

Every all-reduce issued here adds one to ``ALL_REDUCES.count``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist

_STATE = threading.local()


class _Counter:
    def __init__(self):
        self.count = 0


ALL_REDUCES = _Counter()


def bn_group():
    """The active cross-rank BatchNorm group (None: single process)."""
    return getattr(_STATE, "group", None)


@contextlib.contextmanager
def bn_collective(group):
    """Batch statistics of train-mode BatchNorms run inside the block
    reduce over ``group`` (nothing changes with None)."""
    prev = getattr(_STATE, "group", None)
    _STATE.group = group
    try:
        yield
    finally:
        _STATE.group = prev


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A summed copy of x over the group's ranks."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    ALL_REDUCES.count += 1
    return y


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group) / dist.get_world_size(ctx.group), \
            None


def all_sum_if(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group's ranks (x itself with group None)."""
    return x if group is None else _AllSum.apply(x, group)


def all_mean_if(x: torch.Tensor, group) -> torch.Tensor:
    """x averaged over the group's ranks (x itself with group None)."""
    return x if group is None else _AllMean.apply(x, group)


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


@torch.no_grad()
def all_sum_tree(grads: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """{path: tensor} summed over the ranks in one flattened all-reduce
    (the dict itself with group None)."""
    if group is None or not grads:
        return grads
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads.values()]),
                       group)
    out, at = {}, 0
    for path, g in grads.items():
        out[path] = flat[at:at + g.numel()].view_as(g)
        at += g.numel()
    return out


def data_group(mesh) -> Optional[object]:
    """The process group a step builder reduces its loss, metrics and
    gradients over (rag_tpu's ``data_axis``; with a model axis the whole
    world): None without a mesh. A mesh of any size gives its group, so a
    world of one issues the same collectives as a larger one."""
    return None if mesh is None else mesh.group
