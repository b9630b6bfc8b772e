"""The model axis's collectives: halo rows and whole-H gathers of the
matching volumes' H slabs.

rag_tpu has no counterpart: its spatial path constrains the volume to
P(data, None, model) and XLA writes the halo exchanges
(rag_tpu/parallel/sharded.py). Here each rank of a model group holds the
rows ``parallel.mesh.slab_rows`` gives it of every volume (H is the
second-to-last axis of every tensor below), and

  * ``halo_rows(x, k, mesh, pad)`` attaches k rows of each neighbour's
    slab along H: zeros beyond a global edge for the zero-padded 3x3x3
    convs, or nothing there (``pad=False``) for the head, whose kernel then
    clamps its upsample at the global edge itself, as on the whole H.
    Its backward sends the halo rows' gradient back to their owner, which
    adds it to its own rows;
  * ``gather_h(x, h, mesh)`` assembles the whole H axis on every rank of
    the model group, for the align-corners resizes whose source rows
    follow no fixed halo; ``slice_h(x, h, mesh)`` keeps this rank's rows
    of a whole-H tensor. gather_h's backward sums the ranks' gradients
    and keeps this rank's rows; slice_h's puts zeros around them.

``SlabVolume`` runs the matching net's cross-row ops (``ops.volume``) on
this rank's slabs with these exchanges around the unchanged kernels:

  * the 3x3x3 conv: ``halo_rows(x, 1)`` attaches one row of each
    neighbour (zeros beyond the global edges), kernel A (or H) runs on
    the extended slab with its own pad of 1, and the first and last
    output rows are cropped. In the backward the crop's zeros stand in
    the halo rows' cotangent, so kernel A's transposed use gives the
    extended slab's gradient (the halo rows' part goes back to their
    owners), and kernel D's dW is this rank's rows' partial sum, summed
    over the world with every other gradient;
  * the align-corners resize: ``gather_h``, ``resize_cf`` on the whole H
    (kernel I with the variant on), ``slice_h``;
  * the head: at an integer scale the align_corners=False upsample
    commutes with a shift of whole source rows, and output rows [scale
    h0, scale h1) read source rows h0 - 1 .. h1 only. So kernel C (and G
    in the backward) runs unchanged on the slab with one halo row on each
    side that has a neighbour (``pad=False``), and the output is cropped
    to those rows. At a global edge no row is attached: the kernel's own
    clamp then takes the edge rows' taps of the whole H, weights included.
    (A copy of the edge row in its place computes the same function, but
    blends two float32 weights whose sum is not exactly 1 where the whole
    H takes one weight of 1.)

Every exchange is one ``all_reduce`` of a zeroed buffer in which each
rank writes its rows into its own slot, so that NCCL, gloo on the CPU
and gloo on CUDA tensors (which moves CUDA tensors in ``all_reduce`` and
``broadcast`` only) run the same code. ``HALO`` counts the exchanges and
the bytes of their buffers (each rank's all-reduce payload), forward and
backward, halo rows and gathers apart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rag_tpu_torch.ops.variants import KernelVariants
from rag_tpu_torch.ops.volume import WholeVolume
from rag_tpu_torch.parallel.mesh import slab_rows


class _Traffic:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.exchanges = 0
        self.halo_bytes = 0
        self.gather_bytes = 0


HALO = _Traffic()


def _all_reduce(buf: torch.Tensor, group, kind: str) -> torch.Tensor:
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    HALO.exchanges += 1
    nbytes = buf.numel() * buf.element_size()
    if kind == "halo":
        HALO.halo_bytes += nbytes
    else:
        HALO.gather_bytes += nbytes
    return buf


def _extent(k: int, pad: bool, m: int, size: int):
    return (k if pad or m > 0 else 0), (k if pad or m < size - 1 else 0)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, pad, group, m, size):
        n = x.shape[-2]
        if n < k:
            raise ValueError(f"halo of {k} rows around a slab of {n}")
        ctx.k, ctx.pad, ctx.group, ctx.m, ctx.size = k, pad, group, m, size
        buf = x.new_zeros((size, 2) + x.shape[:-2] + (k, x.shape[-1]))
        buf[m, 0] = x[..., :k, :]
        buf[m, 1] = x[..., n - k:, :]
        _all_reduce(buf, group, "halo")
        top, bottom = _extent(k, pad, m, size)
        zeros = torch.zeros_like(buf[m, 0])
        parts = ([buf[m - 1, 1] if m > 0 else zeros] if top else []) + [x] \
            + ([buf[m + 1, 0] if m < size - 1 else zeros] if bottom else [])
        return torch.cat(parts, dim=-2)

    @staticmethod
    def backward(ctx, g):
        k, m, size = ctx.k, ctx.m, ctx.size
        top, bottom = _extent(k, ctx.pad, m, size)
        n = g.shape[-2] - top - bottom
        dx = g[..., top:top + n, :].clone()
        buf = g.new_zeros((size, 2) + g.shape[:-2] + (k, g.shape[-1]))
        if m > 0:                      # rank m-1's last rows
            buf[m - 1, 1] = g[..., :k, :]
        if m < size - 1:               # rank m+1's first rows
            buf[m + 1, 0] = g[..., top + n:, :]
        _all_reduce(buf, ctx.group, "halo")
        dx[..., :k, :] += buf[m, 0]
        dx[..., n - k:, :] += buf[m, 1]
        return dx, None, None, None, None, None


def halo_rows(x: torch.Tensor, k: int, mesh, pad: bool = True) -> torch.Tensor:
    """x (..., n, W), this rank's slab, with k rows of each neighbour
    attached along H. Beyond a global edge the rows are zeros, or with
    ``pad=False`` absent."""
    return _HaloRows.apply(x, k, pad, mesh.model_group, mesh.m, mesh.model)


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, group, m, size):
        h0, h1 = slab_rows(h, size, m)
        if x.shape[-2] != h1 - h0:
            raise ValueError(f"gather_h: a slab of {x.shape[-2]} rows for "
                             f"rows [{h0}, {h1}) of {h}")
        ctx.rows, ctx.group = (h0, h1), group
        buf = x.new_zeros(x.shape[:-2] + (h, x.shape[-1]))
        buf[..., h0:h1, :] = x
        return _all_reduce(buf, group, "gather")

    @staticmethod
    def backward(ctx, g):
        h0, h1 = ctx.rows
        g = _all_reduce(g.contiguous().clone(), ctx.group, "gather")
        return g[..., h0:h1, :].contiguous(), None, None, None, None


def gather_h(x: torch.Tensor, h: int, mesh) -> torch.Tensor:
    """The whole H axis (..., h, W) on every rank of the model group, from
    each rank's slab x of it."""
    return _GatherH.apply(x, h, mesh.model_group, mesh.m, mesh.model)


def slice_h(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a whole-H tensor x (..., h, W), the same on
    every rank of the model group (its gradient: zeros around them)."""
    h0, h1 = slab_rows(x.shape[-2], mesh.model, mesh.m)
    return x[..., h0:h1, :]


class SlabVolume(WholeVolume):
    """This rank's H slabs of the volumes over ``mesh``'s model axis:
    ``ops.volume.WholeVolume``'s ops, each giving this rank's rows of the
    whole volume's result."""

    def __init__(self, mesh):
        self.mesh = mesh

    def rows(self, h: int):
        return slab_rows(h, self.mesh.model, self.mesh.m)

    def conv(self, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, relu: bool,
             variants: KernelVariants) -> torch.Tensor:
        ext = halo_rows(x.contiguous(), 1, self.mesh)
        return super().conv(ext, w, scale, bias, relu, variants)[..., 1:-1, :]

    def resize(self, x: torch.Tensor, h: int, d2: int, h2: int, w2: int,
               variants: KernelVariants) -> torch.Tensor:
        whole = super().resize(gather_h(x.contiguous(), h, self.mesh), h,
                               d2, h2, w2, variants)
        return slice_h(whole, self.mesh)

    def soft_argmin(self, x: torch.Tensor, maxdisp: int,
                    scale: int) -> torch.Tensor:
        top, bottom = _extent(1, False, self.mesh.m, self.mesh.model)
        ext = halo_rows(x.contiguous(), 1, self.mesh, pad=False)
        disp = super().soft_argmin(ext, maxdisp, scale)
        return disp[:, scale * top:disp.shape[1] - scale * bottom]
