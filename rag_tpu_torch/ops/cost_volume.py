"""Concat cost volume, channel-first (plain PyTorch).

Counterpart of rag_tpu/ops/cost_volume.py::cost_volume_cf:

    cost[b, d, :C,  i, j] = x[b, i, j, :]      if j >= d else 0
    cost[b, d, C:,  i, j] = y[b, i, j - d, :]  if j >= d else 0

On the card the volume is never built: kernel B (ops.cvstem) reads it
straight from the feature maps, and kernels E and F do so in the backward.
This is the plain half of those kernels' plain versions, and the search
supernet's cost volume.

The y half is a gather; its backward (``_ShiftedPlanes``) sums each plane's
shifted gradient into dy plane by plane, in d order, as kernel E's plain
version does. Autograd's own backward of the gather, an accumulating
``index_put_``, adds in the order threads (CPU) or atomics (CUDA) reach
the values, so two backward passes on equal inputs could differ in their
last bits.
"""

from __future__ import annotations

import torch


class _ShiftedPlanes(torch.autograd.Function):
    """y_cf (B, C, H, W) -> (B, D, C, H, W), plane d = y_cf[..., j - d]
    (index clamped at 0; the caller masks j < d). Backward: plane d's
    gradient at j >= d added into dy[..., j - d], d ascending."""

    @staticmethod
    def forward(ctx, y_cf, src):
        ctx.num_disp = src.shape[0]
        return y_cf[..., src.clamp(0, y_cf.shape[-1] - 1)].movedim(3, 1)

    @staticmethod
    def backward(ctx, g):
        w = g.shape[-1]
        dy = g.new_zeros(g.shape[:1] + g.shape[2:])
        for d in range(min(ctx.num_disp, w)):
            dy[..., :w - d] += g[:, d, ..., d:]
        return dy, None


def cost_volume_cf(x: torch.Tensor, y: torch.Tensor, num_disp: int) -> torch.Tensor:
    """x, y: (B, H, W, C) features -> (B, num_disp, 2C, H, W)."""
    b, h, w, c = x.shape
    x_cf = x.permute(0, 3, 1, 2)                       # (B, C, H, W)
    y_cf = y.permute(0, 3, 1, 2)
    j = torch.arange(w, device=x.device)[None, :]
    disp = torch.arange(num_disp, device=x.device)[:, None]
    src = j - disp                                     # (D, W)
    valid = (src >= 0).to(x.dtype)
    y_shift = _ShiftedPlanes.apply(y_cf, src)          # (B, D, C, H, W)
    mask = valid[None, :, None, None, :]
    x_part = x_cf[:, None] * mask
    return torch.cat([x_part, y_shift * mask], dim=2)
