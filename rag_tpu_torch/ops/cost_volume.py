"""Concat cost volume, channel-first (plain PyTorch).

Counterpart of rag_tpu/ops/cost_volume.py::cost_volume_cf:

    cost[b, d, :C,  i, j] = x[b, i, j, :]      if j >= d else 0
    cost[b, d, C:,  i, j] = y[b, i, j - d, :]  if j >= d else 0

On the serving path the volume is never built: kernel B (ops.cvstem) reads
it straight from the feature maps. This is the plain half of that kernel's
plain version.
"""

from __future__ import annotations

import torch


def cost_volume_cf(x: torch.Tensor, y: torch.Tensor, num_disp: int) -> torch.Tensor:
    """x, y: (B, H, W, C) features -> (B, num_disp, 2C, H, W)."""
    b, h, w, c = x.shape
    x_cf = x.permute(0, 3, 1, 2)                       # (B, C, H, W)
    y_cf = y.permute(0, 3, 1, 2)
    j = torch.arange(w, device=x.device)[None, :]
    disp = torch.arange(num_disp, device=x.device)[:, None]
    src = j - disp                                     # (D, W)
    valid = (src >= 0).to(x.dtype)
    y_shift = y_cf[..., src.clamp(0, w - 1)]           # (B, C, H, D, W)
    y_shift = y_shift.movedim(3, 1)                    # (B, D, C, H, W)
    mask = valid[None, :, None, None, :]
    x_part = x_cf[:, None] * mask
    return torch.cat([x_part, y_shift * mask], dim=2)
