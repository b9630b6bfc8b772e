"""Training losses (counterpart of rag_tpu/train/losses.py). The serving
slice needs the supervised smooth-L1; the photometric and silog losses
arrive with their variants."""

from __future__ import annotations

import torch


def smooth_l1_masked(pred, target, mask, beta: float = 1.0):
    """Masked mean smooth-L1 (torch F.smooth_l1_loss semantics)."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    m = mask.to(loss.dtype)
    return (loss * m).sum() / m.sum().clamp(min=1.0)
