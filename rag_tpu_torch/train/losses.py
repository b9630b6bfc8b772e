"""Training losses (counterpart of rag_tpu/train/losses.py): the supervised
smooth-L1, the self-supervised photometric loss (0.85 SSIM + 0.15 L1 of
the right view warped to the left by the estimated disparity, plus 0.1
edge-aware smoothness) and the depth variant's silog.

Images are NHWC, as in rag_tpu. The warp is the gather form of
``warp_by_disparity``; rag_tpu's gather-free ``warp_by_disparity_scan``
computes the same function for the TPU and has no counterpart here.

Each loss takes ``group=None``: under a data-parallel group it reduces
its numerators and denominators (or, for the photometric loss's plain
means over equal slices, the loss itself) across the ranks through
``parallel.axis``, so that every rank holds the global batch's loss.

Gradients at ties follow JAX: ``jnp.clip`` and ``jnp.maximum`` pass half
the gradient to each side where the two are equal, as ``torch.maximum``
and ``torch.minimum`` do; ``torch.clamp`` would pass all of it, so it is
not used where a gradient flows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rag_tpu_torch.parallel.axis import all_mean_if, all_sum_if


def smooth_l1_masked(pred, target, mask, beta: float = 1.0, group=None):
    """Masked mean smooth-L1 (torch F.smooth_l1_loss semantics)."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    m = mask.to(loss.dtype)
    num, den = all_sum_if(torch.stack([(loss * m).sum(), m.sum()]),
                          group).unbind(0)
    return num / den.clamp(min=1.0)


def _max(x, v: float):
    return torch.maximum(x, x.new_tensor(v))


def _clip(x, lo: float, hi: float):
    """jnp.clip with its gradient: half of it at either bound."""
    return torch.minimum(_max(x, lo), x.new_tensor(hi))


def silog_loss(depth_est, depth_gt, mask, variance_focus: float = 0.85,
               group=None):
    """Scale-invariant log loss over the masked pixels, x10."""
    m = mask.to(depth_est.dtype)
    d = (torch.log(_max(depth_est, 1e-8)) - torch.log(_max(depth_gt, 1e-8))) * m
    count, sq, total = all_sum_if(
        torch.stack([m.sum(), (d * d).sum(), d.sum()]), group).unbind(0)
    n = _max(count, 1.0)
    mean_sq = sq / n
    mean = total / n
    return torch.sqrt(_max(mean_sq - variance_focus * mean * mean, 1e-12)) * 10.0


def warp_by_disparity(image, disp):
    """The right view warped to the left by the disparity: image (B,H,W,C),
    disp (B,H,W) -> (warped (B,H,W,C), valid (B,H,W,1)).

    Linear sampling along W at x = w - disp; source columns outside
    [0, W-1] read zero. The gradient reaches ``disp`` through the
    interpolation weight alone (the floor, the clipped indices and the mask
    carry none); the gather's gradient to ``image`` is a scatter, so the
    image should not require one."""
    b, h, w, c = image.shape
    x = torch.arange(w, dtype=disp.dtype, device=disp.device) - disp
    x0 = torch.floor(x)
    frac = (x - x0)[..., None]
    i0 = x0.to(torch.int64)
    i1 = (i0 + 1).clamp(0, w - 1)
    i0 = i0.clamp(0, w - 1)
    g0 = torch.gather(image, 2, i0[..., None].expand(b, h, w, c))
    g1 = torch.gather(image, 2, i1[..., None].expand(b, h, w, c))
    out = g0 * (1.0 - frac) + g1 * frac
    valid = ((x >= 0) & (x <= w - 1)).to(image.dtype)[..., None]
    return out * valid, valid


def _avg_pool3(x):
    """3x3 window means of an NHWC map at stride 3, VALID."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1)


def ssim(x, y):
    """SSIM dissimilarity in [0, 1] over 3x3 windows at stride 3."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = _avg_pool3(x), _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return _clip((1.0 - num / den) / 2.0, 0.0, 1.0)


def photometric_loss(disp_est, left, right, group=None):
    """0.85 SSIM + 0.15 L1 reconstruction + 0.1 edge-aware smoothness.
    disp_est (B,H,W); left, right (B,H,W,C). Every term is a plain mean
    over equal slices, so under a group the loss averages over the ranks."""
    left_est, _ = warp_by_disparity(right, disp_est)
    recon = 0.85 * ssim(left, left_est).mean() \
        + 0.15 * (left - left_est).abs().mean()

    d = disp_est[..., None]
    dgx = d[:, :, :-1] - d[:, :, 1:]
    dgy = d[:, :-1, :] - d[:, 1:, :]
    igx = (left[:, :, :-1] - left[:, :, 1:]).mean(dim=-1, keepdim=True)
    igy = (left[:, :-1, :] - left[:, 1:, :]).mean(dim=-1, keepdim=True)
    wx = torch.exp(-igx.abs())
    wy = torch.exp(-igy.abs())
    smooth = (dgx.abs() * wx).mean() + (dgy.abs() * wy).mean()
    return all_mean_if(recon + 0.1 * smooth, group)
