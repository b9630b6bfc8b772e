"""KITTI-style stereo metrics with the per-image protocol.

Counterpart of rag_tpu/metrics/stereo.py:
  * D1: err > 3px AND err/|gt| > 5%;  Thres(tau): err > tau;  EPE: mean |err|;
  * metrics are computed per image over the valid mask; an image whose mask
    covers less than 10% of its gt>0 area (or has no gt>0 pixel) is skipped,
    and the kept images' values are averaged.
"""

from __future__ import annotations

import torch


def _per_image(vals, weights):
    total = weights.sum()
    return torch.where(total > 0, (vals * weights).sum() / total.clamp(min=1),
                       torch.zeros_like(total))


def _image_weights(d_gt, mask):
    """1.0 for kept images: 10 * |mask| >= |gt > 0| and |gt > 0| > 0 (sum
    form, exact at the 10% boundary)."""
    dims = tuple(range(1, d_gt.ndim))
    mask_sum = mask.to(d_gt.dtype).sum(dim=dims)
    gt_sum = (d_gt > 0).to(d_gt.dtype).sum(dim=dims)
    return ((10.0 * mask_sum >= gt_sum) & (gt_sum > 0)).to(d_gt.dtype)


def _masked_image_mean(x, mask):
    dims = tuple(range(1, x.ndim))
    m = mask.to(x.dtype)
    return (x * m).sum(dim=dims) / m.sum(dim=dims).clamp(min=1.0)


def d1_metric(d_est, d_gt, mask):
    err = (d_gt - d_est).abs()
    bad = (err > 3.0) & (err / d_gt.abs().clamp(min=1e-12) > 0.05)
    return _per_image(_masked_image_mean(bad.to(d_est.dtype), mask),
                      _image_weights(d_gt, mask))


def thres_metric(d_est, d_gt, mask, tau):
    err = (d_gt - d_est).abs()
    return _per_image(_masked_image_mean((err > tau).to(d_est.dtype), mask),
                      _image_weights(d_gt, mask))


def epe_metric(d_est, d_gt, mask):
    err = (d_gt - d_est).abs()
    return _per_image(_masked_image_mean(err, mask), _image_weights(d_gt, mask))


def stereo_metrics(d_est, d_gt, mask):
    """All standard scalars, as 0-d tensors."""
    return {
        "EPE": epe_metric(d_est, d_gt, mask),
        "D1": d1_metric(d_est, d_gt, mask),
        "Thres1": thres_metric(d_est, d_gt, mask, 1.0),
        "Thres2": thres_metric(d_est, d_gt, mask, 2.0),
        "Thres3": thres_metric(d_est, d_gt, mask, 3.0),
    }
