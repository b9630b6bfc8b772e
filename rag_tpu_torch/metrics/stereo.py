"""KITTI-style stereo metrics with the per-image protocol.

Counterpart of rag_tpu/metrics/stereo.py:
  * D1: err > 3px AND err/|gt| > 5%;  Thres(tau): err > tau;  EPE: mean |err|;
  * metrics are computed per image over the valid mask; an image whose mask
    covers less than 10% of its gt>0 area (or has no gt>0 pixel) is skipped,
    and the kept images' values are averaged.

``stereo_metrics`` takes ``group=None``: under a data-parallel group the
kept images' count and every metric's sum add up over the ranks in one
all-reduce (``parallel.axis``), giving the global batch's averages.
"""

from __future__ import annotations

import torch

from rag_tpu_torch.parallel.axis import all_sum_if


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


def _pixel_terms(d_est, d_gt):
    """Per pixel: |err| (EPE), the D1 outlier flag and err > tau for tau
    1, 2, 3."""
    err = (d_gt - d_est).abs()
    bad = (err > 3.0) & (err / d_gt.abs().clamp(min=1e-12) > 0.05)
    return {"EPE": err, "D1": bad.to(d_est.dtype),
            **{f"Thres{t}": (err > float(t)).to(d_est.dtype)
               for t in (1, 2, 3)}}


def stereo_metrics(d_est, d_gt, mask, group=None):
    """All standard scalars, as 0-d tensors: each the kept images' mean of
    its per-image masked mean."""
    weights = _image_weights(d_gt, mask)
    terms = _pixel_terms(d_est, d_gt)
    sums = all_sum_if(torch.stack(
        [weights.sum()] + [(_masked_image_mean(v, mask) * weights).sum()
                           for v in terms.values()]), group)
    total = sums[0]
    return {k: torch.where(total > 0, sums[i + 1] / total.clamp(min=1),
                           torch.zeros_like(total))
            for i, k in enumerate(terms)}
