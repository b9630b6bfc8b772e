"""KITTI-style stereo metrics with the per-image protocol.

Counterpart of rag_tpu/metrics/stereo.py:
  * D1: err > 3px AND err/|gt| > 5%;  Thres(tau): err > tau;  EPE: mean |err|;
  * metrics are computed per image over the valid mask; an image whose mask
    covers less than 10% of its gt>0 area (or has no gt>0 pixel) is skipped,
    and the kept images' values are averaged.

``stereo_metrics`` takes ``mesh=None``: with a mesh each rank holds a
piece of the global batch, its data index's images (and, with a model
axis that splits H, its rows of them). Every image's sums (the mask and
gt > 0 counts, each term's masked sum) then add up over the world in one
all-reduce (``parallel.axis``), each rank writing its data index's slot,
and every rank takes the per-image means and the kept images' average
over the whole batch.
"""

from __future__ import annotations

import torch

from rag_tpu_torch.parallel.axis import all_sum_if


def _pixel_terms(d_est, d_gt):
    """Per pixel: |err| (EPE), the D1 outlier flag and err > tau for tau
    1, 2, 3."""
    err = (d_gt - d_est).abs()
    bad = (err > 3.0) & (err / d_gt.abs().clamp(min=1e-12) > 0.05)
    return {"EPE": err, "D1": bad.to(d_est.dtype),
            **{f"Thres{t}": (err > float(t)).to(d_est.dtype)
               for t in (1, 2, 3)}}


def stereo_metrics(d_est, d_gt, mask, mesh=None):
    """All standard scalars, as 0-d tensors: each the kept images' mean of
    its per-image masked mean (over the global batch with a ``mesh``)."""
    dims = tuple(range(1, d_gt.ndim))
    m = mask.to(d_gt.dtype)
    terms = _pixel_terms(d_est, d_gt)
    per_image = torch.stack(
        [m.sum(dim=dims), (d_gt > 0).to(d_gt.dtype).sum(dim=dims)]
        + [(v * m).sum(dim=dims) for v in terms.values()], dim=1)
    if mesh is not None:
        buf = per_image.new_zeros((mesh.data,) + tuple(per_image.shape))
        buf[mesh.d] = per_image
        per_image = all_sum_if(buf, mesh.group).flatten(0, 1)
    mask_sum, gt_sum = per_image[:, 0], per_image[:, 1]
    # kept: 10 * |mask| >= |gt > 0| and |gt > 0| > 0 (sum form, exact at
    # the 10% boundary)
    weights = ((10.0 * mask_sum >= gt_sum) & (gt_sum > 0)).to(d_gt.dtype)
    means = per_image[:, 2:] / mask_sum.clamp(min=1.0)[:, None]
    total = weights.sum()
    return {k: torch.where(total > 0,
                           (means[:, i] * weights).sum() / total.clamp(min=1),
                           torch.zeros_like(total))
            for i, k in enumerate(terms)}
