"""The monocular-depth metric suite (counterpart of
rag_tpu/metrics/depth.py): silog, abs_rel, log10, rms, sq_rel, log_rms
and the delta < 1.25^{1,2,3} accuracies over the gt > 0 pixels, pooled
over the batch."""

from __future__ import annotations

import torch

DEPTH_METRIC_NAMES = (
    "silog", "abs_rel", "log10", "rms", "sq_rel", "log_rms", "d1", "d2", "d3"
)


def depth_metrics(pred, gt, mask):
    """pred, gt, mask: (B,H,W). A dict of 0-d tensors over the masked
    pixels of the whole batch."""
    m = mask.to(pred.dtype)
    n = torch.maximum(m.sum(), m.new_tensor(1.0))
    eps = 1e-12
    p = torch.maximum(pred, pred.new_tensor(eps))
    g = torch.maximum(gt, gt.new_tensor(eps))

    def mmean(x):
        return (x * m).sum() / n

    thresh = torch.maximum(g / p, p / g)
    d1 = mmean((thresh < 1.25).to(pred.dtype))
    d2 = mmean((thresh < 1.25 ** 2).to(pred.dtype))
    d3 = mmean((thresh < 1.25 ** 3).to(pred.dtype))

    rms = torch.sqrt(mmean((g - p) ** 2))
    log_rms = torch.sqrt(mmean((torch.log(g) - torch.log(p)) ** 2))
    abs_rel = mmean((g - p).abs() / g)
    sq_rel = mmean(((g - p) ** 2) / g)

    err = torch.log(p) - torch.log(g)
    silog = torch.sqrt(torch.clamp(mmean(err ** 2) - mmean(err) ** 2,
                                   min=0.0)) * 100.0
    log10 = mmean((torch.log10(p) - torch.log10(g)).abs())
    return {"silog": silog, "abs_rel": abs_rel, "log10": log10, "rms": rms,
            "sq_rel": sq_rel, "log_rms": log_rms, "d1": d1, "d2": d2,
            "d3": d3}
