"""The monocular-depth metric suite (counterpart of
rag_tpu/metrics/depth.py): silog, abs_rel, log10, rms, sq_rel, log_rms
and the delta < 1.25^{1,2,3} accuracies over the gt > 0 pixels, pooled
over the batch."""

from __future__ import annotations

import torch

from rag_tpu_torch.parallel.axis import all_sum_if

DEPTH_METRIC_NAMES = (
    "silog", "abs_rel", "log10", "rms", "sq_rel", "log_rms", "d1", "d2", "d3"
)


def depth_metrics(pred, gt, mask, group=None):
    """pred, gt, mask: (B,H,W). A dict of 0-d tensors over the masked
    pixels of the whole batch; under a data-parallel group the masked
    sums add up over the ranks in one all-reduce (``parallel.axis``)."""
    m = mask.to(pred.dtype)
    eps = 1e-12
    p = torch.maximum(pred, pred.new_tensor(eps))
    g = torch.maximum(gt, gt.new_tensor(eps))
    thresh = torch.maximum(g / p, p / g)
    err = torch.log(p) - torch.log(g)
    terms = {
        "d1": (thresh < 1.25).to(pred.dtype),
        "d2": (thresh < 1.25 ** 2).to(pred.dtype),
        "d3": (thresh < 1.25 ** 3).to(pred.dtype),
        "sq": (g - p) ** 2,
        "log_sq": (torch.log(g) - torch.log(p)) ** 2,
        "abs_rel": (g - p).abs() / g,
        "sq_rel": ((g - p) ** 2) / g,
        "err_sq": err ** 2,
        "err": err,
        "log10": (torch.log10(p) - torch.log10(g)).abs(),
    }
    sums = all_sum_if(torch.stack(
        [m.sum()] + [(x * m).sum() for x in terms.values()]), group)
    n = torch.maximum(sums[0], m.new_tensor(1.0))
    mean = {k: s / n for k, s in zip(terms, sums[1:])}
    silog = torch.sqrt(torch.clamp(mean["err_sq"] - mean["err"] ** 2,
                                   min=0.0)) * 100.0
    return {"silog": silog, "abs_rel": mean["abs_rel"],
            "log10": mean["log10"], "rms": torch.sqrt(mean["sq"]),
            "sq_rel": mean["sq_rel"], "log_rms": torch.sqrt(mean["log_sq"]),
            "d1": mean["d1"], "d2": mean["d2"], "d3": mean["d3"]}
