"""Serving-time inference over a grown network.

Counterpart of rag_tpu/continual/inference.py::RoutedInference. A frame
runs through its task's path: the task is given, or (task=None) the router
picks it. The Scene Router is not ported yet, so routing sends every frame
to task 0, as the reference does when it has no router.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rag_tpu_torch.metrics.meters import AverageMeterDict
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.stereo import stereo_forward
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.train.trainer import make_eval_step


class RoutedInference:
    """Per-frame path selection + disparity prediction/evaluation.

    The net's tensors are moved to ``device``; inputs are numpy arrays or
    tensors (B,H,W,3) and go to the same device. ``variants`` picks the
    optional kernels every request runs (see ops.variants)."""

    def __init__(self, net: GrowableStereoNet, maxdisp: int = 192,
                 device="cuda", variants: KernelVariants = DEFAULT):
        self.device = torch.device(device)
        self.net = net.to(self.device)
        self.maxdisp = maxdisp
        self.variants = variants

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def route(self, left) -> np.ndarray:
        """(B,) task ids for a batch of left frames (no router: task 0)."""
        return np.zeros(left.shape[0], np.int64)

    @torch.inference_mode()
    def _predict_task(self, t: int, left, right) -> np.ndarray:
        specs, params, stats = self.net.path(self.net.archis[t])
        disp, _ = stereo_forward(specs, params, stats, self._tensor(left),
                                 self._tensor(right), maxdisp=self.maxdisp,
                                 variants=self.variants)
        return disp.cpu().numpy()

    def predict(self, left, right, task: Optional[int] = None) -> np.ndarray:
        """Disparity (B,H,W) for a batch; task=None -> per-frame routing."""
        if task is not None:
            return self._predict_task(task, left, right)
        tasks = self.route(left)
        out = np.zeros(tuple(left.shape[:3]), np.float32)
        for t in np.unique(tasks):
            idx = np.nonzero(tasks == t)[0]
            out[idx] = self._predict_task(int(t), left[idx], right[idx])
        return out

    def evaluate(self, dataset, task: Optional[int] = None,
                 batch: int = 1) -> Dict[str, float]:
        """Mean metrics over ``dataset.batches(batch, False, seed=0,
        drop_last=False)`` on a fixed task path, or routed per frame."""
        outs = []
        for b in dataset.batches(batch, False, seed=0, drop_last=False):
            tasks = (np.full(b["left"].shape[0], task) if task is not None
                     else self.route(b["left"]))
            for t in np.unique(tasks):
                idx = np.nonzero(tasks == t)[0]
                specs, params, stats = self.net.path(self.net.archis[int(t)])
                step = make_eval_step(specs, maxdisp=self.maxdisp,
                                      variants=self.variants)
                outs.append(step(params, stats, self._tensor(b["left"][idx]),
                                 self._tensor(b["right"][idx]),
                                 self._tensor(b["disparity"][idx])))
        return AverageMeterDict().update_batched(outs).mean()
