"""Serving-time inference over a grown network, with Scene-Router path
selection.

Counterpart of rag_tpu/continual/inference.py::RoutedInference. A frame
runs through its task's path: the task is given, or (task=None) the
router picks it per frame, and without a router every frame goes to task
0, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rag_tpu_torch.metrics.meters import AverageMeterDict
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.router import SceneRouter
from rag_tpu_torch.models.stereo import stereo_forward
from rag_tpu_torch.ops.precision import FP32, Precision
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.train.trainer import make_eval_step


class RoutedInference:
    """Per-frame path selection + disparity prediction/evaluation.

    The net's and the router's tensors are moved to ``device``; inputs are
    numpy arrays or tensors (B,H,W,3) and go to the same device once.
    ``variants`` picks the optional kernels every request runs (see
    ops.variants), ``precision`` the activations' dtypes (ops.precision;
    the router and the disparity stay float32)."""

    def __init__(self, net: GrowableStereoNet,
                 router: Optional[SceneRouter] = None, maxdisp: int = 192,
                 device="cuda", variants: KernelVariants = DEFAULT,
                 precision: Precision = FP32):
        self.device = torch.device(device)
        self.net = net.to(self.device)
        self.router = None if router is None else router.to(self.device)
        self.maxdisp = maxdisp
        self.variants = variants
        self.precision = precision

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def route(self, left) -> np.ndarray:
        """(B,) task ids for a batch of left frames (no router: task 0)."""
        if self.router is None:
            return np.zeros(left.shape[0], np.int64)
        return self.router.predict(self._tensor(left))

    def _groups(self, tasks: np.ndarray, *frames: torch.Tensor):
        """(task, frame indices, the frames of that task) per routed task;
        a batch routed to one task is passed on whole."""
        for t in np.unique(tasks):
            idx = np.nonzero(tasks == t)[0]
            if len(idx) == len(tasks):
                yield int(t), idx, frames
            else:
                sel = torch.as_tensor(idx, device=self.device)
                yield int(t), idx, tuple(f[sel] for f in frames)

    @torch.inference_mode()
    def _predict_task(self, t: int, left, right) -> np.ndarray:
        specs, params, stats = self.net.path(self.net.archis[t])
        disp, _ = stereo_forward(specs, params, stats, left, right,
                                 maxdisp=self.maxdisp, variants=self.variants,
                                 precision=self.precision)
        return disp.cpu().numpy()

    def predict(self, left, right, task: Optional[int] = None) -> np.ndarray:
        """Disparity (B,H,W) for a batch; task=None -> per-frame routing."""
        left, right = self._tensor(left), self._tensor(right)
        if task is not None:
            return self._predict_task(task, left, right)
        tasks = self.route(left)
        out = np.zeros(tuple(left.shape[:3]), np.float32)
        for t, idx, (lt, rt) in self._groups(tasks, left, right):
            out[idx] = self._predict_task(t, lt, rt)
        return out

    def evaluate(self, dataset, task: Optional[int] = None,
                 batch: int = 1) -> Dict[str, float]:
        """Mean metrics over ``dataset.batches(batch, False, seed=0,
        drop_last=False)`` on a fixed task path, or routed per frame (one
        entry per batch and routed task, as the reference averages)."""
        outs = []
        for b in dataset.batches(batch, False, seed=0, drop_last=False):
            frames = tuple(self._tensor(b[k])
                           for k in ("left", "right", "disparity"))
            tasks = (np.full(frames[0].shape[0], task) if task is not None
                     else self.route(frames[0]))
            for t, _, (left, right, gt) in self._groups(tasks, *frames):
                specs, params, stats = self.net.path(self.net.archis[t])
                step = make_eval_step(specs, maxdisp=self.maxdisp,
                                      variants=self.variants,
                                      precision=self.precision)
                outs.append(step(params, stats, left, right, gt))
        return AverageMeterDict().update_batched(outs).mean()
