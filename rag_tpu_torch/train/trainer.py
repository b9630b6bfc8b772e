"""Evaluation step (counterpart of rag_tpu/train/trainer.py::make_eval_step
and ``supervised_loss``). The training step arrives with the training
slice."""

from __future__ import annotations

from typing import Mapping

import torch

from rag_tpu_torch.metrics.stereo import stereo_metrics
from rag_tpu_torch.models.stereo import MAXDISP, stereo_forward
from rag_tpu_torch.train.losses import smooth_l1_masked


def supervised_loss(disp, disp_gt, maxdisp: int = MAXDISP):
    mask = (disp_gt > 0) & (disp_gt < maxdisp)
    return smooth_l1_masked(disp, disp_gt, mask), mask


def make_eval_step(specs: Mapping, maxdisp: int = MAXDISP):
    """step(params, stats, left, right, disp_gt) -> dict of 0-d tensors:
    the frozen-BN serving forward, the masked loss and the stereo metrics."""

    @torch.inference_mode()
    def step(params, stats, left, right, disp_gt):
        disp = stereo_forward(specs, params, stats, left, right, maxdisp=maxdisp)
        loss, mask = supervised_loss(disp, disp_gt, maxdisp)
        return {"loss": loss, **stereo_metrics(disp, disp_gt, mask)}

    return step
