"""The continual monocular-depth driver (counterpart of
rag_tpu/continual/depth_driver.py).

The stereo driver's search -> grow -> select -> fine-tune pipeline over
GrowableDepthNet, with silog training and the depth metric suite; the
cell search is MdeNAS over the depth supernet (DepthCellSearch). Only the
variant hooks differ, so stage files, resume and the router are the
base's; the router routes on the image. The depth path is 2D convs,
BatchNorm and matrix resizes: it launches no hand-written kernel.

``SyntheticDepthDataset`` is a fixed, seeded set of images with a depth
cue (brightness ~ 1/depth) and exact ground truth, styled per scene by
WEATHER_STYLES, with rag_tpu's bytes for every seed and style.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from rag_tpu_torch.continual.driver import ContinualDriver, ExperimentConfig
from rag_tpu_torch.data.synthetic import (
    DeviceCache,
    SyntheticStereoDataset,
    _apply_style,
)
from rag_tpu_torch.metrics.depth import DEPTH_METRIC_NAMES
from rag_tpu_torch.metrics.meters import ForgettingMatrix
from rag_tpu_torch.models.growable import GrowableDepthNet
from rag_tpu_torch.search.mdenas import DepthCellSearch
from rag_tpu_torch.train.trainer import (
    make_depth_eval_step,
    make_depth_train_step,
)


class SyntheticDepthDataset(SyntheticStereoDataset):
    """``num_samples`` seeded (image, depth) samples, made once and
    revisited shuffled every epoch; batches are dicts of image (B,H,W,3)
    and depth (B,H,W) tensors on ``device``, held there by ``cache`` (the
    stereo sets' DeviceCache). Depth is blocky, uniform in [2, max_depth]
    over 4x4 tiles; the image a noise texture plus 10 / depth, then the
    scene's ``style``."""

    def __init__(self, num_samples: int, h: int, w: int, seed: int = 0,
                 max_depth: float = 60.0, style: Optional[Dict] = None,
                 device="cuda", cache: Optional[DeviceCache] = None):
        super().__init__(num_samples, h, w, seed=seed, style=style,
                         device=device, cache=cache)
        self.max_depth = max_depth

    def _samples(self) -> Dict[str, np.ndarray]:
        if self._cache is None:
            rng = np.random.default_rng(self.seed)
            n = self.num_samples
            th, tw = max(self.h // 4, 1), max(self.w // 4, 1)
            tiles = rng.uniform(2.0, self.max_depth,
                                (n, (self.h + th - 1) // th,
                                 (self.w + tw - 1) // tw))
            depth = np.repeat(np.repeat(tiles, th, 1), tw, 2)
            depth = depth[:, :self.h, :self.w].astype(np.float32)
            base = rng.standard_normal(
                (n, self.h, self.w, 3)).astype(np.float32) * 0.3
            cue = (1.0 / depth)[..., None] * 10.0
            image = (base + cue).astype(np.float32)
            if self.style:
                image, _ = _apply_style(rng, image, image, self.style)
            self._cache = {"image": image, "depth": depth}
        return self._cache


class DepthContinualDriver(ContinualDriver):
    """ContinualDriver over the depth net: its forgetting matrix tracks
    the loss and the nine depth metrics."""

    router_input = "image"
    headline = "silog"

    def __init__(self, config: ExperimentConfig, **kw):
        super().__init__(config, **kw)
        self.matrix = ForgettingMatrix(config.num_tasks,
                                       ("loss",) + DEPTH_METRIC_NAMES)

    def _new_net(self, genotype, seed: int):
        return GrowableDepthNet.initial(genotype, seed, self.device)

    def _cell_search_cls(self):
        return DepthCellSearch

    def _op_search_variant(self) -> str:
        return "depth"

    def _ft_steps(self, specs, trainable, optimizer):
        mesh = self._mesh_for(self.cfg.train.batch, "fine-tune")
        return (make_depth_train_step(specs, trainable, optimizer, mesh=mesh,
                                      precision=self.cfg.precision),
                make_depth_eval_step(specs, mesh=mesh,
                                     precision=self.cfg.precision))

    def _eval_step_for(self, specs):
        return make_depth_eval_step(specs, precision=self.cfg.precision)

    @staticmethod
    def _batch_args(b):
        return (b["image"], b["depth"])

    def _ft_tag(self) -> str:
        return "depth_train"

    @staticmethod
    def _head_text(v) -> str:
        # silog and the delta < 1.25 accuracy
        return f"silog {v.get('silog', 0):.3f} d1 {v.get('d1', 0):.3f}"
