"""The self-supervised continual stereo driver.

Counterpart of rag_tpu/continual/self_supervised.py. Its deltas from the
supervised driver are variant hooks of ContinualDriver, so the pipeline,
the stage files and resume are the base's:
  * per task, a supervised pretrain on synthetic data (``pretrain_data``)
    before the fine-tune, skipped where the fine-tune's stage file exists
    (the fine-tune then resumes from it);
  * the fine-tune trains on the photometric loss (no ground truth);
  * the op search trains and scores on proxy pairs colour-matched to the
    current scene's left frames, with an 0.8 weight-training split and
    scoring truncated to ``op_eval_max_batches`` batches.
On the card the pretrain and the fine-tune run kernels A-D and G (E where
a feature-net site trains, F where stem_3d0 does), the cell search A and
D, every evaluation A-C.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from rag_tpu_torch.continual.driver import ContinualDriver, ExperimentConfig
from rag_tpu_torch.data.transfer import ColorTransferDataset
from rag_tpu_torch.train.trainer import (
    cosine_lr,
    make_eval_step,
    make_optimizer,
    make_selfsup_train_step,
    make_train_step,
)

PROXY_POOL_BATCHES = 8   # real-frame pool: 8 batches of 2 left frames


@dataclasses.dataclass
class SelfSupConfig(ExperimentConfig):
    pretrain_epochs: int = 9
    pretrain_batch: int = 8
    pretrain_lr: float = 0.001
    # the op search's weight-training share and its scoring cut
    op_split_frac: float = 0.8
    op_eval_max_batches: Optional[int] = 10


class SelfSupContinualDriver(ContinualDriver):
    """ContinualDriver with the supervised pretrain and the photometric
    fine-tune. pretrain_data: one supervised synthetic dataset shared by
    the tasks; proxy_search_data: the op search's pairs, colour-matched
    per task to the scene's left frames."""

    def __init__(self, config: SelfSupConfig, pretrain_data=None,
                 proxy_search_data=None, **kw):
        super().__init__(config, **kw)
        self.pretrain_data = pretrain_data
        self.proxy_search_data = proxy_search_data

    def _proxy_for(self, t: int, train_data):
        """The proxy set colour-matched to a pool of the scene's left
        frames: the first PROXY_POOL_BATCHES batches of 2 of
        ``batches(2, False, seed=0)``."""
        if self.proxy_search_data is None:
            return train_data
        pool = []
        for b in train_data.batches(2, False, seed=0):
            pool.append(b["left"])
            if len(pool) >= PROXY_POOL_BATCHES:
                break
        if not pool:
            return self.proxy_search_data
        return ColorTransferDataset(self.proxy_search_data,
                                    torch.cat(pool).cpu().numpy())

    # -- variant hooks --------------------------------------------------------

    def _ft_steps(self, specs, trainable, optimizer):
        mesh = self._mesh_for(self.cfg.train.batch, "fine-tune")
        return (make_selfsup_train_step(specs, trainable, optimizer,
                                        maxdisp=self.cfg.maxdisp,
                                        variants=self.variants, mesh=mesh,
                                        precision=self.cfg.precision),
                make_eval_step(specs, maxdisp=self.cfg.maxdisp,
                               variants=self.variants, mesh=mesh,
                               precision=self.cfg.precision))

    def _ft_tag(self) -> str:
        return "selfsup"

    def _op_search_cfg(self):
        return dataclasses.replace(
            self.cfg.op, maxdisp=self.cfg.maxdisp,
            split_frac=self.cfg.op_split_frac,
            eval_max_batches=self.cfg.op_eval_max_batches)

    def _search_data_for(self, t: int, train_data):
        return self._proxy_for(t, train_data)

    def _pre_finetune(self, t: int) -> None:
        if self._should_pretrain(t):
            self.pretrain(t)

    def _should_pretrain(self, t: int) -> bool:
        """No pretrain set, or a fine-tune stage file to resume from: no
        pretrain."""
        if self.pretrain_data is None:
            return False
        ckpt = self._stage_ckpt(f"finetune_t{t}.npz")
        return not (ckpt and os.path.exists(ckpt))

    def pretrain(self, t: int):
        """Supervised warm-up of archis[t] on the pretrain set: its
        trainable sites, make_train_step under the cosine schedule over
        pretrain_epochs; the result is written back."""
        cfg = self.cfg
        net = self.net
        arch = net.archis[t]
        trainable = net.trainable_sites(t)
        specs, params, stats = net.path(arch)
        optimizer = make_optimizer(cfg.train.weight_decay, cfg.train.grad_clip)
        step = make_train_step(specs, trainable, optimizer,
                               maxdisp=cfg.maxdisp, variants=self.variants,
                               mesh=self._mesh_for(cfg.pretrain_batch,
                                                   "pretrain"),
                               precision=cfg.precision)
        opt_state = optimizer.init(params)
        for epoch in range(cfg.pretrain_epochs):
            lr = cosine_lr(cfg.pretrain_lr, cfg.pretrain_epochs, epoch)
            for b in self.pretrain_data.batches(cfg.pretrain_batch, True,
                                                seed=epoch):
                params, stats, opt_state, sc = step(
                    params, stats, opt_state, lr,
                    b["left"], b["right"], b["disparity"])
            self.log(f"[pretrain t{t}] epoch {epoch} "
                     f"loss {float(sc['loss']):.3f}")
        net.write_back(arch, params, stats)
        self._replicate()
