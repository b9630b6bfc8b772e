"""MdeNAS cell search: multinomial op sampling with the pairwise
epoch/accuracy probability update.

Counterpart of rag_tpu/search/mdenas.py (CellSearch without its mid-search
state files, fault injection and mesh; DepthCellSearch is not ported). Per
epoch: sample one op per edge from the categorical p, train that single
path of the supernet for an epoch, score it on the held-out half, then
update p with the pairwise rule

    v1[j] = #{i : h_e[j] < h_e[i] and h_a[j] > h_a[i]}
    v2[j] = #{i : h_e[j] > h_e[i] and h_a[j] < h_a[i]}
    p += lr_a * (v1 - v2);  p = softmax(p)

The update and the sampling are host numpy in float64, seeded as rag_tpu
seeds them, so both packages sample the same ops from the same p.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from rag_tpu_torch.data.stereo_dataset import split_half
from rag_tpu_torch.metrics.meters import AverageMeterDict
from rag_tpu_torch.metrics.stereo import stereo_metrics
from rag_tpu_torch.models.supernet import NUM_EDGES, init_supernet, supernet_forward
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.search.genotype import Genotype, parse_genotype
from rag_tpu_torch.train.trainer import (
    clone_tree,
    cosine_lr,
    differentiable,
    grads_of,
    make_optimizer,
    sgd_apply,
    supervised_loss,
)


def mdenas_update(p: np.ndarray, h_e: np.ndarray, h_a: np.ndarray,
                  lr_a: float) -> np.ndarray:
    """One pairwise probability update (vectorized over leading dims).

    p, h_e, h_a: (..., num_ops). Returns the new softmaxed p.
    """
    dh_e = h_e[..., None, :] - h_e[..., :, None]  # [.., i, j] = h[j]-h[i]
    dh_a = h_a[..., None, :] - h_a[..., :, None]
    v1 = np.sum((dh_e < 0) & (dh_a > 0), axis=-2)
    v2 = np.sum((dh_e > 0) & (dh_a < 0), axis=-2)
    p = p + lr_a * (v1 - v2).astype(np.float64)
    e = np.exp(p - p.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


@dataclasses.dataclass
class CellSearchConfig:
    epochs: int = 100
    batch: int = 8
    lr: float = 0.002
    lr_a: float = 0.01
    weight_decay: float = 3e-4
    lr_min: float = 0.001
    grad_clip: float = 5.0
    num_ops: int = 2
    seed: int = 0
    maxdisp: int = 192


def make_supernet_train_step(optimizer, maxdisp: int,
                             variants: KernelVariants = DEFAULT):
    """step(params, stats, opt_state, lr, left, right, disp_gt, fea_ops,
    mat_ops) -> (params, new_stats, opt_state, scalars): every BatchNorm
    in train mode, SGD on every leaf (an unsampled edge's gradient is
    zero; weight decay and momentum still move it, as under optax).
    ``params`` and ``opt_state`` update in place."""

    def step(params, stats, opt_state, lr, left, right, disp_gt, fea_ops,
             mat_ops):
        handles, p_diff = differentiable(params, frozenset(params))
        with torch.enable_grad():
            disp, new_stats = supernet_forward(
                p_diff, stats, left, right, fea_ops, mat_ops, train=True,
                maxdisp=maxdisp, variants=variants)
            loss, mask = supervised_loss(disp, disp_gt, maxdisp)
            grads = grads_of(loss, handles)
        sgd_apply(optimizer, params, grads, opt_state, lr)
        with torch.no_grad():
            scalars = {"loss": loss.detach(),
                       **stereo_metrics(disp.detach(), disp_gt, mask)}
        return params, new_stats, opt_state, scalars

    return step


def make_supernet_eval_step(maxdisp: int, variants: KernelVariants = DEFAULT):
    """step(params, stats, left, right, disp_gt, fea_ops, mat_ops) ->
    scalars, with every BatchNorm frozen."""

    @torch.inference_mode()
    def step(params, stats, left, right, disp_gt, fea_ops, mat_ops):
        disp, _ = supernet_forward(params, stats, left, right, fea_ops,
                                   mat_ops, train=False, maxdisp=maxdisp,
                                   variants=variants)
        loss, mask = supervised_loss(disp, disp_gt, maxdisp)
        return {"loss": loss, **stereo_metrics(disp, disp_gt, mask)}

    return step


class CellSearch:
    """Searches one Genotype per task on a fresh supernet, initialized from
    ``torch.Generator().manual_seed(config.seed)`` on ``device``, or from
    ``weights`` = (params, stats) trees when given."""

    def __init__(self, config: CellSearchConfig,
                 log: Optional[Callable] = print, device="cuda",
                 variants: KernelVariants = DEFAULT, weights=None):
        self.cfg = config
        self.log = log or (lambda *_: None)
        if weights is None:
            weights = init_supernet(
                torch.Generator().manual_seed(config.seed), device)
        self.params, self.stats = weights
        self.optimizer = make_optimizer(config.weight_decay, config.grad_clip)
        self.opt_state = self.optimizer.init(self.params)
        self.p = {
            "normal": np.full((NUM_EDGES, config.num_ops), 1.0 / config.num_ops),
            "reduce": np.full((NUM_EDGES, config.num_ops), 1.0 / config.num_ops),
        }
        self._train_step = make_supernet_train_step(
            self.optimizer, config.maxdisp, variants)
        self._eval_step = make_supernet_eval_step(config.maxdisp, variants)

    @staticmethod
    def _batch_args(b):
        return (b["left"], b["right"], b["disparity"])

    @staticmethod
    def _quality(vm):
        """Reward quality in [0,1], higher=better (1 - valid_D1)."""
        return 1.0 - min(max(vm.get("D1", 1.0), 0.0), 1.0)

    def genotype(self) -> Genotype:
        return parse_genotype(self.p["normal"], self.p["reduce"])

    def search(self, train_data, writer=None, task: int = 0) -> Genotype:
        """The MdeNAS loop; returns the genotype of the best-by-valid-loss
        epoch's p, with that epoch's params restored (the statistics and
        the optimizer state stay the last epoch's, as in rag_tpu).

        train_data: a dataset with .batches(batch, shuffle, seed, indices)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1000 * task)
        train_idx, valid_idx = split_half(len(train_data),
                                          seed=cfg.seed + 1000 * task)

        h_e = {k: np.zeros((NUM_EDGES, cfg.num_ops), np.int64) for k in self.p}
        h_a = {k: np.zeros((NUM_EDGES, cfg.num_ops), np.float64) for k in self.p}
        best_loss, best_p, best_params = np.inf, None, None
        for epoch in range(cfg.epochs):
            lr = cosine_lr(cfg.lr, cfg.epochs, epoch, cfg.lr_min)
            ops = {
                k: np.array([rng.choice(cfg.num_ops, p=self.p[k][e])
                             for e in range(NUM_EDGES)], np.int32)
                for k in self.p
            }
            outs = []
            for b in train_data.batches(cfg.batch, True, seed=epoch,
                                        indices=train_idx):
                self.params, self.stats, self.opt_state, scalars = \
                    self._train_step(self.params, self.stats, self.opt_state,
                                     lr, *self._batch_args(b), ops["normal"],
                                     ops["reduce"])
                outs.append(scalars)
            train_m = AverageMeterDict().update_batched(outs)
            valid_m = AverageMeterDict().update_batched(
                [self._eval_step(self.params, self.stats,
                                 *self._batch_args(b), ops["normal"],
                                 ops["reduce"])
                 for b in train_data.batches(cfg.batch, False, seed=0,
                                             indices=valid_idx)])

            tm, vm = train_m.mean(), valid_m.mean()
            quality = self._quality(vm)
            self.log(
                f"[cell-search t{task}] epoch {epoch} lr {lr:.4f} "
                f"train loss {tm.get('loss', 0):.3f} "
                f"valid loss {vm.get('loss', 0):.3f} quality {quality:.3f}")
            if writer is not None:
                writer.scalars(f"search_cell/task{task}",
                               {"train_loss": tm.get("loss", 0.0),
                                "valid_loss": vm.get("loss", 0.0),
                                "quality": quality}, step=epoch)

            for k in self.p:
                for e in range(NUM_EDGES):
                    h_e[k][e, ops[k][e]] += 1
                    h_a[k][e, ops[k][e]] = quality
                self.p[k] = mdenas_update(self.p[k], h_e[k], h_a[k], cfg.lr_a)

            if vm.get("loss", np.inf) < best_loss:
                best_loss = vm.get("loss", np.inf)
                best_p = {k: v.copy() for k, v in self.p.items()}
                # a copy: the train step updates self.params in place
                best_params = clone_tree(self.params)

        if best_p is not None:
            self.p = best_p
        if best_params is not None:
            self.params = best_params
        geno = self.genotype()
        self.log(f"[cell-search t{task}] best genotype: {geno}")
        return geno
