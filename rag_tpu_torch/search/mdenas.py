"""MdeNAS cell search: multinomial op sampling with the pairwise
epoch/accuracy probability update.

Counterpart of rag_tpu/search/mdenas.py (CellSearch, with its mid-search
state file and fault injection, and DepthCellSearch). With a ``mesh``
the supernet's steps run data-parallel (``train.trainer``); the sampled
ops and the probability update stay on the host, the same on every
rank. Per
epoch: sample one op per edge from the categorical p, train that single
path of the supernet for an epoch, score it on the held-out half, then
update p with the pairwise rule

    v1[j] = #{i : h_e[j] < h_e[i] and h_a[j] > h_a[i]}
    v2[j] = #{i : h_e[j] > h_e[i] and h_a[j] < h_a[i]}
    p += lr_a * (v1 - v2);  p = softmax(p)

The update and the sampling are host numpy in float64, seeded as rag_tpu
seeds them, so both packages sample the same ops from the same p.

The state file (``save_state`` / ``load_state``) holds everything the loop
depends on, in rag_tpu's layout, so that each package resumes the other's
file and an interrupted and resumed search equals an uninterrupted one:
the epoch, p, h_e and h_a, the numpy Generator's bit state as JSON, the
best loss, p and params, and the live params, statistics and momentum.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from rag_tpu_torch.continual.state import (
    from_leaves,
    leaf_arrays,
    savez_atomic,
    tree_device,
)
from rag_tpu_torch.data.stereo_dataset import split_half
from rag_tpu_torch.metrics.depth import depth_metrics
from rag_tpu_torch.metrics.meters import AverageMeterDict
from rag_tpu_torch.metrics.stereo import stereo_metrics
from rag_tpu_torch.models.supernet import (
    NUM_EDGES,
    depth_supernet_forward,
    init_depth_supernet,
    init_supernet,
    supernet_forward,
)
from rag_tpu_torch.ops.precision import FP32, Precision
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.parallel.axis import data_group
from rag_tpu_torch.search.genotype import Genotype, parse_genotype
from rag_tpu_torch.train.trainer import (
    clone_tree,
    cosine_lr,
    dp_only,
    local_batch,
    make_optimizer,
    supervised_loss,
    train_update,
)
from rag_tpu_torch.train.losses import silog_loss

# what CellSearch.steps yields: after each step it enqueues, and at an
# epoch's end before it reads the epoch's scalars back
BATCH, EPOCH = "batch", "epoch"


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
                             variants: KernelVariants = DEFAULT, mesh=None,
                             precision: Precision = FP32):
    """step(params, stats, opt_state, lr, left, right, disp_gt, fea_ops,
    mat_ops) -> (params, new_stats, opt_state, scalars): every BatchNorm
    in train mode, SGD on every leaf (an unsampled edge's gradient is
    zero; weight decay and momentum still move it, as under optax).
    ``params`` and ``opt_state`` update in place. mesh: data parallelism
    over its ranks, as in train.trainer."""
    group = data_group(dp_only(mesh, "make_supernet_train_step"))

    def step(params, stats, opt_state, lr, left, right, disp_gt, fea_ops,
             mat_ops):
        left, right, disp_gt = local_batch(mesh, left, right, disp_gt)

        def forward(p):
            disp, new_stats = supernet_forward(
                p, stats, left, right, fea_ops, mat_ops, train=True,
                maxdisp=maxdisp, variants=variants, precision=precision)
            loss, _ = supervised_loss(disp, disp_gt, maxdisp, group)
            return loss, disp, new_stats

        loss, disp, new_stats = train_update(params, frozenset(params),
                                             optimizer, opt_state, lr, group,
                                             forward)
        with torch.no_grad():
            mask = (disp_gt > 0) & (disp_gt < maxdisp)
            scalars = {"loss": loss,
                       **stereo_metrics(disp, disp_gt, mask, mesh)}
        return params, new_stats, opt_state, scalars

    return step


def make_supernet_eval_step(maxdisp: int, variants: KernelVariants = DEFAULT,
                            mesh=None, precision: Precision = FP32):
    """step(params, stats, left, right, disp_gt, fea_ops, mat_ops) ->
    scalars, with every BatchNorm frozen."""
    group = data_group(dp_only(mesh, "make_supernet_eval_step"))

    @torch.inference_mode()
    def step(params, stats, left, right, disp_gt, fea_ops, mat_ops):
        left, right, disp_gt = local_batch(mesh, left, right, disp_gt)
        disp, _ = supernet_forward(params, stats, left, right, fea_ops,
                                   mat_ops, train=False, maxdisp=maxdisp,
                                   variants=variants, precision=precision)
        loss, mask = supervised_loss(disp, disp_gt, maxdisp, group)
        return {"loss": loss, **stereo_metrics(disp, disp_gt, mask, mesh)}

    return step


def make_depth_supernet_train_step(optimizer, mesh=None):
    """step(params, stats, opt_state, lr, image, depth_gt, fea_ops,
    mat_ops): the depth supernet's step on silog over gt > 0, as
    make_supernet_train_step's."""
    group = data_group(mesh)

    def step(params, stats, opt_state, lr, image, depth_gt, fea_ops,
             mat_ops):
        image, depth_gt = local_batch(mesh, image, depth_gt)
        mask = depth_gt > 0

        def forward(p):
            pred, new_stats = depth_supernet_forward(
                p, stats, image, fea_ops, mat_ops, train=True)
            return silog_loss(pred, depth_gt, mask, group=group), pred, \
                new_stats

        loss, pred, new_stats = train_update(params, frozenset(params),
                                             optimizer, opt_state, lr, group,
                                             forward)
        with torch.no_grad():
            scalars = {"loss": loss,
                       **depth_metrics(pred, depth_gt, mask, group)}
        return params, new_stats, opt_state, scalars

    return step


def make_depth_supernet_eval_step(mesh=None):
    group = data_group(mesh)

    @torch.inference_mode()
    def step(params, stats, image, depth_gt, fea_ops, mat_ops):
        image, depth_gt = local_batch(mesh, image, depth_gt)
        pred, _ = depth_supernet_forward(params, stats, image, fea_ops,
                                         mat_ops, train=False)
        mask = depth_gt > 0
        return {"loss": silog_loss(pred, depth_gt, mask, group=group),
                **depth_metrics(pred, depth_gt, mask, group)}

    return step


class CellSearch:
    """Searches one Genotype per task on a fresh supernet, initialized from
    ``torch.Generator().manual_seed(config.seed)`` on ``device``, or from
    ``weights`` = (params, stats) trees when given."""

    _init_net = staticmethod(init_supernet)

    def __init__(self, config: CellSearchConfig,
                 log: Optional[Callable] = print, device="cuda",
                 variants: KernelVariants = DEFAULT, weights=None,
                 mesh=None, precision: Precision = FP32):
        self.cfg = config
        self.mesh = mesh
        self.log = log or (lambda *_: None)
        if weights is None:
            weights = self._init_net(
                torch.Generator().manual_seed(config.seed), device)
        self.params, self.stats = weights
        self.optimizer = make_optimizer(config.weight_decay, config.grad_clip)
        self.opt_state = self.optimizer.init(self.params)
        self.p = {
            "normal": np.full((NUM_EDGES, config.num_ops), 1.0 / config.num_ops),
            "reduce": np.full((NUM_EDGES, config.num_ops), 1.0 / config.num_ops),
        }
        self._train_step, self._eval_step = self._make_steps(variants,
                                                             precision)

    def _make_steps(self, variants, precision):
        return (make_supernet_train_step(self.optimizer, self.cfg.maxdisp,
                                         variants, self.mesh, precision),
                make_supernet_eval_step(self.cfg.maxdisp, variants,
                                        self.mesh, precision))

    @staticmethod
    def _batch_args(b):
        return (b["left"], b["right"], b["disparity"])

    @staticmethod
    def _quality(vm):
        """Reward quality in [0,1], higher=better (1 - valid_D1)."""
        return 1.0 - min(max(vm.get("D1", 1.0), 0.0), 1.0)

    def genotype(self) -> Genotype:
        return parse_genotype(self.p["normal"], self.p["reduce"])

    def save_state(self, path: str, epoch: int, h_e, h_a, rng,
                   best_loss, best_p, best_params) -> None:
        """Write the search's state after ``epoch`` (rag_tpu's keys:
        ``leaf_{i}`` of (params, stats, momentum), ``bleaf_{i}`` of the
        best params, ``p_*``, ``he_*``, ``ha_*``, ``bestp_*``, ``epoch``,
        ``best_loss``, ``rng_state``)."""
        extras = {}
        if best_p is not None:
            extras["bestp_normal"] = best_p["normal"]
            extras["bestp_reduce"] = best_p["reduce"]
        if best_params is not None:
            extras.update(leaf_arrays([best_params], "bleaf_"))
        savez_atomic(path, epoch=epoch,
                     rng_state=json.dumps(rng.bit_generator.state),
                     best_loss=best_loss,
                     p_normal=self.p["normal"], p_reduce=self.p["reduce"],
                     he_normal=h_e["normal"], he_reduce=h_e["reduce"],
                     ha_normal=h_a["normal"], ha_reduce=h_a["reduce"],
                     **extras, **leaf_arrays([self.params, self.stats,
                                              self.opt_state]))

    def load_state(self, path: str, rng):
        """Restore p, params, statistics, momentum and ``rng``'s bit state
        (new tensors on the params' device); returns (start_epoch, h_e,
        h_a, best_loss, best_p, best_params)."""
        with np.load(path) as npz:
            data = dict(npz)
        device = tree_device(self.params)
        self.p = {"normal": data["p_normal"], "reduce": data["p_reduce"]}
        h_e = {"normal": data["he_normal"], "reduce": data["he_reduce"]}
        h_a = {"normal": data["ha_normal"], "reduce": data["ha_reduce"]}
        self.params, self.stats, self.opt_state = from_leaves(
            data, [self.params, self.stats, self.opt_state], device)
        if "rng_state" in data:
            rng.bit_generator.state = json.loads(str(data["rng_state"]))
        best_loss = float(data["best_loss"]) if "best_loss" in data else np.inf
        best_p = None
        if "bestp_normal" in data:
            best_p = {"normal": data["bestp_normal"],
                      "reduce": data["bestp_reduce"]}
        best_params = None
        if any(k.startswith("bleaf_") for k in data):
            best_params, = from_leaves(data, [self.params], device, "bleaf_")
        return (int(data["epoch"]) + 1, h_e, h_a, best_loss, best_p,
                best_params)

    def search(self, train_data, writer=None, task: int = 0,
               checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 10, resume: bool = False,
               stop_after: Optional[int] = None,
               writes: bool = True) -> Genotype:
        """The MdeNAS loop; returns the genotype of the best-by-valid-loss
        epoch's p, with that epoch's params restored (the statistics and
        the optimizer state stay the last epoch's, as in rag_tpu).

        train_data: a dataset with .batches(batch, shuffle, seed, indices).
        checkpoint_path: the state file, written every ``checkpoint_every``
        epochs; resume=True continues from it where it exists.
        stop_after: return after that many epochs, right after the state
        file's write and without the best-epoch restore (a simulated
        kill). writes=False: resume from the state file, write none (a
        data-parallel run's ranks other than 0)."""
        for _ in self.steps(train_data, writer, task, checkpoint_path,
                            checkpoint_every, resume, stop_after, writes):
            pass
        return self.genotype()

    def steps(self, train_data, writer=None, task: int = 0,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 10, resume: bool = False,
              stop_after: Optional[int] = None, writes: bool = True):
        """``search`` as a generator, with its arguments: it yields BATCH
        after it enqueues each train or held-out step, and EPOCH at each
        epoch's end, before it reads the epoch's scalars back (the epoch's
        one wait for the device). Run to its end, it leaves the search
        where ``search`` does (``search.scene_parallel`` interleaves the
        scenes' generators)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1000 * task)
        train_idx, valid_idx = split_half(len(train_data),
                                          seed=cfg.seed + 1000 * task)

        h_e = {k: np.zeros((NUM_EDGES, cfg.num_ops), np.int64) for k in self.p}
        h_a = {k: np.zeros((NUM_EDGES, cfg.num_ops), np.float64) for k in self.p}
        best_loss, best_p, best_params = np.inf, None, None
        start_epoch = 0
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            (start_epoch, h_e, h_a, best_loss, best_p, best_params) = \
                self.load_state(checkpoint_path, rng)
            self.log(f"[cell-search t{task}] resumed at epoch {start_epoch}")
        for epoch in range(start_epoch, cfg.epochs):
            lr = cosine_lr(cfg.lr, cfg.epochs, epoch, cfg.lr_min)
            ops = {
                k: np.array([rng.choice(cfg.num_ops, p=self.p[k][e])
                             for e in range(NUM_EDGES)], np.int32)
                for k in self.p
            }
            outs, valid_outs = [], []
            for b in train_data.batches(cfg.batch, True, seed=epoch,
                                        indices=train_idx):
                self.params, self.stats, self.opt_state, scalars = \
                    self._train_step(self.params, self.stats, self.opt_state,
                                     lr, *self._batch_args(b), ops["normal"],
                                     ops["reduce"])
                outs.append(scalars)
                yield BATCH
            for b in train_data.batches(cfg.batch, False, seed=0,
                                        indices=valid_idx):
                valid_outs.append(self._eval_step(
                    self.params, self.stats, *self._batch_args(b),
                    ops["normal"], ops["reduce"]))
                yield BATCH
            yield EPOCH
            train_m = AverageMeterDict().update_batched(outs)
            valid_m = AverageMeterDict().update_batched(valid_outs)

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

            if (writes and checkpoint_path
                    and (epoch + 1) % checkpoint_every == 0):
                self.save_state(checkpoint_path, epoch, h_e, h_a, rng,
                                best_loss, best_p, best_params)
            if stop_after is not None and epoch + 1 >= stop_after:
                return

        if best_p is not None:
            self.p = best_p
        if best_params is not None:
            self.params = best_params
        self.log(f"[cell-search t{task}] best genotype: {self.genotype()}")


class DepthCellSearch(CellSearch):
    """MdeNAS over the depth supernet: monocular input, 2D matching half,
    silog objective, d1 reward quality. It runs no hand-written kernel,
    so ``variants`` has nothing to pick, and casts nothing, as rag_tpu's
    depth supernet does not: ``precision`` has nothing to set."""

    _init_net = staticmethod(init_depth_supernet)

    def _make_steps(self, variants, precision):
        return (make_depth_supernet_train_step(self.optimizer, self.mesh),
                make_depth_supernet_eval_step(self.mesh))

    @staticmethod
    def _batch_args(b):
        return (b["image"], b["depth"])

    @staticmethod
    def _quality(vm):
        return min(max(vm.get("d1", 0.0), 0.0), 1.0)
