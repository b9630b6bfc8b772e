"""The continual-learning driver: per task, search -> grow -> select ->
fine-tune, then the forgetting-matrix row, the checkpoint and the Scene
Router.

Counterpart of rag_tpu/continual/driver.py::ContinualDriver (stereo). Per
task t:
  1. cell search on a fresh supernet -> genotype (``search_cell``);
  2. t = 0: a new net from it; t > 0: expand, op search over reuse-vs-new,
     select (``train_task``);
  3. fine-tune archis[t] (SGD, cosine, best-by-valid-loss rollback;
     ``fine_tune``);
then every past task u <= t is evaluated into the forgetting matrix, the
checkpoint is written, and the router (``use_router``) trains on the
scenes seen so far. With a ``checkpoint_dir`` the saves are rag_tpu's:
"selected" after select, "trained" after the fine-tune, a manifest-only
"trained" after each row evaluation, "task_done" after the row, and
``router.npz`` after the router; the searched genotype of task t lands in
``genotype_t{t}.json`` and a later run loads it instead of searching.

Not ported: resume, mid-stage state files and fault injection, meshes
and scene-parallel search, and the depth and self-supervised variants;
``ExperimentConfig`` has no fields for them. The driver runs on
``device`` with the kernels ``variants`` picks; the datasets' batches
must be tensors on that device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rag_tpu_torch.continual.state import (
    _geno_from,
    _geno_json,
    save_checkpoint,
    save_router,
)
from rag_tpu_torch.metrics.meters import AverageMeterDict, ForgettingMatrix
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.router import SceneRouter
from rag_tpu_torch.ops.variants import KernelVariants
from rag_tpu_torch.search.genotype import Genotype, default_genotype
from rag_tpu_torch.search.growth import OpSearch, OpSearchConfig
from rag_tpu_torch.search.mdenas import CellSearch, CellSearchConfig
from rag_tpu_torch.train.trainer import (
    clone_tree,
    cosine_lr,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from rag_tpu_torch.utils.logging import MetricWriter


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 400
    batch: int = 4
    lr: float = 0.001
    weight_decay: float = 0.003
    grad_clip: float = 5.0


@dataclasses.dataclass
class ExperimentConfig:
    cell: CellSearchConfig = dataclasses.field(default_factory=CellSearchConfig)
    op: OpSearchConfig = dataclasses.field(default_factory=OpSearchConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    num_tasks: int = 4
    seed: int = 0
    skip_cell_search: bool = False  # use default_genotype() per task
    maxdisp: int = 192              # cost-volume depth = maxdisp // 3
    # the Scene Router, trained after each task on the scenes seen so far
    # and saved with the checkpoints
    use_router: bool = False
    router_epochs: int = 3
    router_batch: int = 8


def _arch_key(specs):
    return tuple(sorted((k, s) for k, s in specs.items()))


class ContinualDriver:
    def __init__(self, config: ExperimentConfig,
                 writer: Optional[MetricWriter] = None,
                 log: Optional[Callable] = print,
                 checkpoint_dir: Optional[str] = None, device="cuda",
                 variants: KernelVariants = KernelVariants()):
        self.cfg = config
        self.writer = writer or MetricWriter()
        self.log = log or (lambda *_: None)
        self.checkpoint_dir = (os.path.abspath(checkpoint_dir)
                               if checkpoint_dir else None)
        self.device = torch.device(device)
        self.variants = variants
        self.net: Optional[GrowableStereoNet] = None
        self.router: Optional[SceneRouter] = None
        self.router_eval = None  # routed-vs-oracle report (router_report)
        self.matrix = ForgettingMatrix(
            config.num_tasks,
            ("D1", "EPE", "loss", "Thres1", "Thres2", "Thres3"))
        self._eval_cache = {}
        # completed forgetting-row evals, {t: {u: {metric: float}}}, kept in
        # every checkpoint's extra
        self._eval_rows = {}

    # -- stages ------------------------------------------------------------

    def _geno_file(self, t: int) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        return os.path.join(self.checkpoint_dir, f"genotype_t{t}.json")

    def _cell_search(self, t: int) -> CellSearch:
        """Task t's cell search on a fresh supernet seeded cell.seed + t."""
        return CellSearch(dataclasses.replace(self.cfg.cell,
                                              seed=self.cfg.cell.seed + t,
                                              maxdisp=self.cfg.maxdisp),
                          log=self.log, device=self.device,
                          variants=self.variants)

    def _op_search(self) -> OpSearch:
        return OpSearch(self.net, dataclasses.replace(
            self.cfg.op, maxdisp=self.cfg.maxdisp), log=self.log,
            variants=self.variants)

    def _grow(self, t: int, genotype) -> None:
        """Task 0: a new net; t > 0: expand it. Drawn from seed + 31 t."""
        seed = self.cfg.seed + 31 * t
        if t == 0:
            self.net = GrowableStereoNet.initial(genotype, seed, self.device)
        else:
            self.net.expand(t, genotype, seed)

    def search_cell(self, t: int, train_data) -> Genotype:
        if self.cfg.skip_cell_search:
            return default_genotype()
        geno_file = self._geno_file(t)
        if geno_file and os.path.exists(geno_file):
            with open(geno_file) as f:
                geno = _geno_from(json.load(f))
            self.log(f"[task {t}] loaded searched genotype from {geno_file}")
            return geno
        geno = self._cell_search(t).search(train_data, writer=self.writer,
                                           task=t)
        if geno_file:
            with open(geno_file, "w") as f:
                json.dump(_geno_json(geno), f)
        return geno

    def _save(self, t: int, stage: str, manifest_only: bool = False):
        if self.checkpoint_dir:
            save_checkpoint(self.checkpoint_dir, self.net, task=t,
                            extra=self._ckpt_extra(stage),
                            manifest_only=manifest_only)

    def train_task(self, t: int, train_data, valid_data):
        """The task's pipeline: cell search, t = 0 a new net, t > 0 expand,
        op search and select; then the fine-tune."""
        genotype = self.search_cell(t, train_data)
        self._grow(t, genotype)
        if t > 0:
            self._op_search().search(t, train_data, writer=self.writer)
            best = self.net.select(t)
            self.log(f"[task {t}] best_archi = {best}")
            self.writer.text(f"archi/task{t}", str(best))
        self._save(t, "selected")
        self.writer.scalars("model_size_m", {"params_m": self.net.size_m()},
                            step=t)
        self.fine_tune(t, train_data, valid_data)

    def fine_tune(self, t: int, train_data, valid_data):
        """Train archis[t]: BatchNorm trains and params update on the
        task's trainable sites only; the best-by-valid-loss epoch's tensors
        are written back."""
        cfg = self.cfg.train
        net = self.net
        arch = net.archis[t]
        trainable = net.trainable_sites(t)
        specs, params, stats = net.path(arch)
        optimizer = make_optimizer(cfg.weight_decay, cfg.grad_clip)
        train_step = make_train_step(specs, trainable, optimizer,
                                     maxdisp=self.cfg.maxdisp,
                                     variants=self.variants)
        eval_step = make_eval_step(specs, maxdisp=self.cfg.maxdisp,
                                   variants=self.variants)
        opt_state = optimizer.init(params)

        def batches(data, **kw):
            return [eval_step(params, stats, *self._batch_args(b))
                    for b in data.batches(cfg.batch, False, seed=0, **kw)]

        best_loss = np.inf
        # copies: the train step updates params in place
        best = (clone_tree(params), stats)
        for epoch in range(cfg.epochs):
            lr = cosine_lr(cfg.lr, cfg.epochs, epoch)
            for b in train_data.batches(cfg.batch, True, seed=epoch):
                params, stats, opt_state, _ = train_step(
                    params, stats, opt_state, lr, *self._batch_args(b))
            tv = AverageMeterDict().update_batched(batches(train_data)).mean()
            v = AverageMeterDict().update_batched(batches(valid_data)).mean()
            self.log(f"[train t{t}] epoch {epoch} lr {lr:.5f} "
                     f"train loss {tv.get('loss', 0):.3f} "
                     f"valid loss {v.get('loss', 0):.3f} "
                     f"D1 {100*v.get('D1', 0):.1f}% EPE {v.get('EPE', 0):.3f}")
            self.writer.scalars(f"train/task{t}", v, step=epoch)
            self.writer.scalars(f"train/task{t}_trainset", tv, step=epoch)
            if v.get("loss", np.inf) < best_loss:
                best_loss = v.get("loss", np.inf)
                best = (clone_tree(params), stats)
        net.write_back(arch, *best)
        self._save(t, "trained")

    @staticmethod
    def _batch_args(b):
        return (b["left"], b["right"], b["disparity"])

    def _eval_step_for(self, specs):
        key = _arch_key(specs)
        if key not in self._eval_cache:
            self._eval_cache[key] = make_eval_step(
                specs, maxdisp=self.cfg.maxdisp, variants=self.variants)
        return self._eval_cache[key]

    def evaluate(self, u: int, test_data, batch: int = 1):
        """Task u's test metrics on its stored path."""
        specs, params, stats = self.net.path(self.net.archis[u])
        eval_step = self._eval_step_for(specs)
        m = AverageMeterDict().update_batched(
            [eval_step(params, stats, *self._batch_args(b))
             for b in test_data.batches(batch, False, seed=0,
                                        drop_last=False)])
        return m.mean()

    def train_router(self, t: int, train_datasets, test_datasets):
        """The Scene Router after task t, on every scene seen so far (none
        after task 0: one path, nothing to route)."""
        if t == 0:
            return
        if self.router is None:
            self.router = SceneRouter(self.cfg.num_tasks, seed=self.cfg.seed,
                                      device=self.device)
        self.router.train(train_datasets[:t + 1],
                          epochs=self.cfg.router_epochs,
                          batch=self.cfg.router_batch, log=self.log)
        self.router.trained_task = t
        acc = self.router.accuracy(test_datasets[:t + 1])
        self.log(f"[router] after task {t}: scene accuracy {100*acc:.1f}%")
        self.writer.scalars("router", {"accuracy": acc}, step=t)

    def _routed_eval(self, u: int, test_data, confusion) -> dict:
        """Scene u's test frames, each through the path of the task the
        router predicts for it."""
        n = len(self.net.archis)
        m = AverageMeterDict()
        for b in test_data.batches(1, False, seed=0, drop_last=False):
            pred = self.router.predict(b[self.router.input_key])
            t = min(int(pred[0]), n - 1)
            confusion[u, t] += 1
            specs, params, stats = self.net.path(self.net.archis[t])
            scalars = self._eval_step_for(specs)(params, stats,
                                                 *self._batch_args(b))
            m.update({k: float(v) for k, v in scalars.items()})
        return m.mean()

    def router_report(self, test_datasets) -> Optional[dict]:
        """Every scene's test set routed per frame and on its own task's
        path, and the router's confusion matrix."""
        if self.router is None or self.net is None:
            return None
        n = len(self.net.archis)
        confusion = np.zeros((n, n), np.int64)
        routed, oracle = [], []
        for u in range(n):
            routed.append(self._routed_eval(u, test_datasets[u], confusion))
            oracle.append(self.evaluate(u, test_datasets[u]))
        keys = sorted(set().union(*[set(r) for r in routed + oracle]))
        report = {"routed": {k: [float(r.get(k, 0.0)) for r in routed]
                             for k in keys},
                  "oracle": {k: [float(o.get(k, 0.0)) for o in oracle]
                             for k in keys},
                  "confusion": confusion.tolist(),
                  "router_accuracy": float(np.trace(confusion)
                                           / max(confusion.sum(), 1))}
        delta = float(np.mean(report["routed"]["D1"])
                      - np.mean(report["oracle"]["D1"]))
        report["routed_minus_oracle_D1"] = delta
        report["routed_D1"] = report["routed"]["D1"]
        report["oracle_D1"] = report["oracle"]["D1"]
        self.log(
            f"[router] routed-vs-oracle D1 delta {delta:+.4f} "
            f"(routed {[f'{x:.4f}' for x in report['routed']['D1']]} "
            f"oracle {[f'{x:.4f}' for x in report['oracle']['D1']]}); "
            f"confusion diag {np.diag(confusion).tolist()} of "
            f"{confusion.sum(axis=1).tolist()}")
        self.router_eval = report
        return report

    # -- experiment loop ---------------------------------------------------

    def _ckpt_extra(self, stage: str) -> dict:
        return {"stage": stage,
                "matrix": {k: v.tolist() for k, v in self.matrix.m.items()},
                "eval_rows": {str(t): {str(u): dict(s)
                                       for u, s in row.items()}
                              for t, row in self._eval_rows.items()}}

    def run(self, train_datasets: Sequence, valid_datasets: Sequence,
            test_datasets: Sequence) -> ForgettingMatrix:
        tstart = time.time()
        for t in range(self.cfg.num_tasks):
            self.log("*" * 60 + f"\nTask {t}\n" + "*" * 60)
            self.train_task(t, train_datasets[t], valid_datasets[t])
            row = self._eval_rows.setdefault(t, {})
            for u in range(t + 1):
                scalars = {k: float(v) for k, v in
                           self.evaluate(u, test_datasets[u]).items()}
                row[u] = scalars
                self.matrix.record(t, u, scalars)
                self.log(f">>> after task {t}: test task {u} "
                         f"D1 {100*scalars['D1']:.2f}% "
                         f"EPE {scalars.get('EPE', 0):.3f}")
                self.writer.scalars("test", {f"task{u}_{k}": v
                                             for k, v in scalars.items()},
                                    step=t)
                self._save(t, "trained", manifest_only=True)
            size_m = self.net.size_m()
            self.log(f">>> model size after task {t}: {size_m:.4f} M params")
            self.writer.scalars("model", {"size_m": size_m}, step=t)
            self._save(t, "task_done")
            if self.cfg.use_router:
                self.train_router(t, train_datasets, test_datasets)
                if self.checkpoint_dir and self.router is not None:
                    save_router(self.checkpoint_dir, self.router)
        if self.cfg.use_router and self.router is not None:
            self.router_report(test_datasets)
        hours = (time.time() - tstart) / 3600
        self.log(f"mean D1 after {self.cfg.num_tasks} tasks: "
                 f"{self.matrix.mean_final('D1'):.4f}  "
                 f"elapsed {hours:.2f} h")
        return self.matrix
