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
scenes seen so far.

With a ``checkpoint_dir`` the files are rag_tpu's, and each package
resumes the other's. Task checkpoints: "selected" after select, "trained"
after the fine-tune, a manifest-only "trained" after each row evaluation
(the rows done so far ride in every manifest), "task_done" after the row,
and ``router.npz`` after the router. Stage files, every
``stage_checkpoint_every`` epochs (0: none): ``cellsearch_t{t}.npz``,
``opsearch_t{t}.npz`` and ``finetune_t{t}.npz``, each deleted once its
stage is done; the searched genotype stays as ``genotype_t{t}.json``, and
a later run loads it instead of searching. ``run(resume=True)`` restores
the latest task checkpoint and re-enters where it stopped: a "selected"
task at its fine-tune (from its stage file), a "trained" task at the
evaluations it has not done, a "task_done" one at the next task, and a
router trained before the last finished task is trained again.

The variants differ from this driver in hooks only, so the pipeline, the
stage files and resume exist once: ``_new_net`` (the registry's class),
``_cell_search_cls``, ``_op_search_cfg``, ``_search_data_for`` and
``_op_search_variant`` (the op search's config, data and steps),
``_pre_finetune``, ``_ft_steps`` and ``_ft_tag`` (the fine-tune's steps
and log), ``_eval_step_for`` and ``_batch_args``, ``router_input``, and
``headline`` with ``_head_text`` (the metric the logs and the router
report lead with). The self-supervised driver
(continual.self_supervised) and the depth driver (continual.depth_driver)
override them.

The driver runs on ``device`` with the kernels ``variants`` picks; the
datasets' batches must be tensors on that device.

Data parallelism: with ``mesh_data`` > 1 the driver runs on every rank of
an initialized process group of that many ranks (``python -m
rag_tpu_torch.cli --mesh N`` starts one rank per GPU), one device each.
Cell search, op search, fine-tune (and the self-supervised pretrain) take
data-parallel steps over the mesh: every rank reads the same global
batches and trains on its slice, and the steps reduce across the ranks so
that every rank holds the single-process result. A stage whose batch
does not divide by ``mesh_data`` runs single-process steps on every rank
(one log line per stage). The evaluations and the router run the same on
every rank. At the end of each stage every rank takes rank 0's net,
router and choice (a genotype, the op search's probabilities): a stage
without the mesh runs alone on each rank, and two runs of one step need
not agree to the bit on the card (``_replicate``). Rank 0 alone logs and writes the checkpoints and stage files;
the other ranks wait at a barrier after each write, and a resume reads
the same files on every rank. Where the world spans several machines,
each rank reads only its shard of each batch's indices
(``parallel.multihost.MultihostBatcher``).

Spatial sharding: with ``mesh_model`` > 1 the world is mesh_data x
mesh_model ranks, and, as in rag_tpu (``_mesh_for``'s ``dp_only``), only
the supervised fine-tune's train and eval steps take the model axis
(``parallel.sharded``: every rank runs the kernels on its H slab of the
matching volumes). Cell search, op search, the variants' steps and the
evaluations run single-process on each rank, each stage followed by
``_replicate``.

Scene-parallel search (``scene_parallel_search``): before the task loop
every scene's cell search runs at once (``search.scene_parallel``, one
CUDA stream per scene on the card), and the genotypes land where
``search_cell`` looks (``_pre_genotypes`` and the ``genotype_t{t}.json``
stage files), so that the loop, and a resume, take them up.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rag_tpu_torch.continual.state import (
    _geno_from,
    _geno_json,
    from_leaves,
    latest_task,
    leaf_arrays,
    load_checkpoint,
    load_router,
    save_checkpoint,
    save_router,
    savez_atomic,
)
from rag_tpu_torch.metrics.meters import AverageMeterDict, ForgettingMatrix
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.router import SceneRouter
from rag_tpu_torch.ops.precision import Precision
from rag_tpu_torch.ops.variants import KernelVariants
from rag_tpu_torch.parallel.mesh import barrier, make_mesh, replicate
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
    # data parallelism over mesh_data ranks of the initialized process
    # group, times mesh_model ranks that split the matching volumes' H
    # (see the module docstring)
    mesh_data: int = 1
    mesh_model: int = 1
    # every scene's cell search at once, before the task loop
    scene_parallel_search: bool = False
    # the activations' storage dtypes of every step (ops.precision; --bf16)
    precision: Precision = Precision()


def _arch_key(specs):
    return tuple(sorted((k, s) for k, s in specs.items()))


def _save_finetune_state(path, params, stats, opt_state, best, best_loss,
                         epoch):
    """The fine-tune's state after ``epoch``: ``leaf_{i}`` of (params,
    stats, momentum, best params, best stats), host copies, with
    ``epoch`` and ``best_loss``."""
    savez_atomic(path, epoch=epoch, best_loss=best_loss,
                 **leaf_arrays([params, stats, opt_state, *best]))


def _remove_if_exists(path) -> None:
    if os.path.exists(path):
        os.remove(path)


def _write_json(path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _load_finetune_state(path, template, device):
    """template: (params, stats, opt_state) of the stage. Returns (params,
    stats, opt_state, (best params, best stats), best_loss, start_epoch),
    every tree new tensors on ``device``."""
    with np.load(path) as npz:
        data = dict(npz)
    params, stats, opt_state = template
    params, stats, opt_state, bp, bs = from_leaves(
        data, [params, stats, opt_state, params, stats], device)
    return (params, stats, opt_state, (bp, bs), float(data["best_loss"]),
            int(data["epoch"]) + 1)


class ContinualDriver:
    router_input = "left"   # the batch key the Scene Router routes on

    def __init__(self, config: ExperimentConfig,
                 writer: Optional[MetricWriter] = None,
                 log: Optional[Callable] = print,
                 checkpoint_dir: Optional[str] = None, device="cuda",
                 variants: KernelVariants = KernelVariants(), mesh=None):
        self.cfg = config
        self.device = torch.device(device)
        # the mesh to run over; by default the process group's world
        # where mesh_data * mesh_model > 1
        self.mesh = mesh
        if mesh is not None and (mesh.data, mesh.model) != (
                config.mesh_data, config.mesh_model):
            raise ValueError(f"a {mesh.data}x{mesh.model} mesh for "
                             f"{config.mesh_data}x{config.mesh_model}")
        if mesh is None and config.mesh_data * config.mesh_model > 1:
            n = config.mesh_data * config.mesh_model
            if self.device.type == "cuda" and n > torch.cuda.device_count():
                raise ValueError(
                    f"mesh {config.mesh_data}x{config.mesh_model} needs {n} "
                    f"devices, have {torch.cuda.device_count()}")
            if not (dist.is_initialized() and dist.get_world_size() == n):
                raise ValueError(
                    f"mesh {config.mesh_data}x{config.mesh_model} runs on "
                    f"{n} ranks of a process group: start it with python -m "
                    "rag_tpu_torch.cli --mesh or parallel.multihost."
                    "initialize_multihost")
            self.mesh = make_mesh(config.mesh_data, config.mesh_model,
                                  device=self.device)
        # rank 0 alone logs and writes files
        self._writes = self.mesh is None or self.mesh.rank == 0
        self.writer = (writer or MetricWriter()) if self._writes \
            else MetricWriter()
        self.log = (log or (lambda *_: None)) if self._writes \
            else (lambda *_: None)
        if self.mesh is not None:
            self.log(f"[mesh] {config.mesh_data}-way dp"
                     + (f" x {config.mesh_model}-way spatial"
                        if config.mesh_model > 1 else "")
                     + f" over {self.mesh.size} ranks")
        self._mesh_warned = set()
        self.checkpoint_dir = (os.path.abspath(checkpoint_dir)
                               if checkpoint_dir else None)
        self.variants = variants
        self.net: Optional[GrowableStereoNet] = None
        self.router: Optional[SceneRouter] = None
        self.router_eval = None  # routed-vs-oracle report (router_report)
        self.matrix = ForgettingMatrix(
            config.num_tasks,
            ("D1", "EPE", "loss", "Thres1", "Thres2", "Thres3"))
        self._eval_cache = {}
        # completed forgetting-row evals, {t: {u: {metric: float}}}, kept in
        # every checkpoint's extra so that a resumed run skips them
        self._eval_rows = {}
        # stage-file cadence in epochs for the three long stages (0: none)
        self.stage_checkpoint_every = 10
        # stop the fine-tune after this many epochs, right after its stage
        # file's write (fault injection; run() carries on)
        self._finetune_stop_after: Optional[int] = None
        # the restored checkpoint's stage and task (resume)
        self._resume_stage: Optional[str] = None
        self._resume_task: Optional[int] = None
        # the scene-parallel search's genotypes, {task: Genotype}
        self._pre_genotypes = {}

    # -- data parallelism --------------------------------------------------

    def _mesh_for(self, batch: int, stage: str, dp_only: bool = True):
        """The mesh a stage's steps run over, or None: without a mesh,
        where the stage's batch does not divide by mesh_data, or where the
        stage takes data parallelism only (``dp_only``) and mesh_model > 1
        (logged once a stage; every rank then runs the single-process
        steps)."""
        if self.mesh is None:
            return None
        reason = None
        if batch % self.cfg.mesh_data != 0:
            reason = (f"batch {batch} not divisible by mesh_data "
                      f"{self.cfg.mesh_data}")
        elif dp_only and self.cfg.mesh_model > 1:
            reason = (f"stage supports dp only; mesh_model="
                      f"{self.cfg.mesh_model}")
        if reason is None:
            return self.mesh
        if stage not in self._mesh_warned:
            self._mesh_warned.add(stage)
            self.log(f"[mesh] {stage}: {reason} -> single-device steps")
        return None

    def _replicate(self, obj=None):
        """Rank 0's net and router on every rank, and rank 0's copy of obj
        (returned): a stage's result, such as a search's genotype. A stage
        whose steps run without the mesh (a batch that does not divide by
        mesh_data, the router) runs alone on each rank, and two runs of
        one step need not agree to the bit on the card, so the ranks'
        copies, or a search's choice, could drift apart; later
        data-parallel steps would then sum mismatched tensors or issue
        different collectives. Called on every rank at the end of each
        stage; nothing without a mesh."""
        if self.mesh is None:
            return obj
        if self.net is not None:
            for u in self.net.all_units():
                u.params = replicate(u.params, self.mesh)
                u.stats = replicate(u.stats, self.mesh)
        if self.router is not None:
            self.router.params = replicate(self.router.params, self.mesh)
            self.router.opt_state = replicate(self.router.opt_state,
                                              self.mesh)
        return None if obj is None else replicate(obj, self.mesh)

    def _dist_data(self, ds):
        """A world on one machine reads the global batches on every rank,
        as rag_tpu's single-process mesh does; across machines each rank
        reads only its shard of each batch (MultihostBatcher)."""
        if self.mesh is None or self.mesh.hosts == 1:
            return ds
        from rag_tpu_torch.parallel.multihost import MultihostBatcher

        return MultihostBatcher(ds, self.mesh)

    def _write(self, fn, *args, **kw) -> None:
        """fn(*args, **kw) on rank 0 alone; every rank then waits for the
        others."""
        if self._writes:
            fn(*args, **kw)
        barrier(self.mesh)

    def _drop(self, path: Optional[str]) -> None:
        """Remove a finished stage's file (rank 0)."""
        if path:
            self._write(_remove_if_exists, path)

    # -- variant hooks -----------------------------------------------------

    def _new_net(self, genotype, seed: int):
        return GrowableStereoNet.initial(genotype, seed, self.device)

    def _cell_search_cls(self):
        return CellSearch

    def _op_search_cfg(self) -> OpSearchConfig:
        return dataclasses.replace(self.cfg.op, maxdisp=self.cfg.maxdisp)

    def _search_data_for(self, t: int, train_data):
        """The data the op search trains and scores on."""
        return train_data

    def _op_search_variant(self) -> str:
        """The key of search.growth.VARIANTS the op search steps with."""
        return "stereo"

    def _pre_finetune(self, t: int) -> None:
        """Runs before task t's fine-tune."""

    def _ft_steps(self, specs, trainable, optimizer):
        """(train step, eval step) of the fine-tune: BatchNorm trains and
        params update on the task's trainable sites."""
        mesh = self._mesh_for(self.cfg.train.batch, "fine-tune",
                              dp_only=False)
        return (make_train_step(specs, trainable, optimizer,
                                maxdisp=self.cfg.maxdisp,
                                variants=self.variants, mesh=mesh,
                                precision=self.cfg.precision),
                make_eval_step(specs, maxdisp=self.cfg.maxdisp,
                               variants=self.variants, mesh=mesh,
                               precision=self.cfg.precision))

    def _eval_step_for(self, specs):
        return make_eval_step(specs, maxdisp=self.cfg.maxdisp,
                              variants=self.variants,
                              precision=self.cfg.precision)

    @staticmethod
    def _batch_args(b):
        return (b["left"], b["right"], b["disparity"])

    def _ft_tag(self) -> str:
        return "train"

    # the metric the router report and the final mean lead with
    headline = "D1"

    @staticmethod
    def _head_text(v) -> str:
        """The log text of the headline metrics of scalars v."""
        return f"D1 {100*v.get('D1', 0):.2f}% EPE {v.get('EPE', 0):.3f}"

    # -- stages ------------------------------------------------------------

    def _stage_ckpt(self, name: str) -> Optional[str]:
        """Path of a stage file (None without a checkpoint_dir or with
        stage_checkpoint_every 0)."""
        if not self.checkpoint_dir or not self.stage_checkpoint_every:
            return None
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        return os.path.join(self.checkpoint_dir, name)

    def _cell_search(self, t: int) -> CellSearch:
        """Task t's cell search on a fresh supernet seeded cell.seed + t."""
        cfg = dataclasses.replace(self.cfg.cell, seed=self.cfg.cell.seed + t,
                                  maxdisp=self.cfg.maxdisp)
        return self._cell_search_cls()(
            cfg, log=self.log, device=self.device, variants=self.variants,
            mesh=self._mesh_for(cfg.batch, "cell-search"),
            precision=self.cfg.precision)

    def _op_search(self) -> OpSearch:
        cfg = self._op_search_cfg()
        return OpSearch(self.net, cfg, log=self.log, variants=self.variants,
                        variant=self._op_search_variant(),
                        mesh=self._mesh_for(cfg.batch, "op-search"),
                        precision=self.cfg.precision)

    def _grow(self, t: int, genotype) -> None:
        """Task 0: a new net; t > 0: expand it. Drawn from seed + 31 t."""
        seed = self.cfg.seed + 31 * t
        if t == 0:
            self.net = self._new_net(genotype, seed)
        else:
            self.net.expand(t, genotype, seed)

    def parallel_cell_search(self, train_datasets: Sequence) -> None:
        """Every scene's cell search in one pass (``search.scene_parallel``;
        scene t seeded cell.seed + t as its sequential search), run the
        same on every rank and then rank 0's taken. The genotypes go where
        search_cell reads them: ``_pre_genotypes`` and the
        ``genotype_t{t}.json`` stage files, so that a resume picks them
        up. Nothing where every task already has its genotype."""
        from rag_tpu_torch.search.scene_parallel import (
            SceneParallelCellSearch,
        )

        n = self.cfg.num_tasks
        if self.cfg.skip_cell_search or all(self._have_genotype(t)
                                            for t in range(n)):
            return
        sp = SceneParallelCellSearch(
            dataclasses.replace(self.cfg.cell, maxdisp=self.cfg.maxdisp),
            num_scenes=n, log=self.log,
            scene_seeds=[self.cfg.cell.seed + t for t in range(n)],
            device=self.device, variants=self.variants,
            search_cls=self._cell_search_cls(), precision=self.cfg.precision)
        genos = self._replicate(sp.search(list(train_datasets[:n]),
                                          writer=self.writer))
        self._pre_genotypes = dict(enumerate(genos))
        for t, geno in enumerate(genos):
            geno_file = self._stage_ckpt(f"genotype_t{t}.json")
            if geno_file:
                self._write(_write_json, geno_file, _geno_json(geno))

    def _have_genotype(self, t: int) -> bool:
        if self._pre_genotypes.get(t) is not None:
            return True
        geno_file = self._stage_ckpt(f"genotype_t{t}.json")
        return bool(geno_file and os.path.exists(geno_file))

    def search_cell(self, t: int, train_data) -> Genotype:
        if self.cfg.skip_cell_search:
            return default_genotype()
        pre = self._pre_genotypes.get(t)
        if pre is not None:
            self.log(f"[task {t}] using scene-parallel searched genotype")
            return pre
        geno_file = self._stage_ckpt(f"genotype_t{t}.json")
        if geno_file and os.path.exists(geno_file):
            with open(geno_file) as f:
                geno = _geno_from(json.load(f))
            self.log(f"[task {t}] loaded searched genotype from {geno_file}")
            return geno
        ckpt = self._stage_ckpt(f"cellsearch_t{t}.npz")
        geno = self._cell_search(t).search(
            train_data, writer=self.writer, task=t, checkpoint_path=ckpt,
            checkpoint_every=self.stage_checkpoint_every,
            resume=bool(ckpt and os.path.exists(ckpt)), writes=self._writes)
        geno = self._replicate(geno)
        if geno_file:
            self._write(_write_json, geno_file, _geno_json(geno))
        self._drop(ckpt)
        return geno

    def _save(self, t: int, stage: str, manifest_only: bool = False):
        if self.checkpoint_dir:
            self._write(save_checkpoint, self.checkpoint_dir, self.net,
                        task=t, extra=self._ckpt_extra(stage),
                        manifest_only=manifest_only)

    def train_task(self, t: int, train_data, valid_data):
        """The task's pipeline: cell search, t = 0 a new net, t > 0 expand,
        op search and select; then the fine-tune. A task restored after
        its select ("selected") goes straight to its fine-tune; one
        restored after its fine-tune ("trained") to its evaluations."""
        if self.net is not None and len(self.net.archis) > t:
            if self._resume_stage == "trained" and self._resume_task == t:
                self._resume_stage = None
                self.log(f"[task {t}] resumed post-fine-tune; "
                         f"evaluation only")
                return
            self.log(f"[task {t}] resumed post-select; fine-tune only")
            self.writer.scalars("model_size_m",
                                {"params_m": self.net.size_m()}, step=t)
            self._pre_finetune(t)
            self.fine_tune(t, train_data, valid_data)
            return
        genotype = self.search_cell(t, train_data)
        self._grow(t, genotype)
        if t > 0:
            ckpt = self._stage_ckpt(f"opsearch_t{t}.npz")
            self._op_search().search(
                t, self._search_data_for(t, train_data), writer=self.writer,
                checkpoint_path=ckpt,
                checkpoint_every=self.stage_checkpoint_every,
                resume=bool(ckpt and os.path.exists(ckpt)),
                writes=self._writes)
            self.net.p = self._replicate(self.net.p)
            self._drop(ckpt)
            best = self.net.select(t)
            self.log(f"[task {t}] best_archi = {best}")
            self.writer.text(f"archi/task{t}", str(best))
        self._save(t, "selected")
        self.writer.scalars("model_size_m", {"params_m": self.net.size_m()},
                            step=t)
        self._pre_finetune(t)
        self.fine_tune(t, train_data, valid_data)

    def fine_tune(self, t: int, train_data, valid_data):
        """Train archis[t]: BatchNorm trains and params update on the
        task's trainable sites only; the best-by-valid-loss epoch's tensors
        are written back, and the "trained" checkpoint is saved before the
        stage file goes. A stage file on disk is resumed from."""
        cfg = self.cfg.train
        net = self.net
        arch = net.archis[t]
        trainable = net.trainable_sites(t)
        specs, params, stats = net.path(arch)
        optimizer = make_optimizer(cfg.weight_decay, cfg.grad_clip)
        train_step, eval_step = self._ft_steps(specs, trainable, optimizer)
        opt_state = optimizer.init(params)
        tag = self._ft_tag()

        best_loss = np.inf
        # copies: the train step updates params in place
        best = (clone_tree(params), stats)
        start_epoch = 0
        ckpt = self._stage_ckpt(f"finetune_t{t}.npz")
        if ckpt and os.path.exists(ckpt):
            params, stats, opt_state, best, best_loss, start_epoch = \
                _load_finetune_state(ckpt, (params, stats, opt_state),
                                     self.device)
            self.log(f"[{tag} t{t}] resumed at epoch {start_epoch}")

        def batches(data):
            return [eval_step(params, stats, *self._batch_args(b))
                    for b in data.batches(cfg.batch, False, seed=0)]

        for epoch in range(start_epoch, cfg.epochs):
            lr = cosine_lr(cfg.lr, cfg.epochs, epoch)
            for b in train_data.batches(cfg.batch, True, seed=epoch):
                params, stats, opt_state, _ = train_step(
                    params, stats, opt_state, lr, *self._batch_args(b))
            tv = AverageMeterDict().update_batched(batches(train_data)).mean()
            v = AverageMeterDict().update_batched(batches(valid_data)).mean()
            self.log(f"[{tag} t{t}] epoch {epoch} lr {lr:.5f} "
                     f"train loss {tv.get('loss', 0):.3f} "
                     f"valid loss {v.get('loss', 0):.3f} "
                     + self._head_text(v))
            self.writer.scalars(f"{tag}/task{t}", v, step=epoch)
            self.writer.scalars(f"{tag}/task{t}_trainset", tv, step=epoch)
            if v.get("loss", np.inf) < best_loss:
                best_loss = v.get("loss", np.inf)
                best = (clone_tree(params), stats)
            if ckpt and (epoch + 1) % self.stage_checkpoint_every == 0:
                self._write(_save_finetune_state, ckpt, params, stats,
                            opt_state, best, best_loss, epoch)
            if (self._finetune_stop_after is not None
                    and epoch + 1 >= self._finetune_stop_after):
                return
        net.write_back(arch, *best)
        self._replicate()
        self._save(t, "trained")
        self._drop(ckpt)

    def _cached_eval_step(self, specs):
        key = _arch_key(specs)
        if key not in self._eval_cache:
            self._eval_cache[key] = self._eval_step_for(specs)
        return self._eval_cache[key]

    def evaluate(self, u: int, test_data, batch: int = 1):
        """Task u's test metrics on its stored path."""
        specs, params, stats = self.net.path(self.net.archis[u])
        eval_step = self._cached_eval_step(specs)
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
                                      input_key=self.router_input,
                                      device=self.device)
        self.router.train(train_datasets[:t + 1],
                          epochs=self.cfg.router_epochs,
                          batch=self.cfg.router_batch, log=self.log)
        self._replicate()
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
            scalars = self._cached_eval_step(specs)(params, stats,
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
        head = self.headline
        delta = float(np.mean(report["routed"][head])
                      - np.mean(report["oracle"][head]))
        report[f"routed_minus_oracle_{head}"] = delta
        report[f"routed_{head}"] = report["routed"][head]
        report[f"oracle_{head}"] = report["oracle"][head]
        self.log(
            f"[router] routed-vs-oracle {head} delta {delta:+.4f} "
            f"(routed {[f'{x:.4f}' for x in report['routed'][head]]} "
            f"oracle {[f'{x:.4f}' for x in report['oracle'][head]]}); "
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

    def resume(self) -> int:
        """Restore the net, the forgetting matrix, the finished row
        evaluations and (use_router) the router from the latest task
        checkpoint; return the first task still to run (0 without one). A
        "selected" or "trained" checkpoint re-enters its own task."""
        if not self.checkpoint_dir:
            return 0
        t = latest_task(self.checkpoint_dir)
        if t is None:
            return 0
        self.net, manifest = load_checkpoint(self.checkpoint_dir, t,
                                             device=self.device)
        extra = manifest.get("extra", {})
        for k, vals in (extra.get("matrix") or {}).items():
            if k in self.matrix.m:
                arr = np.asarray(vals)
                n = min(arr.shape[0], self.matrix.num_tasks)
                self.matrix.m[k][:n, :n] = arr[:n, :n]
        stage = extra.get("stage", "task_done")
        self._eval_rows = {int(tk): {int(uk): dict(s)
                                     for uk, s in row.items()}
                           for tk, row in (extra.get("eval_rows") or {}).items()}
        if self.cfg.use_router:
            self.router = load_router(self.checkpoint_dir, device=self.device)
        self.log(f"[resume] restored task {t} ({stage}) "
                 f"from {self.checkpoint_dir}")
        self._resume_stage, self._resume_task = stage, t
        return t if stage in ("selected", "trained") else t + 1

    def run(self, train_datasets: Sequence, valid_datasets: Sequence,
            test_datasets: Sequence, resume: bool = False) -> ForgettingMatrix:
        tstart = time.time()
        train_datasets = [self._dist_data(d) for d in train_datasets]
        valid_datasets = [self._dist_data(d) for d in valid_datasets]
        start = self.resume() if resume else 0
        if resume and self.cfg.use_router and start > 1:
            # a router saved before the last finished task (a kill in that
            # task's router stage) is trained again
            done = self.router.trained_task if self.router is not None else -1
            if done < start - 1:
                self.log(f"[router] router.npz trained through task {done} "
                         f"< completed task {start - 1}; re-training")
                self.train_router(start - 1, train_datasets, test_datasets)
                if self.checkpoint_dir and self.router is not None:
                    self._write(save_router, self.checkpoint_dir, self.router)
        if self.cfg.scene_parallel_search:
            self.parallel_cell_search(train_datasets)
        for t in range(start, self.cfg.num_tasks):
            self.log("*" * 60 + f"\nTask {t}\n" + "*" * 60)
            self.train_task(t, train_datasets[t], valid_datasets[t])
            row = self._eval_rows.setdefault(t, {})
            for u in range(t + 1):
                if u in row:
                    # evaluated before the resume: its result is in the
                    # restored checkpoint
                    self.matrix.record(t, u, row[u])
                    self.log(f">>> after task {t}: test task {u} "
                             f"(cached from resumed checkpoint)")
                    continue
                scalars = {k: float(v) for k, v in
                           self.evaluate(u, test_datasets[u]).items()}
                row[u] = scalars
                self.matrix.record(t, u, scalars)
                self.log(f">>> after task {t}: test task {u} "
                         f"{self._head_text(scalars)}")
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
                    self._write(save_router, self.checkpoint_dir, self.router)
        if self.cfg.use_router and self.router is not None:
            self.router_report(test_datasets)
        hours = (time.time() - tstart) / 3600
        self.log(f"mean {self.headline} after {self.cfg.num_tasks} tasks: "
                 f"{self.matrix.mean_final(self.headline):.4f}  "
                 f"elapsed {hours:.2f} h")
        return self.matrix
