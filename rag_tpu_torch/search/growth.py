"""Op-level growth search: reuse-vs-new selection over the expanded
network.

Counterpart of rag_tpu/search/growth.py, with its mid-search state file
and fault injection; with a ``mesh`` its steps run data-parallel
(``train.trainer``) while the sampled paths stay on the host, the same on
every rank. After ``expand`` every searchable
site holds L reuse candidates + 1 new unit; per epoch a full path is
sampled from the per-site categoricals, trained for an epoch on the
search split's first ``split_frac`` (only the new units and task t's
heads are trainable; every BatchNorm is frozen), scored on the rest (its
first ``eval_max_batches`` batches where set), and the per-site
probabilities updated with the MdeNAS pairwise rule under the
reusability reward

    h_a = sqrt(quality) * log(9 / max(n_new, 1) + 1) / e

(n_new: the sites that picked their new unit; quality 1 - D1 for stereo,
the delta < 1.25 accuracy d1 for depth, both clipped to [0, 1]), with the
reuse head start h_e[site][:-1] = o_size. ``VARIANTS`` maps a variant to
its steps, batch arguments and quality: the stereo ones (the
self-supervised search uses them too, on proxy pairs) or the depth ones.

One SGD momentum store persists over the whole search: a site's momentum
carries from the last epoch that trained it. The best-by-valid-loss epoch's
new units and heads are copied and restored into the registry after the
search (copies: the train step updates the registry's tensors in place).

The state file (``save_state`` / ``load_state``) is rag_tpu's, under
``_flatten``'s named keys: the new units' and heads' live and best trees
(``live/{name}/...``, ``best/{name}/...``), the momentum store
(``mom/{name}/...``), per site p, h_e and h_a (``prob/{i}``, ``he/{i}``,
``ha/{i}``), the numpy Generator's bit state as JSON, the epoch and the
best loss, so that each package resumes the other's file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional

import numpy as np

from rag_tpu_torch.continual.state import (
    _flatten,
    _unflatten,
    savez_atomic,
    tree_device,
)
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.data.stereo_dataset import split_half
from rag_tpu_torch.metrics.meters import AverageMeterDict
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.stereo import HEAD_NAMES, SITE_NAMES
from rag_tpu_torch.ops.precision import FP32, Precision
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.search.mdenas import mdenas_update
from rag_tpu_torch.train.trainer import (
    clone_tree,
    cosine_lr,
    make_depth_eval_step,
    make_depth_train_step,
    make_eval_step,
    make_optimizer,
    make_train_step,
)


@dataclasses.dataclass
class OpSearchConfig:
    epochs: int = 100
    batch: int = 6
    lr: float = 0.001
    lr_a: float = 0.01
    weight_decay: float = 3e-4
    lr_min: float = 0.001
    grad_clip: float = 5.0
    o_size: int = 10
    seed: int = 0
    maxdisp: int = 192
    # score on this many batches of the held-out split (the
    # self-supervised search's 10); None: all of it
    eval_max_batches: Optional[int] = None
    # weight-training share of the search split: 0.5, or 0.8 in the
    # self-supervised search
    split_frac: float = 0.5


def _stereo_steps(specs, trainable, optimizer, maxdisp, variants, mesh,
                  precision=FP32):
    # bn_sites = {}: every BatchNorm frozen during op search
    return (make_train_step(specs, frozenset(), optimizer,
                            trainable_sites=trainable, maxdisp=maxdisp,
                            variants=variants, mesh=mesh,
                            precision=precision),
            make_eval_step(specs, maxdisp=maxdisp, variants=variants,
                           mesh=mesh, precision=precision))


def _stereo_args(batch):
    return (batch["left"], batch["right"], batch["disparity"])


def _stereo_quality(vm):
    """(quality, log label) of valid metrics vm: 1 - D1, clipped."""
    return 1.0 - min(max(vm.get("D1", 1.0), 0.0), 1.0), "D1"


def _depth_steps(specs, trainable, optimizer, maxdisp, variants, mesh,
                 precision=FP32):
    return (make_depth_train_step(specs, frozenset(), optimizer,
                                  trainable_sites=trainable, mesh=mesh,
                                  precision=precision),
            make_depth_eval_step(specs, mesh=mesh, precision=precision))


def _depth_args(batch):
    return (batch["image"], batch["depth"])


def _depth_quality(vm):
    # the delta < 1.25 accuracy, clipped
    return min(max(vm.get("d1", 0.0), 0.0), 1.0), "1-delta1"


VARIANTS = {
    "stereo": (_stereo_steps, _stereo_args, _stereo_quality),
    "depth": (_depth_steps, _depth_args, _depth_quality),
}


def _inject_momentum(opt_state: Dict, store: Dict, names) -> Dict:
    """Replace the zero momentum of every site in ``names`` that has a
    stored buffer (the SGDMomentum state is a tree shaped like the params,
    keyed by site)."""
    for name in names:
        if name in store:
            opt_state[name] = store[name]
    return opt_state


def _extract_momentum(opt_state: Dict, names) -> Dict:
    return {name: opt_state[name] for name in names}


class OpSearch:
    """The reuse-vs-new search of task t on an expanded net."""

    def __init__(self, net: GrowableStereoNet, config: OpSearchConfig,
                 log: Optional[Callable] = print,
                 variants: KernelVariants = DEFAULT, variant: str = "stereo",
                 mesh=None, precision: Precision = FP32):
        self.net = net
        self.cfg = config
        self.mesh = mesh
        self.log = log or (lambda *_: None)
        self.variants = variants
        self.precision = precision
        self._step_cache = {}
        self._make_steps, self._batch_args, self._quality = \
            VARIANTS[variant]

    def _steps_for(self, arch, trainable):
        specs, _, _ = self.net.path(arch)
        key = (tuple(sorted((k, s) for k, s in specs.items())),
               tuple(sorted(trainable)))
        if key not in self._step_cache:
            optimizer = make_optimizer(self.cfg.weight_decay,
                                       self.cfg.grad_clip)
            train_step, eval_step = self._make_steps(
                specs, trainable, optimizer, self.cfg.maxdisp, self.variants,
                self.mesh, self.precision)
            self._step_cache[key] = (train_step, eval_step, optimizer)
        return self._step_cache[key]

    # -- the searchable state: new units + task t's heads ------------------

    def _new_unit_refs(self, t: int):
        refs = [(s, self.net.units[s][self.net.length(s) - 1])
                for s in SITE_NAMES]
        refs += [(h, self.net.heads[h][t]) for h in HEAD_NAMES]
        return refs

    def _snapshot(self, t: int) -> Dict:
        return {name: (clone_tree(u.params), clone_tree(u.stats))
                for name, u in self._new_unit_refs(t)}

    def _restore(self, t: int, snap: Dict):
        for name, u in self._new_unit_refs(t):
            u.params, u.stats = snap[name]

    # -- the mid-search state file ------------------------------------------

    def save_state(self, path: str, t: int, epoch: int, h_e, h_a,
                   momentum: Dict, best: Optional[Dict], best_loss: float,
                   rng=None) -> None:
        """Write the search's state after ``epoch`` (rag_tpu's keys)."""
        arrays: Dict[str, np.ndarray] = {}
        if rng is not None:
            arrays["rng_state"] = np.asarray(json.dumps(rng.bit_generator.state))
        for name, u in self._new_unit_refs(t):
            _flatten(u.params, f"live/{name}/params", arrays)
            _flatten(u.stats, f"live/{name}/stats", arrays)
        for name, m in momentum.items():
            _flatten(m, f"mom/{name}", arrays)
        if best is not None:
            for name, (p, s) in best.items():
                _flatten(p, f"best/{name}/params", arrays)
                _flatten(s, f"best/{name}/stats", arrays)
        for i, p in enumerate(self.net.p):
            arrays[f"prob/{i}"] = np.asarray(p)
            arrays[f"he/{i}"] = np.asarray(h_e[i])
            arrays[f"ha/{i}"] = np.asarray(h_a[i])
        savez_atomic(path, epoch=epoch, best_loss=best_loss,
                     has_best=int(best is not None), **arrays)

    def load_state(self, path: str, t: int, rng=None):
        """Restore the new units' and heads' tensors (new tensors on their
        device), p and ``rng``'s bit state; returns (start_epoch, h_e,
        h_a, momentum, best, best_loss)."""
        with np.load(path) as npz:
            data = dict(npz)
        if rng is not None and "rng_state" in data:
            rng.bit_generator.state = json.loads(str(data.pop("rng_state")))
        refs = self._new_unit_refs(t)
        device = tree_device(refs[-1][1].params)
        tree = lambda prefix: to_torch(_unflatten(data, prefix), device)
        for name, u in refs:
            u.params = tree(f"live/{name}/params")
            u.stats = tree(f"live/{name}/stats")
        momentum = {name: tree(f"mom/{name}") for name, _ in refs
                    if _unflatten(data, f"mom/{name}")}
        best = None
        if int(data["has_best"]):
            best = {name: (tree(f"best/{name}/params"),
                           tree(f"best/{name}/stats")) for name, _ in refs}
        n = len(self.net.p)
        for i in range(n):
            self.net.p[i] = data[f"prob/{i}"]
        h_e = [data[f"he/{i}"] for i in range(n)]
        h_a = [data[f"ha/{i}"] for i in range(n)]
        return (int(data["epoch"]) + 1, h_e, h_a, momentum, best,
                float(data["best_loss"]))

    def search(self, t: int, train_data, writer=None,
               checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 10, resume: bool = False,
               stop_after: Optional[int] = None, writes: bool = True):
        """Updates net.p in place; the caller then runs net.select(t).

        checkpoint_path: the state file, written every ``checkpoint_every``
        epochs; resume=True continues from it where it exists. stop_after:
        return after that many epochs, right after the state file's write
        and without the best-epoch restore (a simulated kill).
        writes=False: resume from the state file, write none (a
        data-parallel run's ranks other than 0)."""
        net, cfg = self.net, self.cfg
        if net.p is None or net.new_models is None:
            raise ValueError("op search before expand")
        rng = np.random.default_rng(cfg.seed + 9999 * t)
        train_idx, valid_idx = split_half(len(train_data),
                                          seed=cfg.seed + 9999 * t,
                                          frac=cfg.split_frac)

        h_e = [np.zeros(len(p), np.int64) for p in net.p]
        h_a = [np.zeros(len(p), np.float64) for p in net.p]
        for he in h_e:
            he[:-1] = cfg.o_size

        momentum: Dict = {}
        best: Optional[Dict] = None
        best_loss = np.inf
        start_epoch = 0
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            (start_epoch, h_e, h_a, momentum, best, best_loss) = \
                self.load_state(checkpoint_path, t, rng=rng)
            self.log(f"[op-search t{t}] resumed at epoch {start_epoch}")
        for epoch in range(start_epoch, cfg.epochs):
            lr = cosine_lr(cfg.lr, cfg.epochs, epoch, cfg.lr_min)
            selected = [int(rng.choice(len(p), p=p)) for p in net.p]
            arch = net.search_arch(selected, t)
            new_sites = [s for i, s in enumerate(SITE_NAMES)
                         if selected[i] == net.length(s) - 1]
            n_new = len(new_sites)
            model_size = 9.0 / max(n_new, 1)

            # only new units (and heads of task t) train; all BN frozen
            trainable = frozenset(new_sites + list(HEAD_NAMES))
            train_step, eval_step, optimizer = self._steps_for(arch, trainable)
            specs, params, stats = net.path(arch)
            opt_state = _inject_momentum(optimizer.init(params), momentum,
                                         trainable)

            for b in train_data.batches(cfg.batch, True, seed=epoch,
                                        indices=train_idx):
                params, stats, opt_state, _ = train_step(
                    params, stats, opt_state, lr, *self._batch_args(b))
            momentum.update(_extract_momentum(opt_state, trainable))

            outs = []
            for i, b in enumerate(train_data.batches(
                    cfg.batch, False, seed=0, indices=valid_idx)):
                if (cfg.eval_max_batches is not None
                        and i >= cfg.eval_max_batches):
                    break
                outs.append(eval_step(params, stats, *self._batch_args(b)))
            valid_m = AverageMeterDict().update_batched(outs)
            net.write_back(arch, params, stats)

            vm = valid_m.mean()
            quality, qlabel = self._quality(vm)
            valid_d1 = 1.0 - quality
            valid_loss = vm.get("loss", np.inf)
            reward = np.sqrt(quality) * np.log(model_size + 1.0) / np.e
            self.log(f"[op-search t{t}] epoch {epoch} sel={selected} "
                     f"n_new={n_new} valid loss {valid_loss:.3f} "
                     f"{qlabel} {100*valid_d1:.1f}% reward {reward:.4f}")
            if writer is not None:
                writer.scalars(f"search_op/task{t}",
                               {"valid_loss": valid_loss, "valid_d1": valid_d1,
                                "n_new": n_new}, step=epoch)

            for i, idx in enumerate(selected):
                h_e[i][idx] += 1
                h_a[i][idx] = reward
            for i in range(len(net.p)):
                net.p[i] = mdenas_update(net.p[i], h_e[i], h_a[i], cfg.lr_a)

            if valid_loss < best_loss:
                best_loss = valid_loss
                best = self._snapshot(t)

            if (writes and checkpoint_path
                    and (epoch + 1) % checkpoint_every == 0):
                self.save_state(checkpoint_path, t, epoch, h_e, h_a,
                                momentum, best, best_loss, rng=rng)
            if stop_after is not None and epoch + 1 >= stop_after:
                return

        if best is not None:
            self._restore(t, best)
