"""Op-level growth search: reuse-vs-new selection over the expanded
network.

Counterpart of rag_tpu/search/growth.py (stereo; without the mid-search
state files, fault injection, mesh and depth variant). After ``expand``
every searchable site holds L reuse candidates + 1 new unit; per epoch a
full path is sampled from the per-site categoricals, trained for an epoch
(only the new units and task t's heads are trainable; every BatchNorm is
frozen), scored on the held-out half, and the per-site probabilities
updated with the MdeNAS pairwise rule under the reusability reward

    h_a = sqrt(1 - valid_D1) * log(9 / max(n_new, 1) + 1) / e

(n_new: the sites that picked their new unit), with the reuse head start
h_e[site][:-1] = o_size.

One SGD momentum store persists over the whole search: a site's momentum
carries from the last epoch that trained it. The best-by-valid-loss epoch's
new units and heads are copied and restored into the registry after the
search (copies: the train step updates the registry's tensors in place).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from rag_tpu_torch.data.stereo_dataset import split_half
from rag_tpu_torch.metrics.meters import AverageMeterDict
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.stereo import HEAD_NAMES, SITE_NAMES
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.search.mdenas import mdenas_update
from rag_tpu_torch.train.trainer import (
    clone_tree,
    cosine_lr,
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


def _stereo_steps(specs, trainable, optimizer, maxdisp, variants):
    # bn_sites = {}: every BatchNorm frozen during op search
    return (make_train_step(specs, frozenset(), optimizer,
                            trainable_sites=trainable, maxdisp=maxdisp,
                            variants=variants),
            make_eval_step(specs, maxdisp=maxdisp, variants=variants))


def _stereo_args(batch):
    return (batch["left"], batch["right"], batch["disparity"])


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
                 variants: KernelVariants = DEFAULT):
        self.net = net
        self.cfg = config
        self.log = log or (lambda *_: None)
        self.variants = variants
        self._step_cache = {}

    def _steps_for(self, arch, trainable):
        specs, _, _ = self.net.path(arch)
        key = (tuple(sorted((k, s) for k, s in specs.items())),
               tuple(sorted(trainable)))
        if key not in self._step_cache:
            optimizer = make_optimizer(self.cfg.weight_decay,
                                       self.cfg.grad_clip)
            train_step, eval_step = _stereo_steps(
                specs, trainable, optimizer, self.cfg.maxdisp, self.variants)
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

    def search(self, t: int, train_data, writer=None):
        """Updates net.p in place; the caller then runs net.select(t)."""
        net, cfg = self.net, self.cfg
        if net.p is None or net.new_models is None:
            raise ValueError("op search before expand")
        rng = np.random.default_rng(cfg.seed + 9999 * t)
        train_idx, valid_idx = split_half(len(train_data),
                                          seed=cfg.seed + 9999 * t)

        h_e = [np.zeros(len(p), np.int64) for p in net.p]
        h_a = [np.zeros(len(p), np.float64) for p in net.p]
        for he in h_e:
            he[:-1] = cfg.o_size

        momentum: Dict = {}
        best: Optional[Dict] = None
        best_loss = np.inf
        for epoch in range(cfg.epochs):
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
                    params, stats, opt_state, lr, *_stereo_args(b))
            momentum.update(_extract_momentum(opt_state, trainable))

            valid_m = AverageMeterDict().update_batched(
                [eval_step(params, stats, *_stereo_args(b))
                 for b in train_data.batches(cfg.batch, False, seed=0,
                                             indices=valid_idx)])
            net.write_back(arch, params, stats)

            vm = valid_m.mean()
            quality = 1.0 - min(max(vm.get("D1", 1.0), 0.0), 1.0)
            valid_d1 = 1.0 - quality
            valid_loss = vm.get("loss", np.inf)
            reward = np.sqrt(quality) * np.log(model_size + 1.0) / np.e
            self.log(f"[op-search t{t}] epoch {epoch} sel={selected} "
                     f"n_new={n_new} valid loss {valid_loss:.3f} "
                     f"D1 {100*valid_d1:.1f}% reward {reward:.4f}")
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

        if best is not None:
            self._restore(t, best)
