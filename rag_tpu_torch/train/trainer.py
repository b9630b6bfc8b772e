"""Train and eval steps and the SGD optimizer stack.

Counterpart of rag_tpu/train/trainer.py: SGD with momentum 0.9 and weight
decay after a global-norm gradient clip of 5, a host-computed cosine
learning rate, the masked smooth-L1 loss, and freezing by site. BatchNorm
train-mode sites (``bn_sites``) are apart from the sites whose parameters
update (``trainable_sites``): the fine-tune stage of a task couples the
two, op search trains new units with every BatchNorm frozen.

The optimizer is optax's ``chain(clip_by_global_norm(clip),
add_decayed_weights(wd), trace(0.9))`` written out, with the reference's
freeze mask applied to the gradients before it and to the updates after
it.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch

from rag_tpu_torch.metrics.stereo import stereo_metrics
from rag_tpu_torch.models.stereo import MAXDISP, stereo_forward
from rag_tpu_torch.train.losses import smooth_l1_masked


def cosine_lr(base_lr: float, total_epochs: int, epoch: int,
              eta_min: float = 0.0) -> float:
    """torch CosineAnnealingLR closed form."""
    if total_epochs <= 0:
        return base_lr
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * epoch / total_epochs)) / 2


def _leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict, in a fixed order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


MOMENTUM = 0.9


class SGDMomentum:
    """optax ``chain(clip_by_global_norm(clip), add_decayed_weights(wd),
    trace(MOMENTUM))``. The state is the momentum trace, a tree shaped like
    the params."""

    def __init__(self, weight_decay: float, clip: float = 5.0):
        self.weight_decay = weight_decay
        self.clip = clip

    def init(self, params) -> Dict:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree)
        return zeros(params)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], trace, params) -> Dict:
        """Updates for the leaves in ``grads`` ({'site/...': gradient}); the
        trace of those leaves advances in place. Leaves absent from
        ``grads`` have zero gradient and get no update."""
        if not grads:
            return {}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        updates = {}
        for path, g in grads.items():
            g = torch.where(norm < self.clip, g, (g / norm) * self.clip)
            g = g + self.weight_decay * _get(params, path)
            t = _get(trace, path)
            t.copy_(g + MOMENTUM * t)
            updates[path] = t
        return updates


def make_optimizer(weight_decay: float, clip: float = 5.0) -> SGDMomentum:
    """torch SGD(momentum=.9, weight_decay) after a global-norm clip; the
    learning rate is passed to every step."""
    return SGDMomentum(weight_decay, clip)


@torch.no_grad()
def _sgd_apply(optimizer: SGDMomentum, params, grads, opt_state,
               lr: float) -> None:
    """The masked SGD tail, in place. ``grads`` holds the trainable leaves
    only: the freeze mask's zeros are never formed, so neither the clip
    norm, nor weight decay, nor the momentum trace sees a frozen leaf, and
    a frozen leaf gets no update."""
    for path, u in optimizer.update(grads, opt_state, params).items():
        _get(params, path).sub_(lr * u)


def supervised_loss(disp, disp_gt, maxdisp: int = MAXDISP):
    mask = (disp_gt > 0) & (disp_gt < maxdisp)
    return smooth_l1_masked(disp, disp_gt, mask), mask


def make_train_step(specs: Mapping, bn_sites: frozenset,
                    optimizer: SGDMomentum,
                    trainable_sites: Optional[frozenset] = None,
                    maxdisp: int = MAXDISP):
    """Returns step(params, stats, opt_state, lr, left, right, disp_gt) ->
    (params, stats, opt_state, scalars).

    bn_sites: sites whose BatchNorm runs in train mode (batch statistics
    and a running update). trainable_sites: sites whose params update;
    defaults to bn_sites.

    The step differentiates the forward (the fused head's loss, through
    kernels A-G on the card) with respect to the trainable sites' leaves
    only: a frozen site's gradient would be masked to zero, so it is never
    formed. ``params`` and ``opt_state`` are updated in place under
    ``torch.no_grad()`` and returned; ``stats`` is returned as a new tree.

    Momentum: the trace advances only for trainable leaves. Under optax
    the trace of a frozen leaf accumulates ``wd * p`` terms, but the
    masked updates never carry them into the params, so the params agree;
    only that unused part of the state differs (it stays zero here).
    """
    if trainable_sites is None:
        trainable_sites = bn_sites

    def step(params, stats, opt_state, lr: float, left, right, disp_gt):
        # trainable leaves enter the forward as detached copies that
        # require grad; the params themselves never do
        handles = {f"{site}/{path}": t.detach().requires_grad_(True)
                   for site in sorted(params) if site in trainable_sites
                   for path, t in _leaves(params[site])}

        def swap(tree, prefix):
            if isinstance(tree, dict):
                return {k: swap(v, f"{prefix}{k}/") for k, v in tree.items()}
            return handles.get(prefix[:-1], tree)

        p_diff = swap(params, "")
        with torch.enable_grad():
            disp, new_stats = stereo_forward(specs, p_diff, stats, left, right,
                                             train_sites=bn_sites,
                                             maxdisp=maxdisp)
            loss, mask = supervised_loss(disp, disp_gt, maxdisp)
            grads = torch.autograd.grad(loss, list(handles.values()),
                                        allow_unused=True)
        grads = {path: torch.zeros_like(handles[path]) if g is None else g
                 for path, g in zip(handles, grads)}
        _sgd_apply(optimizer, params, grads, opt_state, lr)
        with torch.no_grad():
            scalars = {"loss": loss.detach(),
                       **stereo_metrics(disp.detach(), disp_gt, mask)}
        return params, new_stats, opt_state, scalars

    return step


def make_eval_step(specs: Mapping, maxdisp: int = MAXDISP):
    """step(params, stats, left, right, disp_gt) -> dict of 0-d tensors:
    the frozen-BN serving forward, the masked loss and the stereo metrics."""

    @torch.inference_mode()
    def step(params, stats, left, right, disp_gt):
        disp, _ = stereo_forward(specs, params, stats, left, right,
                                 maxdisp=maxdisp)
        loss, mask = supervised_loss(disp, disp_gt, maxdisp)
        return {"loss": loss, **stereo_metrics(disp, disp_gt, mask)}

    return step
