"""Train and eval steps and the SGD optimizer stack.

Counterpart of rag_tpu/train/trainer.py: SGD with momentum 0.9 and weight
decay after a global-norm gradient clip of 5, a host-computed cosine
learning rate, the masked smooth-L1 loss, and freezing by site. The
variants' steps share that tail: the self-supervised step trains the
stereo forward on the photometric loss (``make_selfsup_train_step``), the
depth steps the depth net on silog (``make_depth_train_step``,
``make_depth_eval_step``). BatchNorm
train-mode sites (``bn_sites``) are apart from the sites whose parameters
update (``trainable_sites``): the fine-tune stage of a task couples the
two, op search trains new units with every BatchNorm frozen.

The optimizer is optax's ``chain(clip_by_global_norm(clip),
add_decayed_weights(wd), trace(0.9))`` written out, with the reference's
freeze mask applied to the gradients before it and to the updates after
it.

Every step runs its forward and takes its gradients inside
``reproducible()`` (``models.stereo``): full float32 and cuDNN's
deterministic algorithms. ATen reads those switches when the backward
runs, so a backward taken after the forward's scope closed would run its
convs in TF32 wherever the caller left them on, and in whatever
algorithm cuDNN's heuristics pick; inside the scope a step taken twice
from one state gives the same bits.

Data parallelism: every step builder takes ``mesh=None``. With a mesh
(``parallel.mesh.make_mesh``), the step takes the global batch on every
rank, runs the same body on its rank's slice of it with every batch-wide
statistic reduced across the ranks (BatchNorm statistics, the loss's and
the metrics' sums; ``parallel.axis``), differentiates the global loss
divided by the world size and sums the gradients over the ranks before
the SGD tail, so that every rank ends the step with the single-process
params, statistics and optimizer state.

Spatial sharding: the supervised ``make_train_step`` and
``make_eval_step`` also take a mesh whose model axis is > 1 (the
counterpart of rag_tpu/parallel/sharded.py's GSPMD steps). Each rank then
runs the forward on its data index's images and its H slab of the
matching volumes (``models.stereo``), and its share of the loss is the
masked smooth-L1 sum over its rows of the disparity over the
world-summed mask count; the world-summed loss is differentiated through
the all-reduce's transpose exactly as above, and every parameter's
gradient is summed over the world once. The feature net's BatchNorm
statistics reduce over the data axis only, the matching net's over the
world, and the metrics add up each image's pieces over the world. The
other builders take a data-parallel mesh only.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch

from rag_tpu_torch.metrics.depth import depth_metrics
from rag_tpu_torch.metrics.stereo import stereo_metrics
from rag_tpu_torch.models.depth import depth_forward
from rag_tpu_torch.models.stereo import (
    MAXDISP,
    disparity_rows,
    reproducible,
    stereo_forward,
)
from rag_tpu_torch.ops.precision import FP32, Precision
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.parallel.axis import (
    all_sum_tree,
    bn_collective,
    data_group,
    world_size,
)
from rag_tpu_torch.parallel.mesh import rank_slice
from rag_tpu_torch.utils.profiling import check_finite
from rag_tpu_torch.train.losses import (
    photometric_loss,
    silog_loss,
    smooth_l1_masked,
)


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


def clone_tree(tree):
    """A copy of a nested dict of tensors: a snapshot that in-place
    updates of the original do not reach."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


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
def sgd_apply(optimizer: SGDMomentum, params, grads, opt_state,
              lr: float) -> None:
    """The masked SGD tail, in place. ``grads`` holds the trainable leaves
    only: the freeze mask's zeros are never formed, so neither the clip
    norm, nor weight decay, nor the momentum trace sees a frozen leaf, and
    a frozen leaf gets no update."""
    for path, u in optimizer.update(grads, opt_state, params).items():
        _get(params, path).sub_(lr * u)


def differentiable(params, sites):
    """({'site/...': handle}, params tree with the handles in place) for
    the leaves of ``sites``: each enters the forward as a detached copy
    that requires grad, so the params themselves never do."""
    handles = {f"{site}/{path}": t.detach().requires_grad_(True)
               for site in sorted(params) if site in sites
               for path, t in _leaves(params[site])}

    def swap(tree, prefix):
        if isinstance(tree, dict):
            return {k: swap(v, f"{prefix}{k}/") for k, v in tree.items()}
        return handles.get(prefix[:-1], tree)

    return handles, swap(params, "")


def grads_of(loss, handles) -> Dict[str, torch.Tensor]:
    """d loss / d handle for every handle; zeros where the loss does not
    depend on it (an unsampled edge), as jax.grad gives them. The caller
    holds the switches (``train_update`` runs it in ``reproducible()``)."""
    grads = torch.autograd.grad(loss, list(handles.values()),
                                allow_unused=True)
    return {path: torch.zeros_like(handles[path]) if g is None else g
            for path, g in zip(handles, grads)}


def local_batch(mesh, *tensors):
    """This rank's slices of the global batch's tensors (the tensors
    themselves without a mesh)."""
    if mesh is None:
        return tensors
    return tuple(rank_slice(t, mesh) for t in tensors)


def dp_only(mesh, what: str):
    """mesh, where it has no model axis; ValueError otherwise."""
    if mesh is not None and mesh.spatial:
        raise ValueError(f"{what}: a model axis of {mesh.model} is taken by "
                         "the supervised stereo steps only")
    return mesh


def slab_target(disp_gt: torch.Tensor, mesh) -> torch.Tensor:
    """The rows of a (B, H, W) target that this rank's disparity covers
    (all of them without a model axis)."""
    r0, r1 = disparity_rows(disp_gt.shape[1], mesh)
    return disp_gt[:, r0:r1]


def train_update(params, sites, optimizer: SGDMomentum, opt_state, lr: float,
                 group, forward, bn_group=None):
    """The train steps' shared body. ``forward(p_diff)`` -> (loss, output,
    new_stats) runs with the trainable ``sites``' leaves differentiable and
    BatchNorm reducing over ``bn_group`` (default ``group``); then the
    gradients of loss / world, summed over the ranks of ``group``, take
    the masked SGD step in place. Returns the detached (loss, output) and
    new_stats. The forward and the backward run in ``reproducible()``."""
    handles, p_diff = differentiable(params, sites)
    with torch.enable_grad(), reproducible():
        with bn_collective(group if bn_group is None else bn_group):
            loss, out, new_stats = forward(p_diff)
        grads = grads_of(loss / world_size(group), handles)
    grads = all_sum_tree(grads, group)
    check_finite(loss=loss, output=out, **grads)
    sgd_apply(optimizer, params, grads, opt_state, lr)
    return loss.detach(), out.detach(), new_stats


def supervised_loss(disp, disp_gt, maxdisp: int = MAXDISP, group=None):
    mask = (disp_gt > 0) & (disp_gt < maxdisp)
    return smooth_l1_masked(disp, disp_gt, mask, group=group), mask


def make_train_step(specs: Mapping, bn_sites: frozenset,
                    optimizer: SGDMomentum,
                    trainable_sites: Optional[frozenset] = None,
                    maxdisp: int = MAXDISP,
                    variants: KernelVariants = DEFAULT, mesh=None,
                    precision: Precision = FP32):
    """Returns step(params, stats, opt_state, lr, left, right, disp_gt) ->
    (params, stats, opt_state, scalars).

    bn_sites: sites whose BatchNorm runs in train mode (batch statistics
    and a running update). trainable_sites: sites whose params update;
    defaults to bn_sites. variants: the optional kernels the forward and
    its backward run (see ops.variants). mesh: data parallelism over its
    ranks (see the module docstring). precision: the activations' storage
    dtypes (ops.precision); params, momentum, statistics and gradients
    stay float32.

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
    group = data_group(mesh)

    def step(params, stats, opt_state, lr: float, left, right, disp_gt):
        left, right, disp_gt = local_batch(mesh, left, right, disp_gt)
        disp_gt = slab_target(disp_gt, mesh)

        def forward(p):
            disp, new_stats = stereo_forward(specs, p, stats, left, right,
                                             train_sites=bn_sites,
                                             maxdisp=maxdisp,
                                             variants=variants, mesh=mesh,
                                             precision=precision)
            loss, _ = supervised_loss(disp, disp_gt, maxdisp, group)
            return loss, disp, new_stats

        loss, disp, new_stats = train_update(
            params, trainable_sites, optimizer, opt_state, lr, group, forward,
            None if mesh is None else mesh.data_group)
        with torch.no_grad():
            mask = (disp_gt > 0) & (disp_gt < maxdisp)
            scalars = {"loss": loss,
                       **stereo_metrics(disp, disp_gt, mask, mesh)}
        return params, new_stats, opt_state, scalars

    return step


def make_eval_step(specs: Mapping, maxdisp: int = MAXDISP,
                   variants: KernelVariants = DEFAULT, mesh=None,
                   precision: Precision = FP32):
    """step(params, stats, left, right, disp_gt) -> dict of 0-d tensors:
    the frozen-BN serving forward, the masked loss and the stereo metrics
    (over the ranks' slices with a mesh)."""
    group = data_group(mesh)

    @torch.inference_mode()
    def step(params, stats, left, right, disp_gt):
        left, right, disp_gt = local_batch(mesh, left, right, disp_gt)
        disp_gt = slab_target(disp_gt, mesh)
        disp, _ = stereo_forward(specs, params, stats, left, right,
                                 maxdisp=maxdisp, variants=variants,
                                 mesh=mesh, precision=precision)
        loss, mask = supervised_loss(disp, disp_gt, maxdisp, group)
        return {"loss": loss,
                **stereo_metrics(disp, disp_gt, mask, mesh)}

    return step


def make_selfsup_train_step(specs: Mapping, bn_sites: frozenset,
                            optimizer: SGDMomentum,
                            trainable_sites: Optional[frozenset] = None,
                            maxdisp: int = MAXDISP,
                            variants: KernelVariants = DEFAULT, mesh=None,
                            precision: Precision = FP32):
    """The photometric (self-supervised) step: make_train_step's forward,
    freezing and SGD tail, with ``photometric_loss(disp, left, right)`` in
    place of the supervised loss. ``disp_gt`` serves the D1/EPE
    monitoring over 0 < gt < maxdisp only; the loss never sees it."""
    if trainable_sites is None:
        trainable_sites = bn_sites
    group = data_group(dp_only(mesh, "make_selfsup_train_step"))

    def step(params, stats, opt_state, lr: float, left, right, disp_gt):
        left, right, disp_gt = local_batch(mesh, left, right, disp_gt)

        def forward(p):
            disp, new_stats = stereo_forward(specs, p, stats, left, right,
                                             train_sites=bn_sites,
                                             maxdisp=maxdisp,
                                             variants=variants,
                                             precision=precision)
            return photometric_loss(disp, left, right, group), disp, new_stats

        loss, disp, new_stats = train_update(params, trainable_sites,
                                             optimizer, opt_state, lr, group,
                                             forward)
        with torch.no_grad():
            mask = (disp_gt > 0) & (disp_gt < maxdisp)
            scalars = {"loss": loss,
                       **stereo_metrics(disp, disp_gt, mask, mesh)}
        return params, new_stats, opt_state, scalars

    return step


def make_depth_train_step(specs: Mapping, bn_sites: frozenset,
                          optimizer: SGDMomentum,
                          trainable_sites: Optional[frozenset] = None,
                          mesh=None, precision: Precision = FP32):
    """step(params, stats, opt_state, lr, image, depth_gt) -> (params,
    stats, opt_state, scalars): silog over gt > 0 through depth_forward,
    and the depth metrics."""
    if trainable_sites is None:
        trainable_sites = bn_sites
    group = data_group(dp_only(mesh, "make_depth_train_step"))

    def step(params, stats, opt_state, lr: float, image, depth_gt):
        image, depth_gt = local_batch(mesh, image, depth_gt)
        mask = depth_gt > 0

        def forward(p):
            pred, new_stats = depth_forward(specs, p, stats, image,
                                            train_sites=bn_sites,
                                            precision=precision)
            return silog_loss(pred, depth_gt, mask, group=group), pred, \
                new_stats

        loss, pred, new_stats = train_update(params, trainable_sites,
                                             optimizer, opt_state, lr, group,
                                             forward)
        with torch.no_grad():
            scalars = {"loss": loss,
                       **depth_metrics(pred, depth_gt, mask, group)}
        return params, new_stats, opt_state, scalars

    return step


def make_depth_eval_step(specs: Mapping, mesh=None,
                         precision: Precision = FP32):
    """step(params, stats, image, depth_gt) -> dict of 0-d tensors: the
    frozen-BN depth forward, silog and the depth metrics."""
    group = data_group(dp_only(mesh, "make_depth_eval_step"))

    @torch.inference_mode()
    def step(params, stats, image, depth_gt):
        image, depth_gt = local_batch(mesh, image, depth_gt)
        pred, _ = depth_forward(specs, params, stats, image,
                                precision=precision)
        mask = depth_gt > 0
        return {"loss": silog_loss(pred, depth_gt, mask, group=group),
                **depth_metrics(pred, depth_gt, mask, group)}

    return step
