"""Mesh-sharded train and eval steps.

Counterpart of rag_tpu/parallel/sharded.py. Both of its regimes are the
trainer's steps over the mesh:

  * model axis 1 (pure data parallelism): every rank runs the whole step,
    kernels included, on its slice of the batch (see train.trainer);
  * model axis > 1 (rag_tpu's GSPMD steps, which constrain the cost
    volume to P(data, None, model) and leave the halo exchanges to XLA,
    so that no Pallas kernel runs there): every rank runs the same
    hand-written kernels on its H slab of the matching volumes, with the
    halo rows and whole-H gathers exchanged explicitly
    (``parallel.halo``), and the batch statistics, loss, metrics and
    gradients reduced as the single-device step has them
    (``models.stereo``, ``train.trainer``).
"""

from __future__ import annotations

from typing import Mapping

from rag_tpu_torch.models.stereo import MAXDISP
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.train.trainer import make_eval_step, make_train_step


def make_sharded_train_step(mesh, specs: Mapping, bn_sites: frozenset,
                            optimizer, trainable_sites: frozenset = None,
                            maxdisp: int = MAXDISP,
                            variants: KernelVariants = DEFAULT):
    """step(params, stats, opt_state, lr, left, right, disp_gt) over
    ``mesh``: the global batch in, every rank left with the single-device
    step's params, statistics, momentum and scalars."""
    return make_train_step(specs, bn_sites, optimizer,
                           trainable_sites=trainable_sites, maxdisp=maxdisp,
                           variants=variants, mesh=mesh)


def make_sharded_eval_step(mesh, specs: Mapping, maxdisp: int = MAXDISP,
                           variants: KernelVariants = DEFAULT):
    """step(params, stats, left, right, disp_gt) -> the global batch's
    scalars on every rank of ``mesh``."""
    return make_eval_step(specs, maxdisp=maxdisp, variants=variants,
                          mesh=mesh)
