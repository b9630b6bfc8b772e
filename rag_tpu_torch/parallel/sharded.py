"""Mesh-sharded train and eval steps.

Counterpart of rag_tpu/parallel/sharded.py, its pure data-parallel half:
with a model axis of 1 both builders are the trainer's steps over the
mesh (every rank runs the whole step, kernels included, on its slice of
the batch; see train.trainer). rag_tpu's other half, a model axis > 1
that shards the cost volume's H across ranks, needs a halo exchange
around every 3D conv and is not ported yet (ROADMAP.md Queue 1 item 7b).
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
    return make_train_step(specs, bn_sites, optimizer,
                           trainable_sites=trainable_sites, maxdisp=maxdisp,
                           variants=variants, mesh=mesh)


def make_sharded_eval_step(mesh, specs: Mapping, maxdisp: int = MAXDISP,
                           variants: KernelVariants = DEFAULT):
    return make_eval_step(specs, maxdisp=maxdisp, variants=variants,
                          mesh=mesh)
