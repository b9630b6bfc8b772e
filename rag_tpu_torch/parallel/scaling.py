"""Data-parallel scaling: the driver's fine-tune step timed over worlds
of growing size.

Counterpart of rag_tpu/parallel/scaling.py::measure_scaling. Weak
scaling: each rank trains ``batch_per_rank`` pairs a step, so a world of
n takes a global batch of n * batch_per_rank; efficiency is a world's
pairs/s over n times the world of one's. Each world is the first n ranks
of the initialized process group (``parallel.multihost.
initialize_multihost``), the others waiting; the steps come from the
driver's own ``_ft_steps``, as the canonical experiment builds them, and
are timed with ``utils.timing.device_time``. Every rank of the group must
call it with the same arguments.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rag_tpu_torch.models.stereo import (
    build_head_specs,
    build_site_specs,
    init_sites,
)
from rag_tpu_torch.parallel.mesh import Mesh, barrier, make_mesh
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.train.trainer import make_optimizer
from rag_tpu_torch.utils.timing import device_time


def _batch(rng, n, h, w, device):
    return [torch.from_numpy(a).to(device) for a in (
        rng.standard_normal((n, h, w, 3)).astype(np.float32),
        rng.standard_normal((n, h, w, 3)).astype(np.float32),
        rng.uniform(1, 40, (n, h, w)).astype(np.float32))]


def _world_row(mesh: Mesh, batch_per_rank, hw, steps, warmup,
               maxdisp) -> Dict:
    """One world's step time: the driver's fine-tune step over ``mesh``,
    every site training, on a fresh default-genotype net seeded 0."""
    from rag_tpu_torch.continual.driver import (
        ContinualDriver,
        ExperimentConfig,
        TrainConfig,
    )

    n, dev = mesh.data, mesh.device
    gb = n * batch_per_rank
    g = default_genotype()
    specs = {**build_site_specs(g), **build_head_specs()}
    params, stats = init_sites(torch.Generator().manual_seed(0), specs,
                               device=dev)
    opt = make_optimizer(3e-4, 5.0)
    driver = ContinualDriver(
        ExperimentConfig(train=TrainConfig(batch=gb), mesh_data=n,
                         maxdisp=maxdisp),
        log=None, device=dev, mesh=mesh)
    step, _ = driver._ft_steps(specs, frozenset(specs), opt)
    h, w = hw
    left, right, gt = _batch(np.random.default_rng(0), gb, h, w, dev)
    state = [params, stats, opt.init(params)]

    def one(_):
        state[:3] = step(*state, 1e-3, left, right, gt)[:3]
        return state[1]

    sec = device_time(one, left, iters=steps, warmup=warmup)
    return {"world": n, "global_batch": gb, "step_ms": 1e3 * sec,
            "pairs_per_s": gb / sec, "pairs_per_s_per_rank": gb / sec / n}


def measure_scaling(worlds: Sequence[int] = (1, 2, 4, 8),
                    batch_per_rank: int = 2, hw=(48, 96), steps: int = 8,
                    warmup: int = 2, maxdisp: int = 192) -> List[Dict]:
    """A row per world size no larger than the group: world, global
    batch, ms a step, pairs/s in all and per rank, and the efficiency
    against the world of one (None where 1 is not among ``worlds``).
    Rank 0's rows hold its times; a rank outside a world has no row for
    it."""
    full = make_mesh()
    rows: List[Dict] = []
    base = None
    for n in worlds:
        if n > full.data:
            continue
        group = dist.new_group(list(range(n)))  # every rank calls this
        if full.rank < n:
            mesh = Mesh(data=n, rank=full.rank, device=full.device,
                        group=group, hosts=full.hosts)
            row = _world_row(mesh, batch_per_rank, hw, steps, warmup,
                             maxdisp)
            if n == 1:
                base = row["pairs_per_s"]
            row["efficiency"] = (row["pairs_per_s"] / (base * n)
                                 if base else None)
            rows.append(row)
        barrier(full)
    return rows
