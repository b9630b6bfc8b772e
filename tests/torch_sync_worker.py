"""One rank of the gloo world that tests/test_torch_mesh_driver.py's
stage-sync test starts:

    python tests/torch_sync_worker.py RANK WORLD ADDRESS OUT.npz

Runs two tasks and the router of the driver over a world-2 mesh with
batches of 3, which do not divide by 2, so that every stage falls back to
single-process steps on each rank, and gives each rank a result or a
starting point of its own in every stage: the cell search returns a
genotype per rank, every unit's weights are moved by rank / 100 before
each fine-tune and the op search, rank 1's op search ends with its
probabilities reversed, and the router starts from seed = rank. Writes
the net every rank holds after each task, its archis and genotypes, the
router, and rank 0's fallback log lines to OUT.npz. One torch thread;
imports no jax.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from rag_tpu_torch.continual.driver import (  # noqa: E402
    ContinualDriver,
    ExperimentConfig,
    TrainConfig,
)
from rag_tpu_torch.data.synthetic import SyntheticStereoDataset  # noqa: E402
from rag_tpu_torch.models.router import SceneRouter  # noqa: E402
from rag_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from rag_tpu_torch.parallel.multihost import initialize_multihost  # noqa: E402
from rag_tpu_torch.search.genotype import (  # noqa: E402
    default_genotype,
    parse_genotype,
)
from rag_tpu_torch.search.growth import OpSearchConfig  # noqa: E402

GENOTYPES = (default_genotype(),
             parse_genotype(np.zeros((9, 2)), np.zeros((9, 2))))
CONFIG = ExperimentConfig(
    num_tasks=2, maxdisp=24, mesh_data=2,
    train=TrainConfig(epochs=1, batch=3),
    op=OpSearchConfig(epochs=1, batch=3, o_size=2),
    router_epochs=1, router_batch=3)


class FixedCellSearch:
    def __init__(self, genotype):
        self.genotype = genotype

    def search(self, *args, **kw):
        return self.genotype


class SkewedOpSearch:
    """The driver's op search, from weights moved per rank, its
    probabilities reversed on rank 1 at the end."""

    def __init__(self, search, driver):
        self.inner, self.driver = search, driver

    def search(self, *args, **kw):
        self.driver._nudge()
        self.inner.search(*args, **kw)
        if self.driver.mesh.rank == 1:
            self.driver.net.p = [p[::-1].copy() for p in self.driver.net.p]


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


class SkewedDriver(ContinualDriver):
    def _nudge(self):
        with torch.no_grad():
            for u in self.net.all_units():
                for v in leaves(u.params):
                    v.add_(self.mesh.rank / 100)

    def _cell_search(self, t):
        return FixedCellSearch(GENOTYPES[self.mesh.rank])

    def _op_search(self):
        return SkewedOpSearch(super()._op_search(), self)

    def _pre_finetune(self, t):
        self._nudge()


def flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(f"{prefix}{k}/", v, out)
        else:
            out[prefix + k] = v.detach().cpu().numpy().copy()


def main():
    rank, world, address, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4])
    initialize_multihost(address, world, rank, device="cpu")
    lines = []
    driver = SkewedDriver(CONFIG, log=lines.append, device="cpu",
                          mesh=make_mesh())
    ds = [SyntheticStereoDataset(6, 24, 48, seed=t, max_disp=20.0,
                                 device="cpu") for t in range(2)]
    arrays = {}
    for t in range(2):
        driver.train_task(t, ds[t], ds[t])
        net = driver.net
        for site, units in {**net.units, **net.heads}.items():
            for i, u in enumerate(units):
                flat(f"net/t{t}/{site}/{i}/params/", u.params, arrays)
                flat(f"net/t{t}/{site}/{i}/stats/", u.stats, arrays)
    driver.router = SceneRouter(2, seed=rank, device="cpu")
    driver.train_router(1, ds, ds)
    flat("router/params/", driver.router.params, arrays)
    flat("router/opt/", driver.router.opt_state, arrays)
    np.savez(out_path, archis=json.dumps(net.archis),
             genotypes=repr(net.genotypes), log=json.dumps(lines), **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
