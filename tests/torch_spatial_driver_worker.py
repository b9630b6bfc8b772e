"""One rank of the gloo world that tests/test_torch_mesh_driver.py's
spatial-driver test starts:

    python tests/torch_spatial_driver_worker.py RANK WORLD ADDRESS OUT.npz

Runs the driver over two tasks on a 1 x WORLD mesh (the fine-tune's
steps split H over the model axis; cell search and op search run alone
on each rank, then take rank 0's result) and writes the forgetting
matrix, rank 0's log and the net every rank holds at the end to OUT.npz.
The same run without a mesh is ``run(None)``. One torch thread; imports
no jax.
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
from rag_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from rag_tpu_torch.parallel.multihost import initialize_multihost  # noqa: E402
from rag_tpu_torch.search.growth import OpSearchConfig  # noqa: E402
from rag_tpu_torch.search.mdenas import CellSearchConfig  # noqa: E402


def config(model):
    return ExperimentConfig(
        num_tasks=2, maxdisp=24, mesh_model=model,
        cell=CellSearchConfig(epochs=1, batch=2),
        train=TrainConfig(epochs=2, batch=2),
        op=OpSearchConfig(epochs=1, batch=2, o_size=2))


def run(mesh):
    """(matrix {metric: array}, log lines, {leaf path: array})."""
    lines = []
    driver = ContinualDriver(config(1 if mesh is None else mesh.model),
                             log=lines.append, device="cpu", mesh=mesh)
    ds = [SyntheticStereoDataset(4, 24, 48, seed=t, max_disp=16.0,
                                 device="cpu") for t in range(2)]
    matrix = driver.run(ds, ds, ds)
    net = {}
    for site, units in {**driver.net.units, **driver.net.heads}.items():
        for i, u in enumerate(units):
            for part, tree in (("params", u.params), ("stats", u.stats)):
                stack = [(f"net/{site}/{i}/{part}/", tree)]
                while stack:
                    prefix, node = stack.pop()
                    for k, v in node.items():
                        if isinstance(v, dict):
                            stack.append((f"{prefix}{k}/", v))
                        else:
                            net[prefix + k] = v.detach().numpy().copy()
    return {k: v.copy() for k, v in matrix.m.items()}, lines, net


def main():
    rank, world, address, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4])
    initialize_multihost(address, world, rank, device="cpu")
    matrix, lines, net = run(make_mesh(1, world))
    np.savez(out_path, log=json.dumps(lines),
             **{f"matrix/{k}": v for k, v in matrix.items()}, **net)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
