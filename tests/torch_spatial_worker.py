"""One rank of the gloo world that tests/test_torch_spatial.py and
tests/test_torch_halo.py start:

    python tests/torch_spatial_worker.py RANK WORLD ADDRESS OUT.npz [halo]

Joins the process group on the CPU, builds the (data, model) mesh of
spatial_cases.MESHES[WORLD], runs every case of tests/spatial_cases.py
over it (with ``halo``: the halo adjoint checks instead), and writes them
to OUT.npz. One torch thread; imports no jax.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import spatial_cases  # noqa: E402
from rag_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from rag_tpu_torch.parallel.multihost import initialize_multihost  # noqa: E402


def main():
    rank, world, address, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4])
    initialize_multihost(address, world, rank, device="cpu")
    mesh = make_mesh(*spatial_cases.MESHES[world])
    assert (mesh.d, mesh.m) == divmod(rank, mesh.model)
    arrays = {}
    if sys.argv[5:] == ["halo"]:
        arrays["adjoints"] = json.dumps(spatial_cases.adjoints(mesh))
    else:
        for name, res in spatial_cases.run_cases(mesh).items():
            arrays.update({f"{name}/{k}": v for k, v in res.items()})
    np.savez(out_path, **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
