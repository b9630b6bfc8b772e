"""One rank of the gloo world that tests/test_torch_dp.py starts:

    python tests/torch_dp_worker.py RANK WORLD ADDRESS OUT.npz

Joins the process group on the CPU, runs every case of tests/dp_cases.py
over the world's mesh, counts the all-reduces of the chip's task-0 step,
reads a MultihostBatcher's global batches, and writes it all to OUT.npz.
One torch thread; imports no jax.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import dp_cases  # noqa: E402
from rag_tpu_torch.data.synthetic import SyntheticStereoDataset  # noqa: E402
from rag_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from rag_tpu_torch.parallel.multihost import (  # noqa: E402
    MultihostBatcher,
    initialize_multihost,
    process_info,
)


def main():
    rank, world, address, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4])
    ckpt = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "logs", "canonical_learn_r4")
    initialize_multihost(address, world, rank, device="cpu")
    assert process_info() == (rank, world)
    mesh = make_mesh()
    arrays, counts = {}, {}
    for name, (res, n) in dp_cases.run_cases(mesh).items():
        counts[name] = n
        arrays.update({f"{name}/{k}": v for k, v in res.items()})
    counts["task0"] = dp_cases.task0_all_reduces(mesh, ckpt)
    ds = SyntheticStereoDataset(10, 12, 24, seed=5, device="cpu")
    for i, b in enumerate(MultihostBatcher(ds, mesh).batches(
            4, True, seed=3)):
        arrays[f"multihost/{i}"] = b["left"].numpy()
    np.savez(out_path, counts=json.dumps(counts), **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
