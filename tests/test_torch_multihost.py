"""rag_tpu_torch.parallel.multihost and mesh on one process: the index
shards equal rag_tpu's (tests/test_multihost.py's cases and every n in
1..17 over 1..5 ranks, the wrapped tail included), and the pieces that
need no process group."""

import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.parallel.multihost import host_local_indices as j_indices
from rag_tpu_torch.parallel.axis import all_mean_if, all_sum_if, data_group
from rag_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from rag_tpu_torch.parallel.multihost import host_local_indices, process_info


def test_host_local_indices_partition():
    a = host_local_indices(100, process_index=0, process_count=4)
    b = host_local_indices(100, process_index=3, process_count=4)
    assert len(a) == len(b) == 25
    assert a[0] == 0 and b[0] == 75
    all_idx = np.concatenate([
        host_local_indices(100, process_index=i, process_count=4)
        for i in range(4)])
    assert sorted(all_idx.tolist()) == list(range(100))


def test_host_local_indices_non_divisible_wraps_tail():
    shards = [host_local_indices(7, process_index=i, process_count=2)
              for i in range(2)]
    np.testing.assert_array_equal(shards[0], [0, 1, 2, 3])
    np.testing.assert_array_equal(shards[1], [4, 5, 6, 0])
    shards = [host_local_indices(10, process_index=i, process_count=3)
              for i in range(3)]
    assert all(len(s) == 4 for s in shards)
    assert set(np.concatenate(shards).tolist()) == set(range(10))


@pytest.mark.parametrize("n", range(1, 18))
@pytest.mark.parametrize("pc", range(1, 6))
def test_host_local_indices_equal_rag_tpu(n, pc):
    for pi in range(pc):
        mine = host_local_indices(n, process_index=pi, process_count=pc)
        ref = j_indices(n, process_index=pi, process_count=pc)
        assert mine.dtype.kind == "i"
        np.testing.assert_array_equal(mine, ref)
    covered = np.concatenate([host_local_indices(n, i, pc)
                              for i in range(pc)])
    assert set(covered.tolist()) == set(range(n))


def test_single_process_defaults():
    assert process_info() == (0, 1)
    np.testing.assert_array_equal(host_local_indices(5), np.arange(5))
    x = torch.arange(4.0)
    assert all_sum_if(x, None) is x and all_mean_if(x, None) is x
    assert data_group(None) is None
    with pytest.raises(RuntimeError):
        make_mesh()


def test_mesh_model_axis_raises():
    # a model axis needs its data and model groups (make_mesh builds them)
    with pytest.raises(ValueError, match="process groups"):
        Mesh(data=2, rank=0, device=torch.device("cpu"), group=None, model=2)


def test_shard_batch_takes_contiguous_rows():
    batch = {"x": torch.arange(12.0).reshape(6, 2)}
    for r in range(3):
        mesh = Mesh(data=3, rank=r, device=torch.device("cpu"), group=None)
        np.testing.assert_array_equal(
            shard_batch(batch, mesh)["x"].numpy(),
            np.arange(12.0).reshape(6, 2)[2 * r:2 * r + 2])
    with pytest.raises(ValueError):
        shard_batch({"x": torch.zeros(5)}, Mesh(3, 0, torch.device("cpu"),
                                                None))
