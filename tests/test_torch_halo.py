"""The model axis's collectives of the port (rag_tpu_torch.parallel.halo)
on the CPU, and the slab rule of parallel.mesh.

Worlds of 2 and 3 gloo rank processes (tests/torch_spatial_worker.py in
its ``halo`` mode, meshes 1x2 and 1x3) apply ``halo_rows`` (k = 1 and 2,
zero-padded and unpadded at the global edges), ``gather_h`` and
``slice_h`` to random float64 slabs of an H axis that splits unevenly,
and take each one's adjoint by autograd through its backward: the
dot-product test <A x, u> = <x, A^T u>, summed over the model group,
holds to 1e-12, and slice_h(gather_h(x)) is x.
"""

import json
from pathlib import Path

import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rank_worlds import launch_worlds
from rag_tpu_torch.parallel.mesh import Mesh, slab_rows

WORKER = Path(__file__).resolve().parent / "torch_spatial_worker.py"
NAMES = ("halo_rows_pad_k1", "halo_rows_nopad_k1", "halo_rows_pad_k2",
         "halo_rows_nopad_k2", "gather_h", "slice_h")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    outs = launch_worlds(WORKER, {n: tmp_path_factory.mktemp(f"halo{n}")
                                  for n in (2, 3)}, "halo")
    return {n: [json.loads(str(o["adjoints"])) for o in ranks]
            for n, ranks in outs.items()}


@pytest.fixture(params=[2, 3])
def world(worlds, request):
    return worlds[request.param]


@pytest.mark.parametrize("name", NAMES)
def test_adjoint(world, name):
    for rank, adj in enumerate(world):
        ax, xt = adj[name]
        assert abs(ax - xt) <= 1e-12 * max(abs(ax), 1.0), (rank, ax, xt)
        # every rank sees the same world sums
        assert adj[name] == world[0][name]


def test_gather_then_slice_is_identity(world):
    for adj in world:
        assert adj["gather_slice_identity"][0] == 0.0


@pytest.mark.parametrize("h,model", [(16, 2), (16, 3), (8, 3), (4, 3),
                                     (64, 2), (13, 4)])
def test_slab_rows_cover_h_once(h, model):
    rows = [slab_rows(h, model, m) for m in range(model)]
    assert rows[0][0] == 0 and rows[-1][1] == h
    for (a0, a1), (b0, b1) in zip(rows, rows[1:]):
        assert a1 == b0
    assert all(r1 - r0 >= 1 for r0, r1 in rows)
    assert [r1 - r0 for r0, r1 in rows] == [
        (m + 1) * h // model - m * h // model for m in range(model)]


def test_slab_rows_of_task0_and_the_test_size():
    # task 0's 192x384 crop: h = 64, slabs of 32/16/8 rows by scale
    assert [slab_rows(h, 2, 1) for h in (64, 32, 16)] == [
        (32, 64), (16, 32), (8, 16)]
    # 48x96 over three ranks: 5/5/6 rows, one-row slabs at 1/4 scale
    assert [slab_rows(16, 3, m) for m in range(3)] == [(0, 5), (5, 10),
                                                       (10, 16)]
    assert [slab_rows(4, 3, m) for m in range(3)] == [(0, 1), (1, 2), (2, 4)]


def test_slab_rows_empty_slab_raises():
    with pytest.raises(ValueError, match="2 rows .* 3 ranks"):
        slab_rows(2, 3, 0)


def test_mesh_indices_follow_the_rank_layout():
    cpu = torch.device("cpu")
    for rank in range(6):
        mesh = Mesh(data=3, rank=rank, device=cpu, group=None, model=2,
                    data_group=object(), model_group=object())
        assert (mesh.d, mesh.m) == divmod(rank, 2) and mesh.spatial
    one = Mesh(data=2, rank=1, device=cpu, group="world")
    assert one.data_group == "world" and not one.spatial
    assert (one.d, one.m) == (1, 0)
