"""Data parallelism of the port (rag_tpu_torch.parallel) on the CPU.

Two rank processes (tests/torch_dp_worker.py) join a gloo process group
and take one step of each case of tests/dp_cases.py over the world-2 mesh
(float64, batch 4 of 24x48: the supervised, self-supervised, depth and
supernet train steps, the stereo and depth eval steps; the clipped
train step and the stereo eval step through ``parallel.sharded``). Each
rank must
end with the single-process step's params, dp/lr, BN statistics,
momentum and scalars, within 1e-9 of each leaf's largest value. The
world-2 supervised step is also held against rag_tpu's
``make_sharded_train_step`` over a data-2 mesh of the conftest's fake CPU
devices, run in float64 (x64 on, rag_tpu's float32 policy pointed at
float64), at the same 1e-9.

The all-reduces one step issues are counted: both ranks issue the same
number, and a world of one issues as many as a world of two (nothing is
skipped at world 1); chip_smoke.py's dp phase requires DP_ALL_REDUCES,
the count of the committed checkpoint's task-0 step, pinned here.

The rank processes run with one torch thread each and a hard timeout
(tests/rank_worlds.py): past it they are killed and the test fails.
"""

import ast
import contextlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import dp_cases
from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import opt0
from rank_worlds import launch
from rag_tpu.models import stereo as jstereo
from rag_tpu.parallel.mesh import make_mesh as jmake_mesh
from rag_tpu.parallel.mesh import replicate as jreplicate
from rag_tpu.parallel.mesh import shard_batch as jshard_batch
from rag_tpu.parallel.sharded import make_sharded_train_step
from rag_tpu.search.genotype import default_genotype as jdefault_genotype
from rag_tpu.train import trainer as jtrainer
from rag_tpu_torch.data.synthetic import SyntheticStereoDataset
from rag_tpu_torch.parallel.mesh import make_mesh
from rag_tpu_torch.parallel.multihost import (
    host_local_indices,
    local_address,
)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
CKPT = str(ROOT / "logs" / "canonical_learn_r4")
TOL = 1e-9  # of each leaf's largest |value|, float64


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return launch(WORKER, 2, tmp_path_factory.mktemp("dp2"))


@pytest.fixture(scope="module")
def single():
    return dp_cases.run_cases(None)


def _close(got, want, what):
    tol = TOL * float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, f"{what}: max |diff| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("case", list(dp_cases.CASES))
def test_world2_step_equals_single_process(world2, single, case):
    ref, _ = single[case]
    for rank, out in enumerate(world2):
        for k, v in ref.items():
            _close(out[f"{case}/{k}"], v, f"rank {rank} {case} {k}")


def _counts(out):
    return json.loads(str(out["counts"]))


def _chip_constant(name):
    """A module-level integer of chip_smoke.py, read without importing it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(name)


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=local_address(),
                            world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_all_reduce_counts(world2, single):
    c0, c1 = (_counts(o) for o in world2)
    assert c0 == c1
    # without a mesh nothing is reduced
    assert all(n == 0 for _, n in single.values())
    # a train step: the BN statistics forward and backward, the loss's
    # parts forward and backward, the metrics, the flattened gradients
    assert c0["train"] > 4 and c0["eval"] >= 2
    with world_of_one() as mesh:
        assert dp_cases.task0_all_reduces(mesh, CKPT) == c0["task0"]
        one = dp_cases.run_cases(mesh)
    assert {k: n for k, (_, n) in one.items()} == {
        k: v for k, v in c0.items() if k != "task0"}
    assert c0["task0"] == _chip_constant("DP_ALL_REDUCES")


def test_world_of_one_equals_single_process(single):
    with world_of_one() as mesh:
        res, _ = dp_cases.run_cases(mesh)["train"]
    for k, v in single["train"][0].items():
        _close(res[k], v, f"world 1 train {k}")


def test_multihost_batcher_reads_own_shards(world2):
    ds = SyntheticStereoDataset(10, 12, 24, seed=5, device="cpu")
    local = [list(ds.batches(2, True, seed=3,
                             indices=host_local_indices(10, r, 2)))
             for r in range(2)]
    assert len(local[0]) == 2
    for i in range(len(local[0])):
        want = np.concatenate([local[r][i]["left"].numpy()
                               for r in range(2)])
        for out in world2:
            np.testing.assert_array_equal(out[f"multihost/{i}"], want)


@contextlib.contextmanager
def _jax_f64():
    """rag_tpu in float64: x64 on and its float32 policy pointed at
    float64 until the block ends."""
    saved = jnp.float32, os.environ.get("RAG_TPU_COMPUTE_DTYPE")
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    os.environ["RAG_TPU_COMPUTE_DTYPE"] = "float64"
    try:
        yield
    finally:
        jnp.float32 = saved[0]
        if saved[1] is None:
            os.environ.pop("RAG_TPU_COMPUTE_DTYPE")
        else:
            os.environ["RAG_TPU_COMPUTE_DTYPE"] = saved[1]
        jax.config.update("jax_enable_x64", False)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _rag_tpu_sharded_step(clip, wd=dp_cases.WD):
    """dp/lr, new statistics and loss of rag_tpu's make_sharded_train_step
    over a data-2 mesh of fake CPU devices, in float64, from the state of
    dp_cases.stereo_setup on dp_cases.stereo_batch (compiled at XLA's
    lowest optimization level: learn_parity.opt0)."""
    _, params, stats, sites = dp_cases.stereo_setup()
    left, right, gt = (t.numpy() for t in dp_cases.stereo_batch())
    with _jax_f64():
        g = jdefault_genotype()
        specs = {**jstereo.build_site_specs(g), **jstereo.build_head_specs()}
        mesh = jmake_mesh(data=2, model=1, devices=jax.devices()[:2])
        opt = jtrainer.make_optimizer(wd, clip)
        step = opt0(make_sharded_train_step(mesh, specs, frozenset(sites),
                                            opt, maxdisp=dp_cases.MAXDISP))
        p0, s0 = _np(params), _np(stats)
        with mesh:
            sb = jshard_batch({"l": left, "r": right, "d": gt}, mesh)
            p, s, _, sc = step(jreplicate(p0, mesh), jreplicate(s0, mesh),
                               jreplicate(opt.init(p0), mesh), dp_cases.LR,
                               sb["l"], sb["r"], sb["d"])
        p, s = (jax.tree_util.tree_map(np.asarray, t) for t in (p, s))
        loss = float(sc["loss"])
    before = dp_cases.flat(params)
    dp = {k: (v - before[k]) / dp_cases.LR for k, v in dp_cases.flat(p).items()}
    return dp, dp_cases.flat(s), loss, before


def test_world2_step_against_rag_tpu_sharded(world2):
    """float64 (rag_tpu's shard_map step runs under x64 here), with the
    canonical optimizer (global-norm clip 5, which engages at this
    state): the port's world-2 step equals rag_tpu's sharded step to 1e-9
    of each leaf's largest value."""
    dp, stats, loss, _ = _rag_tpu_sharded_step(5.0)
    for out in world2:
        for k, v in dp.items():
            _close(out[f"train_clip5/dp/{k}"], v, f"vs rag_tpu dp {k}")
        for k, v in stats.items():
            _close(out[f"train_clip5/stats/{k}"], v, f"vs rag_tpu stats {k}")
        assert abs(float(out["train_clip5/scalars/loss"]) - loss) \
            <= TOL * abs(loss)


def test_rag_tpu_sharded_gradient_is_world_times_single(monkeypatch):
    """A reference behaviour, pinned: with no weight decay and no clip,
    rag_tpu's world-2 sharded step moves every leaf by 2x the
    single-device gradient (its loss sums its parts with psum, whose
    transpose already sums the cotangents over the shards, and
    _psum_grads sums the gradients again). The canonical clip of 5
    rescales both to one update, so its own tests (rtol 2e-3) and the
    case above agree. The port's single-process step, which its world-2
    step equals (the cases above), gives the single-device gradient."""
    dp, _, loss, _ = _rag_tpu_sharded_step(dp_cases.CLIP, wd=0.0)
    monkeypatch.setattr(dp_cases, "WD", 0.0)
    single = dp_cases.case_train(None)
    for k, v in dp.items():
        _close(v, 2.0 * single[f"dp/{k}"],
               f"rag_tpu's sharded update vs 2x the single-process one, {k}")
    assert abs(float(single["scalars/loss"]) - loss) <= TOL * abs(loss)
