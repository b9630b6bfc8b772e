"""Spatial (model-axis) sharding of the port on the CPU.

Worlds of 2, 3 and 4 gloo rank processes (tests/torch_spatial_worker.py)
take the cases of tests/spatial_cases.py over meshes 1x2, 1x3 and 2x2
(data x model): one float64 train step of task 0's path at 48x96 (batch
2, maxdisp 24; the H slabs 8/8 at a model axis of 2, 5/5/6 at 3, and one
row at 1/4 scale), unclipped on the default path and with every kernel
variant on, and with the clip of 5; and the eval step. Every rank must
end with the single-process step's dp/lr, BN statistics, momentum and
scalars within 1e-9 of each leaf's largest value. The steps are also held
against rag_tpu's single-device ``make_train_step`` and ``make_eval_step``
(float64: x64 on, rag_tpu's float32 policy pointed at float64; the
clipped case against the port's single-process step only), and
(``-m slow``, its compiles take ~35 s) the 1x2 steps, clipped and not,
against rag_tpu's GSPMD ``make_sharded_train_step`` and
``make_sharded_eval_step`` at ``make_mesh(data=1, model=2)`` of the
conftest's fake CPU devices, at the same 1e-9.
"""

import contextlib
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spatial_cases as sc
from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from dp_cases import flat
from learn_parity import opt0
from rank_worlds import launch_worlds
from rag_tpu.models import stereo as jstereo
from rag_tpu.parallel import sharded as jsharded
from rag_tpu.parallel.mesh import make_mesh as jmake_mesh
from rag_tpu.parallel.mesh import replicate as jreplicate
from rag_tpu.parallel.mesh import shard_batch as jshard_batch
from rag_tpu.search.genotype import default_genotype as jdefault_genotype
from rag_tpu.train import trainer as jtrainer

WORKER = Path(__file__).resolve().parent / "torch_spatial_worker.py"
TOL = 1e-9  # of each leaf's largest |value|, float64
WORLDS = tuple(sc.MESHES)
EVAL_CASES = ("eval", "eval_variants")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return launch_worlds(WORKER, {n: tmp_path_factory.mktemp(f"sp{n}")
                                  for n in WORLDS})


@pytest.fixture(scope="module")
def single():
    return sc.run_cases(None)


def _close(got, want, what):
    tol = TOL * float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, f"{what}: max |diff| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("case", list(sc.CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spatial_step_equals_single_process(worlds, single, world, case):
    ref = single[case]
    if "stats_with_grad" in ref:
        assert int(ref["stats_with_grad"]) == 0
    for rank, out in enumerate(worlds[world]):
        for k, v in ref.items():
            if k.endswith("_bytes"):
                continue
            _close(out[f"{case}/{k}"], v, f"{sc.MESHES[world]} rank {rank} "
                                          f"{case} {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_steps_exchange_halos(worlds, single, world):
    """Each rank's train step exchanges halo rows and gathers; the
    single-process step none; the model ranks of a data index send the
    same buffers."""
    assert int(single["train"]["halo_bytes"]) == 0
    outs = worlds[world]
    for case in ("train", "eval"):
        halo = [int(o[f"{case}/halo_bytes"]) for o in outs]
        gather = [int(o[f"{case}/gather_bytes"]) for o in outs]
        assert min(halo) > 0 and min(gather) > 0, case
        assert len(set(halo)) == len(set(gather)) == 1, case


def test_1x2_bf16_step_reaches_kernel_i(worlds):
    """The 1x2 world's step under precision=Precision(torch.bfloat16) with
    every variant on (spatial_cases.bf16_step): each rank's
    SlabVolume.resize reaches kernel I's bf16 instance (its plain version
    on the CPU) forward and adjoint, and the loss is finite and the same
    on both ranks."""
    outs = worlds[2]
    for out in outs:
        assert int(out["bf16/slab_resize"]) > 0
        assert int(out["bf16/plain_bf16"]) >= 2 * int(out["bf16/slab_resize"])
        assert np.isfinite(float(out["bf16/loss"]))
    assert float(outs[0]["bf16/loss"]) == float(outs[1]["bf16/loss"])


@contextlib.contextmanager
def _jax_f64():
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


def _rag_tpu(mesh_shape=None, clips=(("train", sc.CLIP),)):
    """rag_tpu's train steps (one per (case, clip) of ``clips``) and eval
    step from the state of spatial_cases.stereo_setup on
    spatial_cases.stereo_batch, in float64: single-device, or GSPMD over a
    fake-CPU (data, model) mesh. {case: {"dp/...", "stats/...",
    "scalars/..."}}."""
    _, params, stats, sites = sc.stereo_setup()
    batch = [t.numpy() for t in sc.stereo_batch()]
    before = flat(params)
    out = {}
    with _jax_f64():
        g = jdefault_genotype()
        specs = {**jstereo.build_site_specs(g), **jstereo.build_head_specs()}
        p0, s0 = _np(params), _np(stats)
        mesh = None
        if mesh_shape is not None:
            mesh = jmake_mesh(*mesh_shape,
                              devices=jax.devices()[:int(np.prod(mesh_shape))])
        for case, clip in clips:
            opt = jtrainer.make_optimizer(sc.WD, clip)
            if mesh is None:
                step = jtrainer.make_train_step(specs, frozenset(sites), opt,
                                                maxdisp=sc.MAXDISP)
                args = (p0, s0, opt.init(p0), sc.LR, *batch)
            else:
                step = jsharded.make_sharded_train_step(
                    mesh, specs, frozenset(sites), opt, maxdisp=sc.MAXDISP)
                b = jshard_batch(dict(zip("lrd", batch)), mesh)
                args = (jreplicate(p0, mesh), jreplicate(s0, mesh),
                        jreplicate(opt.init(p0), mesh), sc.LR,
                        b["l"], b["r"], b["d"])
            p, s, _, scal = opt0(step)(*args)
            p, s, scal = (jax.tree_util.tree_map(np.asarray, t)
                          for t in (p, s, scal))
            res = {f"dp/{k}": (v - before[k]) / sc.LR
                   for k, v in flat(p).items()}
            res.update(flat(s, "stats/"))
            res.update({f"scalars/{k}": v for k, v in scal.items()})
            out[case] = res
        if mesh is None:
            ev = jtrainer.make_eval_step(specs, maxdisp=sc.MAXDISP)
            scal = opt0(ev)(p0, s0, *batch)
        else:
            ev = jsharded.make_sharded_eval_step(mesh, specs,
                                                 maxdisp=sc.MAXDISP)
            b = jshard_batch(dict(zip("lrd", batch)), mesh)
            scal = opt0(ev)(jreplicate(p0, mesh), jreplicate(s0, mesh),
                            b["l"], b["r"], b["d"])
        out["eval"] = {f"scalars/{k}": np.asarray(v) for k, v in scal.items()}
    return out


@pytest.fixture(scope="module")
def rag_tpu_single():
    return _rag_tpu()


@pytest.fixture(scope="module")
def rag_tpu_gspmd():
    return _rag_tpu((1, 2), (("train", sc.CLIP), ("train_clip5", 5.0)))


def _against(outs, ref, case, ref_case, what):
    for rank, out in enumerate(outs):
        for k, v in ref[ref_case].items():
            _close(out[f"{case}/{k}"], v, f"{what} rank {rank} {case} {k}")


@pytest.mark.parametrize("case", ("train", "train_variants") + EVAL_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_spatial_step_against_rag_tpu(worlds, rag_tpu_single, world, case):
    """dp/lr, BN statistics, loss and metrics of every rank against
    rag_tpu's single-device step (the variants' cases against its default
    path, which computes the same function)."""
    ref_case = {"train_variants": "train",
                "eval_variants": "eval"}.get(case, case)
    _against(worlds[world], rag_tpu_single, case, ref_case,
             f"{sc.MESHES[world]} vs rag_tpu")


@pytest.mark.slow
@pytest.mark.parametrize("case", ("train", "train_clip5", "eval"))
def test_1x2_step_against_rag_tpu_gspmd(worlds, rag_tpu_gspmd, case):
    """The port's 1x2 step against rag_tpu's GSPMD step over a 1x2 mesh
    (its cost volume constrained to P(data, None, model))."""
    _against(worlds[2], rag_tpu_gspmd, case, case, "vs rag_tpu GSPMD")
