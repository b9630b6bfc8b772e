"""The spatial (model-axis) cases shared by tests/test_torch_spatial.py,
tests/test_torch_halo.py and the rank processes they start
(tests/torch_spatial_worker.py). Each case builds task 0's path of a
fresh default-genotype net from a torch seed and its batch from a numpy
seed, in float64, takes one step with or without a mesh and returns its
results as flat numpy arrays. The module imports torch and the port only,
never jax.

Batch 2 of 48x96 (feature h = 16: slabs of 8/8/4... rows at a model axis
of 2, 5/5/6 rows at 3, one-row slabs at 1/4 scale), maxdisp 24, no
global-norm clip except in "train_clip5".
"""

import numpy as np
import torch
import torch.distributed as dist

from dp_cases import f64, flat
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.ops.variants import KernelVariants
from rag_tpu_torch.parallel.halo import HALO, gather_h, halo_rows, slice_h
from rag_tpu_torch.parallel.mesh import slab_rows
from rag_tpu_torch.parallel.sharded import (
    make_sharded_eval_step,
    make_sharded_train_step,
)
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.train.trainer import make_optimizer

B, H, W, MAXDISP = 2, 48, 96, 24
LR, WD = 1e-3, 3e-3
CLIP = 1e9          # no clipping (a clip hides a wrong factor)
VARIANTS = KernelVariants(conv3d_dblock=True, resize_kernel=True,
                          shear_stem=True)
# the whole mesh of a world of n ranks
MESHES = {2: (1, 2), 3: (1, 3), 4: (2, 2)}


def stereo_setup():
    net = GrowableStereoNet.initial(default_genotype(), 0, "cpu")
    specs, params, stats = net.path(net.archis[0])
    return specs, f64(params), f64(stats), net.trainable_sites(0)


def stereo_batch():
    rng = np.random.default_rng(7)
    left = rng.standard_normal((B, H, W, 3))
    right = rng.standard_normal((B, H, W, 3))
    gt = rng.uniform(1, MAXDISP - 4, (B, H, W))
    gt[:, :, :4] = 0.0
    gt[1, 30:] = 0.0     # an image with a masked-out band
    return [torch.from_numpy(a) for a in (left, right, gt)]


def _train(mesh, clip=CLIP, variants=KernelVariants()):
    specs, params, stats, sites = stereo_setup()
    opt = make_optimizer(WD, clip)
    step = make_sharded_train_step(mesh, specs, sites, opt, maxdisp=MAXDISP,
                                   variants=variants)
    before = flat(params)
    p, s, o, sc = step(params, stats, opt.init(params), LR, *stereo_batch())
    out = {f"dp/{k}": (v - before[k]) / LR for k, v in flat(p).items()}
    out.update(flat(s, "stats/"))
    out.update(flat(o, "mom/"))
    out.update(flat(sc, "scalars/"))
    # the new running statistics carry no autograd history
    out["stats_with_grad"] = np.asarray(sum(
        v.requires_grad for v in _leaves(s)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _eval(mesh, variants=KernelVariants()):
    specs, params, stats, _ = stereo_setup()
    step = make_sharded_eval_step(mesh, specs, maxdisp=MAXDISP,
                                  variants=variants)
    return flat(step(params, stats, *stereo_batch()), "scalars/")


CASES = {
    "train": lambda mesh: _train(mesh),
    "train_variants": lambda mesh: _train(mesh, variants=VARIANTS),
    "train_clip5": lambda mesh: _train(mesh, clip=5.0),
    "eval": lambda mesh: _eval(mesh),
    "eval_variants": lambda mesh: _eval(mesh, variants=VARIANTS),
}


def run_cases(mesh):
    """{case: outputs} of every case, and the halo traffic of each."""
    out = {}
    for name, case in CASES.items():
        HALO.reset()
        res = case(mesh)
        res["halo_bytes"] = np.asarray(HALO.halo_bytes)
        res["gather_bytes"] = np.asarray(HALO.gather_bytes)
        out[name] = res
    return out


def _world_dot(a, b, group):
    s = (a * b).sum().reshape(1)
    dist.all_reduce(s, group=group)
    return float(s)


def adjoints(mesh, seed=3):
    """Dot-product adjoint checks of the model axis's collectives on
    random float64 slabs: {name: (<A x, u>, <x, A^T u>)} summed over the
    model group, A^T u taken by autograd through each Function's
    backward."""
    rng = np.random.default_rng(seed + mesh.rank)
    h = 7 * mesh.model - 1          # uneven slabs
    h0, h1 = slab_rows(h, mesh.model, mesh.m)
    grp = mesh.model_group
    out = {}

    def check(name, fn, x_shape):
        x = torch.from_numpy(rng.standard_normal(x_shape)).requires_grad_()
        y = fn(x)
        u = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
        (g,) = torch.autograd.grad((y * u).sum(), x)
        out[name] = (_world_dot(y.detach(), u, grp),
                     _world_dot(x.detach(), g, grp))

    slab = (2, 3, h1 - h0, 5)
    for k in (1, 2):
        check(f"halo_rows_pad_k{k}", lambda x: halo_rows(x, k, mesh), slab)
        check(f"halo_rows_nopad_k{k}",
              lambda x: halo_rows(x, k, mesh, pad=False), slab)
    check("gather_h", lambda x: gather_h(x, h, mesh), slab)
    check("slice_h", lambda x: slice_h(x, mesh), (2, 3, h, 5))
    # gather then slice is the identity on every rank's slab
    x = torch.from_numpy(rng.standard_normal(slab))
    out["gather_slice_identity"] = (
        float((slice_h(gather_h(x, h, mesh), mesh) - x).abs().max()), 0.0)
    return out
