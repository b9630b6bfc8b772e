"""The data-parallel cases shared by tests/test_torch_dp.py and the rank
processes it starts (tests/torch_dp_worker.py): each builds its net from
a torch seed and its batch from a numpy seed, takes one step with or
without a mesh, and returns its results as flat numpy arrays. The module
imports torch and the port only, never jax.

Float64, batch 4 of 24x48, maxdisp 24: every case is deterministic, so a
world-2 step and the single-process step must agree to float64 rounding.
"""

import numpy as np
import torch

from rag_tpu_torch.models.growable import GrowableDepthNet, GrowableStereoNet
from rag_tpu_torch.models.supernet import NUM_EDGES, init_supernet
from rag_tpu_torch.parallel.axis import ALL_REDUCES
from rag_tpu_torch.parallel.sharded import (
    make_sharded_eval_step,
    make_sharded_train_step,
)
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.search.mdenas import make_supernet_train_step
from rag_tpu_torch.train.trainer import (
    make_depth_eval_step,
    make_depth_train_step,
    make_optimizer,
    make_selfsup_train_step,
    make_train_step,
)

B, H, W, MAXDISP = 4, 24, 48, 24
LR, WD = 1e-3, 3e-3
# no clipping: a global-norm clip would rescale a gradient summed the
# wrong number of times back to the right update ("train_clip5" keeps the
# canonical clip of 5, which engages at this state)
CLIP = 1e9


def f64(tree):
    if isinstance(tree, dict):
        return {k: f64(v) for k, v in tree.items()}
    return tree.detach().to(torch.float64).clone()


def flat(tree, prefix=""):
    """{'prefix/site/.../leaf': np.ndarray} of a nested dict of tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().cpu().numpy().copy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def stereo_setup():
    """Task 0's path of a fresh default-genotype net: (specs, params,
    stats, sites), in float64."""
    net = GrowableStereoNet.initial(default_genotype(), 0, "cpu")
    specs, params, stats = net.path(net.archis[0])
    return specs, f64(params), f64(stats), net.trainable_sites(0)


def stereo_batch():
    rng = np.random.default_rng(0)
    left = rng.standard_normal((B, H, W, 3))
    right = rng.standard_normal((B, H, W, 3))
    gt = rng.uniform(1, MAXDISP - 4, (B, H, W))
    gt[:, :, :4] = 0.0
    return [torch.from_numpy(a) for a in (left, right, gt)]


def depth_batch():
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (B, H, W, 3))
    gt = rng.uniform(1, 10, (B, H, W))
    gt[:, :3] = 0.0
    return [torch.from_numpy(a) for a in (image, gt)]


def _train_out(params, stats, opt_state, scalars, before):
    out = flat(params, "params/")
    out.update({f"dp/{k}": (v - before[k]) / LR
                for k, v in flat(params).items()})
    out.update(flat(stats, "stats/"))
    out.update(flat(opt_state, "mom/"))
    out.update(flat(scalars, "scalars/"))
    return out


def _stereo_train(builder, mesh, clip=CLIP):
    specs, params, stats, sites = stereo_setup()
    opt = make_optimizer(WD, clip)
    step = builder(specs, sites, opt, maxdisp=MAXDISP, mesh=mesh)
    before = flat(params)
    p, s, o, sc = step(params, stats, opt.init(params), LR, *stereo_batch())
    return _train_out(p, s, o, sc, before)


def case_train(mesh):
    return _stereo_train(make_train_step, mesh)


def _sharded_train_step(specs, sites, opt, maxdisp, mesh):
    return make_sharded_train_step(mesh, specs, sites, opt, maxdisp=maxdisp)


def case_train_clip5(mesh):
    # through parallel.sharded, as rag_tpu's step it is held against
    return _stereo_train(_sharded_train_step, mesh, clip=5.0)


def case_selfsup(mesh):
    return _stereo_train(make_selfsup_train_step, mesh)


def case_eval(mesh):
    specs, params, stats, _ = stereo_setup()
    step = make_sharded_eval_step(mesh, specs, maxdisp=MAXDISP)
    return flat(step(params, stats, *stereo_batch()), "scalars/")


def _depth_setup():
    net = GrowableDepthNet.initial(default_genotype(), 0, "cpu")
    specs, params, stats = net.path(net.archis[0])
    return specs, f64(params), f64(stats), net.trainable_sites(0)


def case_depth_train(mesh):
    specs, params, stats, sites = _depth_setup()
    opt = make_optimizer(WD, CLIP)
    step = make_depth_train_step(specs, sites, opt, mesh=mesh)
    before = flat(params)
    p, s, o, sc = step(params, stats, opt.init(params), LR, *depth_batch())
    return _train_out(p, s, o, sc, before)


def case_depth_eval(mesh):
    specs, params, stats, _ = _depth_setup()
    step = make_depth_eval_step(specs, mesh=mesh)
    return flat(step(params, stats, *depth_batch()), "scalars/")


def case_supernet(mesh):
    params, stats = init_supernet(torch.Generator().manual_seed(0), "cpu")
    params, stats = f64(params), f64(stats)
    rng = np.random.default_rng(2)
    fea_ops, mat_ops = (rng.integers(0, 2, NUM_EDGES).astype(np.int32)
                        for _ in range(2))
    opt = make_optimizer(WD, CLIP)
    step = make_supernet_train_step(opt, MAXDISP, mesh=mesh)
    before = flat(params)
    p, s, o, sc = step(params, stats, opt.init(params), LR, *stereo_batch(),
                       fea_ops, mat_ops)
    return _train_out(p, s, o, sc, before)


CASES = {"train": case_train, "train_clip5": case_train_clip5,
         "eval": case_eval, "selfsup": case_selfsup,
         "depth_train": case_depth_train, "depth_eval": case_depth_eval,
         "supernet": case_supernet}


def run_cases(mesh):
    """{case: (outputs, all-reduces issued)} of every case."""
    out = {}
    for name, case in CASES.items():
        ALL_REDUCES.count = 0
        res = case(mesh)
        out[name] = (res, ALL_REDUCES.count)
    return out


def task0_all_reduces(mesh, ckpt):
    """All-reduces of one data-parallel train step of the committed
    checkpoint's task-0 stage (every site trains, BatchNorm in train mode),
    float32: the configuration chip_smoke.py's dp phase runs."""
    from rag_tpu_torch.continual.state import load_checkpoint

    net, _ = load_checkpoint(ckpt, 3, device="cpu")
    specs, params, stats = net.path(net.archis[0])
    sites = net.trainable_sites(0)
    opt = make_optimizer(WD, CLIP)
    step = make_train_step(specs, sites, opt, maxdisp=MAXDISP, mesh=mesh)
    batch = [t.float() for t in stereo_batch()]
    ALL_REDUCES.count = 0
    step(params, stats, opt.init(params), LR, *batch)
    return ALL_REDUCES.count
