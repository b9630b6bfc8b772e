"""The port's training step as a whole against the JAX package, on the CPU.

One or two ``make_train_step`` steps of each package from an equal state,
on the same numpy inputs (weights reach the port through
``rag_tpu_torch.convert``):

  (a) the default genotype with random weights, every site BN-train and
      trainable, B=2, 48x96, maxdisp 48;
  (b) the committed checkpoint ``logs/canonical_learn_r4``, task 3's
      fine-tune stage (BN-train = trainable = ``trainable_sites(3)``), at
      B=2, 48x96, maxdisp 192, two steps with the cosine learning rate;
  (c) an op-search-style step: every BatchNorm frozen, a few sites
      trainable, ``stem_3d0`` among them (the folded-BN backwards of
      kernels A and B);
  (d) ``write_back`` commits a path's trained tensors to its units;
  (e) (a) at maxdisp 47 (47 mod 3 = 2, D = 15): the head's upsample of
      15 levels to 47, the shape kernels C and G take their general
      instance at on the card.

JAX runs ``make_train_step(specs, bn, make_optimizer(0.003),
forward=partial(stereo_forward, cf_matching=True))``; on the CPU its Pallas
kernels fall back to their XLA references, the port's wrappers to their
plain versions, and the port's backward runs through its
``torch.autograd.Function``s. Compared: the update ``dp/lr`` and the
momentum of every trainable leaf (frozen leaves must not move), the new
BatchNorm statistics, the loss and the metrics.

Precision. Where BatchNorm trains, float32 cannot hold the two packages
together: the reference takes the batch variance as ``E[x^2] - mean^2``
in float32, and XLA's CPU reductions lose 9.1e-5 of it where a channel's
mean is 20x its spread (against a float64 evaluation of the same formula;
the port's reductions lose 8.1e-6), and through task 3's 13 BN-train
sites that moves the reference's float32 disparity by 0.90 px (the
port's by 8.3e-4 px; tests/test_torch_port_train_precision.py measures
all three). So every configuration is compared in float64 -- the port's
plain versions in float64, and JAX with x64 on and its float32 policy
(``jnp.float32`` and ``RAG_TPU_COMPUTE_DTYPE``) pointed at float64 for
the call: dp/lr and momentum to 1e-9 of the leaf's largest value,
statistics to 1e-12 of max(1, |stat|), the loss to 1e-12 relative. The
frozen-BN step (c) is also compared in float32: statistics to 1e-5, loss
and EPE to 1e-5 relative, and dp/lr and momentum over all trainable
leaves together to 1e-3 in relative L2 norm. Not leaf by leaf: a ReLU
input that lies within float32 noise of zero takes the other branch in
one package and moves that leaf's gradient far more than summation order
does (ROADMAP Queue 3). D1 and Thres rates get one pixel's weight of
slack in both precisions.
"""

import contextlib
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.continual.state import load_checkpoint as jax_load_checkpoint
from rag_tpu.models import stereo as jstereo
from rag_tpu.search.genotype import default_genotype as jax_default_genotype
from rag_tpu.train import trainer as jtrainer
from rag_tpu_torch.continual.state import load_checkpoint
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.models.stereo import build_head_specs, build_site_specs
from rag_tpu_torch.ops.variants import DEFAULT
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.train.trainer import cosine_lr, make_optimizer, make_train_step

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_learn_r4")
LR, WD = 0.001, 0.003
# (dp/lr and momentum, BN statistics, loss) relative tolerances per dtype
TOLS = {np.float32: (1e-3, 1e-5, 1e-5), np.float64: (1e-9, 1e-12, 1e-12)}


@contextlib.contextmanager
def _jax_in(dtype):
    """Run rag_tpu in ``dtype``: for float64, x64 on and the package's
    float32 policy pointed at float64 until the block ends."""
    if dtype is np.float32:
        yield
        return
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


def _random_tree(rng, tree):
    """numpy leaves of the JAX tree's shapes: conv weights at the kaiming
    fan-in variance, BN affine and running stats away from identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_tree(rng, v)
            continue
        shape = tuple(v.shape)
        if k == "w":
            fan_in = int(np.prod(shape)) // shape[-1]
            out[k] = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.6, 1.4, shape)
        else:
            out[k] = rng.standard_normal(shape) * 0.1
        out[k] = out[k].astype(np.float32)
    return out


def _flat(tree, prefix=""):
    """{'site/.../leaf': np.ndarray} of a nested dict of arrays/tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _batch(rng, b, h, w, maxdisp):
    left = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    right = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    gt = rng.uniform(-5.0, maxdisp + 10.0, (b, h, w)).astype(np.float32)
    return left, right, gt


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else np.asarray(v, dtype) for k, v in tree.items()}


class _Pair:
    """One training state held by both packages, stepped together."""

    def __init__(self, specs_j, specs_t, params, stats, bn, trainable,
                 maxdisp, dtype, variants=DEFAULT):
        self.trainable = frozenset(trainable)
        self.dtype = dtype
        params, stats = _cast(params, dtype), _cast(stats, dtype)
        self.opt_j = jtrainer.make_optimizer(WD)
        self.step_j = jtrainer.make_train_step(
            specs_j, frozenset(bn), self.opt_j, trainable_sites=self.trainable,
            forward=functools.partial(jstereo.stereo_forward, cf_matching=True),
            maxdisp=maxdisp)
        self.state_j = [params, stats, None]
        opt_t = make_optimizer(WD)
        self.step_t = make_train_step(specs_t, frozenset(bn), opt_t,
                                      trainable_sites=self.trainable,
                                      maxdisp=maxdisp, variants=variants)
        p_t = to_torch(params, "cpu")
        self.state_t = [p_t, to_torch(stats, "cpu"), opt_t.init(p_t)]

    def step_and_compare(self, lr, left, right, gt, loss_tol=None):
        """One step of both packages, compared at TOLS[dtype]; loss_tol,
        if given, replaces the relative bound on the loss and EPE."""
        dt = self.dtype
        left, right, gt = (a.astype(dt) for a in (left, right, gt))
        old = _flat(self.state_j[0])
        with _jax_in(dt):
            if self.state_j[2] is None:
                self.state_j[2] = self.opt_j.init(self.state_j[0])
            p_j, s_j, o_j, sc_j = self.step_j(*self.state_j, lr, left, right, gt)
            p_j, s_j, o_j, sc_j = jax.tree_util.tree_map(
                np.asarray, (p_j, s_j, o_j, sc_j))
        self.state_j = [p_j, s_j, o_j]
        p_t, s_t, o_t, sc_t = self.step_t(
            *self.state_t, lr, torch.from_numpy(left), torch.from_numpy(right),
            torch.from_numpy(gt))
        self.state_t = [p_t, s_t, o_t]
        upd_tol, stats_tol, default_loss_tol = TOLS[dt]
        loss_tol = default_loss_tol if loss_tol is None else loss_tol

        new_j, new_t = _flat(p_j), _flat(p_t)
        trace_j, trace_t = _flat(o_j[2].trace), _flat(o_t)
        assert sorted(new_t) == sorted(new_j)
        sq = np.zeros(4)    # squared norms: du diff, du, trace diff, trace
        for k in new_j:
            assert new_t[k].dtype == new_j[k].dtype == dt, k
            if k.split("/")[0] not in self.trainable:
                np.testing.assert_array_equal(new_t[k], old[k], err_msg=k)
                np.testing.assert_array_equal(new_j[k], old[k], err_msg=k)
                continue
            du_j = (new_j[k].astype(np.float64) - old[k]) / lr
            du_t = (new_t[k].astype(np.float64) - old[k]) / lr
            scale = float(np.abs(du_j).max())
            assert scale > 0, k
            if dt is np.float64:
                np.testing.assert_allclose(du_t, du_j, rtol=0, err_msg=k,
                                           atol=upd_tol * scale)
                np.testing.assert_allclose(
                    trace_t[k], trace_j[k], rtol=0, err_msg=k,
                    atol=upd_tol * float(np.abs(trace_j[k]).max()))
            sq += [((du_t - du_j) ** 2).sum(), (du_j ** 2).sum(),
                   ((trace_t[k] - trace_j[k]) ** 2).sum(),
                   (trace_j[k].astype(np.float64) ** 2).sum()]
        assert sq[1] > 0
        assert np.sqrt(sq[0] / sq[1]) <= upd_tol
        assert np.sqrt(sq[2] / sq[3]) <= upd_tol

        st_j, st_t = _flat(s_j), _flat(s_t)
        assert sorted(st_t) == sorted(st_j)
        for k in st_j:
            np.testing.assert_allclose(
                st_t[k], st_j[k], rtol=0, err_msg=k,
                atol=stats_tol * max(1.0, float(np.abs(st_j[k]).max())))

        assert sorted(sc_t) == sorted(sc_j)
        one_pixel = 1.0 / (gt.size * 0.5)
        for k in sc_j:
            ref = float(sc_j[k])
            atol = (loss_tol * abs(ref) if k in ("loss", "EPE")
                    else one_pixel + 1e-7)
            np.testing.assert_allclose(float(sc_t[k]), ref, rtol=0, atol=atol,
                                       err_msg=k)
        return sc_t


def _default_specs():
    specs_j = {**jstereo.build_site_specs(jax_default_genotype()),
               **jstereo.build_head_specs()}
    specs_t = {**build_site_specs(default_genotype()), **build_head_specs()}
    return specs_j, specs_t


def _random_state(seed):
    specs_j, specs_t = _default_specs()
    p0, s0 = jax.eval_shape(lambda k: jstereo.init_sites(k, specs_j),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return specs_j, specs_t, _random_tree(rng, p0), _random_tree(rng, s0), rng


def test_train_step_random_weights_all_sites():
    """(a) Every site BN-train and trainable: train-mode BatchNorm with
    per-half feature statistics, cvstem_conv (kernels B, E, F), kernel A
    and D at every 3x3x3 conv, the fused head's backward (kernel G)."""
    specs_j, specs_t, params, stats, rng = _random_state(0)
    pair = _Pair(specs_j, specs_t, params, stats, specs_j, specs_j, 48,
                 np.float64)
    sc = pair.step_and_compare(LR, *_batch(rng, 2, 48, 96, 48))
    assert np.isfinite(float(sc["loss"]))


def test_train_step_maxdisp_not_multiple_of_3():
    """(e) maxdisp 47, every site BN-train and trainable: D = 15 levels
    upsampled to 47, no period for the head's periodic instance."""
    specs_j, specs_t, params, stats, rng = _random_state(2)
    pair = _Pair(specs_j, specs_t, params, stats, specs_j, specs_j, 47,
                 np.float64)
    sc = pair.step_and_compare(LR, *_batch(rng, 2, 48, 96, 47))
    assert np.isfinite(float(sc["loss"]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_train_step_op_search_frozen_bn(dtype):
    """(c) Every BatchNorm frozen, a few sites trainable: the folded-BN
    backwards (cvstem_brc with the z recompute, kernel A with the scale
    folded into dx and dW)."""
    specs_j, specs_t, params, stats, rng = _random_state(1)
    trainable = {"stem_3d0", "stem_3d1", "cell_3d4", "cell_2d1", "last_3_3d"}
    pair = _Pair(specs_j, specs_t, params, stats, (), trainable, 48, dtype)
    pair.step_and_compare(LR, *_batch(rng, 2, 48, 96, 48))


@pytest.fixture(scope="module")
def nets():
    return jax_load_checkpoint(CKPT, 3)[0], load_checkpoint(CKPT, 3,
                                                            device="cpu")[0]


def test_checkpoint_task3_finetune_two_steps(nets):
    """(b) The committed checkpoint, task 3's fine-tune stage: frozen
    reused units (stem_3d0 among them: cvstem_brc's backward to the
    features only) around the units task 3 trains."""
    jnet, tnet = nets
    sites = tnet.trainable_sites(3)
    assert sites == jnet.trainable_sites(3)
    assert len(sites) == 13 and "stem_3d0" not in sites
    specs_j, params_j, stats_j = jnet.path(jnet.archis[3])
    specs_t, _, _ = tnet.path(tnet.archis[3])
    params = jax.tree_util.tree_map(np.asarray, params_j)
    stats = jax.tree_util.tree_map(np.asarray, stats_j)
    pair = _Pair(specs_j, specs_t, params, stats, sites, sites, 192,
                 np.float64)
    rng = np.random.default_rng(3)
    for epoch in range(2):
        lr = cosine_lr(LR, 10, epoch)
        assert lr == jtrainer.cosine_lr(LR, 10, epoch)
        pair.step_and_compare(lr, *_batch(rng, 2, 48, 96, 192))


def test_write_back_round_trip(nets):
    """(d) write_back commits a path's params and stats to its units;
    a unit shared with another task's path is the same unit there."""
    _, tnet = nets
    arch = tnet.archis[3]
    _, params, stats = tnet.path(arch)
    new_p = {k: {"mark": torch.full((1,), float(i))}
             for i, k in enumerate(sorted(params))}
    new_s = {k: {"mark": torch.full((1,), -float(i))}
             for i, k in enumerate(sorted(stats))}
    try:
        tnet.write_back(arch, new_p, None)
        _, p2, s2 = tnet.path(arch)
        assert all(p2[k] is new_p[k] for k in new_p)
        assert all(s2[k] is stats[k] for k in stats)
        tnet.write_back(arch, None, new_s)
        _, p3, s3 = tnet.path(arch)
        assert all(s3[k] is new_s[k] for k in new_s)
        shared = [k for k in arch if arch[k] == tnet.archis[0][k]]
        assert shared
        _, p0, _ = tnet.path(tnet.archis[0])
        assert all(p0[k] is new_p[k] for k in shared)
    finally:
        tnet.write_back(arch, params, stats)
    _, p4, s4 = tnet.path(arch)
    assert all(p4[k] is params[k] and s4[k] is stats[k] for k in params)
