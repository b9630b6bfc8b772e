"""The port's main path with every kernel variant on (``KernelVariants``:
the D-blocked conv H, the resize kernel I, the shear stem J/K) against the
JAX package, on the CPU.

rag_tpu's variant gates select other kernels for the same function, so the
port's variant path is held against rag_tpu's default path: serving the
committed checkpoint ``logs/canonical_learn_r4`` at 96x192 with the bounds
of tests/test_torch_port_slice.py (1e-3 px max, 1e-4 px mean), and whole
train steps of task 0's and task 3's
stages in float64 (within 1e-9 of each leaf's largest update, as
tests/test_torch_port_train_slice.py holds the default path). rag_tpu's
shear path is float32 only (its tap-map convs cast), which is why the
float64 comparison goes against its default path; the port's plain versions
keep the input dtype. On the CPU the variant wrappers run their plain
versions; the shear stem's (tap maps + masked shifted sums) differs from
the default path's (materialized cost volume + conv), and every variant
runs behind its own ``torch.autograd.Function``.

The default path is checked to take none of the variant branches, by
counting calls into the variant wrappers. Under ``-m slow``: a whole
forward against rag_tpu with its three gates on, its Pallas kernels in
interpret mode.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.continual.inference import RoutedInference as JaxRoutedInference
from rag_tpu.continual.state import load_checkpoint as jax_load_checkpoint
from rag_tpu_torch.continual.inference import RoutedInference
from rag_tpu_torch.continual.state import load_checkpoint
from rag_tpu_torch.ops import conv3d as conv3d_mod
from rag_tpu_torch.ops import resize as resize_mod
from rag_tpu_torch.ops import shear as shear_mod
from rag_tpu_torch.ops.variants import KernelVariants
from rag_tpu_torch.train.trainer import cosine_lr, make_optimizer, make_train_step
from test_torch_port_train_slice import LR, _batch, _Pair

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_learn_r4")
ALL = KernelVariants(conv3d_dblock=True, resize_kernel=True, shear_stem=True)
DISP_ATOL = 1e-3       # px, every pixel
DISP_MEAN_ATOL = 1e-4  # px, mean over the image


@pytest.fixture(scope="module")
def nets():
    return (jax_load_checkpoint(CKPT, 3)[0],
            load_checkpoint(CKPT, 3, device="cpu")[0])


def _images(rng, b, h, w):
    return (rng.standard_normal((b, h, w, 3)).astype(np.float32),
            rng.standard_normal((b, h, w, 3)).astype(np.float32))


@pytest.mark.parametrize("task", [0, 3])
def test_variants_predict_matches_jax(nets, task):
    """Serving with every variant (J with the folded frozen BN, H, I)
    against rag_tpu's default path, 96x192, maxdisp 192."""
    jnet, tnet = nets
    left, right = _images(np.random.default_rng(10 + task), 1, 96, 192)
    ref = JaxRoutedInference(jnet).predict(left, right, task=task)
    out = RoutedInference(tnet, device="cpu", variants=ALL).predict(
        left, right, task=task)
    assert out.shape == (1, 96, 192) and 0 <= out.min() and out.max() <= 191
    np.testing.assert_allclose(out, ref, atol=DISP_ATOL, rtol=0)
    assert np.abs(out - ref).mean() <= DISP_MEAN_ATOL


@pytest.mark.parametrize("task", [0, 3])
def test_variants_train_step_matches_jax(nets, task):
    """A float64 train step of task t's stage (task 0: every site BN-train
    and trainable, the shear stem's BatchNorm in train mode; task 3:
    ``stem_3d0`` frozen, so K runs for the features' gradient only) against
    rag_tpu's default path."""
    jnet, tnet = nets
    sites = tnet.trainable_sites(task)
    assert sites == jnet.trainable_sites(task)
    assert ("stem_3d0" in sites) == (task == 0)
    specs_j, params_j, stats_j = jnet.path(jnet.archis[task])
    specs_t, _, _ = tnet.path(tnet.archis[task])
    params = jax.tree_util.tree_map(np.asarray, params_j)
    stats = jax.tree_util.tree_map(np.asarray, stats_j)
    pair = _Pair(specs_j, specs_t, params, stats, sites, sites, 192,
                 np.float64, variants=ALL)
    rng = np.random.default_rng(20 + task)
    pair.step_and_compare(cosine_lr(LR, 10, 1), *_batch(rng, 2, 48, 96, 192))


def _count_variant_calls(monkeypatch):
    """Wrap the variant wrappers (H, I, J, K) in counters."""
    counts = {}
    for mod, name in ((conv3d_mod, "conv3d_dblock_cf"),
                      (resize_mod, "resize_taps_cf"),
                      (shear_mod, "shear_forward"),
                      (shear_mod, "shear_adjoint")):
        fn = getattr(mod, name)
        counts[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("variants", [KernelVariants(), ALL])
def test_variant_branches_taken_only_when_chosen(nets, monkeypatch, variants):
    """A train step of task 0's stage and a request: the default path
    makes no call to a variant wrapper; with every variant on, each is
    called (K in the backward)."""
    _, tnet = nets
    counts = _count_variant_calls(monkeypatch)
    specs, params, stats = tnet.path(tnet.archis[0])
    params = _deep_clone(params)        # the step updates them in place
    opt = make_optimizer(0.003)
    step = make_train_step(specs, tnet.trainable_sites(0), opt, maxdisp=48,
                           variants=variants)
    rng = np.random.default_rng(5)
    left, right, gt = (torch.from_numpy(a) for a in _batch(rng, 1, 24, 48, 48))
    step(params, stats, opt.init(params), LR, left, right, gt)
    RoutedInference(tnet, maxdisp=48, device="cpu", variants=variants).predict(
        left.numpy(), right.numpy(), task=0)
    if variants == KernelVariants():
        assert counts == dict.fromkeys(counts, 0)
    else:
        assert all(c > 0 for c in counts.values()), counts


def _deep_clone(tree):
    if isinstance(tree, dict):
        return {k: _deep_clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.mark.slow
def test_variants_forward_matches_jax_gates_on(nets, monkeypatch):
    """Serving task 3's path with every variant against rag_tpu with
    RAG_TPU_CONV3D_V4, RAG_TPU_RESIZE_KERNEL and RAG_TPU_CVSTEM_SHEAR set,
    its Pallas kernels (those three among them) in interpret mode."""
    from rag_tpu.models import stereo as jstereo

    jnet, tnet = nets
    left, right = _images(np.random.default_rng(50), 1, 48, 96)
    specs, params, stats = jnet.path(jnet.archis[3])
    for var in ("RAG_TPU_KERNEL_INTERPRET", "RAG_TPU_CONV3D_V4",
                "RAG_TPU_RESIZE_KERNEL", "RAG_TPU_CVSTEM_SHEAR"):
        monkeypatch.setenv(var, "1")
    ref, _ = jstereo.stereo_forward(specs, params, stats, left, right,
                                    cf_matching=True, fused_head=True)
    out = RoutedInference(tnet, device="cpu", variants=ALL).predict(
        left, right, task=3)
    np.testing.assert_allclose(out, np.asarray(ref), atol=DISP_ATOL, rtol=0)
    assert np.abs(out - np.asarray(ref)).mean() <= DISP_MEAN_ATOL
