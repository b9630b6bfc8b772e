"""The port's serving slice as a whole against the JAX package, on the CPU.

  * ``stereo_forward`` with the default genotype and random weights, against
    JAX's ``stereo_forward(..., cf_matching=True, fused_head=True)``;
  * the committed 4-task checkpoint ``logs/canonical_learn_r4`` restored by
    both packages and served through ``RoutedInference`` (predict with an
    explicit task, routed predict, evaluate);
  * the package's import boundary: no jax, nothing of ``rag_tpu``.

Every input is made with numpy from a seed and handed to both packages;
weights reach the port through ``rag_tpu_torch.convert``.

Tolerance: disparity is a softmin expectation over 192 levels at the end of
a ~25-layer float32 network whose layers the two packages sum in different
orders. That noise averages ~1e-5 px and its largest value grows with the
number of pixels; at the small geometries every pixel agrees to 1e-3 px
and the mean to 1e-4 px. At 1x480x960 (460,800 pixels) the mean bound stays
and the largest single pixel may reach 5e-3 px, still 1/200 of the 1-px
threshold of the tightest metric (Thres1).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rag_tpu.continual.inference import RoutedInference as JaxRoutedInference
from rag_tpu.continual.state import _flatten
from rag_tpu.continual.state import load_checkpoint as jax_load_checkpoint
from rag_tpu.models import stereo as jstereo
from rag_tpu.search.genotype import default_genotype as jax_default_genotype
from rag_tpu_torch.continual.inference import RoutedInference
from rag_tpu_torch.continual.state import load_checkpoint
from rag_tpu_torch.convert import to_torch, unflatten
from rag_tpu_torch.models.stereo import (
    build_head_specs,
    build_site_specs,
    stereo_forward,
)
from rag_tpu_torch.search.genotype import default_genotype

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_learn_r4")
PKG = ROOT / "rag_tpu_torch"
DISP_ATOL = 1e-3       # px, every pixel, small geometries
DISP_MEAN_ATOL = 1e-4  # px, mean over the image
EVAL_DISP_ATOL = 5e-3  # px, every pixel at 1x480x960


def _random_tree(rng, tree):
    """numpy leaves of the JAX init tree's shapes: conv weights at the
    kaiming fan-in variance 2/fan_in, which keeps the matching cost at a
    few units (a softmin neither flat nor one-hot), and BN affine and
    running stats away from identity."""
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
        else:                                   # bias, mean
            out[k] = rng.standard_normal(shape) * 0.1
        out[k] = out[k].astype(np.float32)
    return out


def _images(rng, b, h, w):
    return (rng.standard_normal((b, h, w, 3)).astype(np.float32),
            rng.standard_normal((b, h, w, 3)).astype(np.float32))


def test_stereo_forward_random_weights():
    rng = np.random.default_rng(0)
    g_j = jax_default_genotype()
    specs_j = {**jstereo.build_site_specs(g_j), **jstereo.build_head_specs()}
    p0, s0 = jax.eval_shape(lambda k: jstereo.init_sites(k, specs_j),
                            jax.random.PRNGKey(0))
    params, stats = _random_tree(rng, p0), _random_tree(rng, s0)
    left, right = _images(rng, 1, 96, 192)

    fwd = jax.jit(lambda p, s, l, r: jstereo.stereo_forward(
        specs_j, p, s, l, r, cf_matching=True, fused_head=True,
        maxdisp=48)[0])
    ref = np.asarray(fwd(params, stats, left, right))

    specs = {**build_site_specs(default_genotype()), **build_head_specs()}
    assert ({k: _spec_key(v) for k, v in specs.items()}
            == {k: _spec_key(v) for k, v in specs_j.items()})
    stats_t = to_torch(stats, "cpu")
    out, new_stats = stereo_forward(specs, to_torch(params, "cpu"), stats_t,
                                    torch.from_numpy(left),
                                    torch.from_numpy(right), maxdisp=48)
    assert out.shape == (1, 96, 192)
    flat_new, flat_old = {}, {}    # no train-mode site: every stat carried
    _flatten(_numpy_tree(new_stats), "", flat_new)
    _flatten(_numpy_tree(stats_t), "", flat_old)
    assert sorted(flat_new) == sorted(flat_old)
    for k in flat_old:
        np.testing.assert_array_equal(flat_new[k], flat_old[k])
    assert np.isfinite(ref).all() and ref.std() > 1.0
    np.testing.assert_allclose(out.numpy(), ref, atol=DISP_ATOL, rtol=0)


@pytest.fixture(scope="module")
def nets():
    jnet, jman = jax_load_checkpoint(CKPT, 3)
    tnet, tman = load_checkpoint(CKPT, 3, device="cpu")
    return jnet, jman, tnet, tman


def test_checkpoint_restores_same_tree(nets):
    """Same manifest, registry shape and bit-identical leaves."""
    jnet, jman, tnet, tman = nets
    assert tman == jman
    assert tnet.archis == jnet.archis
    for store_t, store_j in ((tnet.units, jnet.units), (tnet.heads, jnet.heads)):
        assert sorted(store_t) == sorted(store_j)
        for name in store_j:
            assert len(store_t[name]) == len(store_j[name])
            for ut, uj in zip(store_t[name], store_j[name]):
                assert ut.born_task == uj.born_task
                assert _spec_key(ut.spec) == _spec_key(uj.spec)
                for tree_t, tree_j in ((ut.params, uj.params),
                                       (ut.stats, uj.stats)):
                    flat_t, flat_j = {}, {}
                    _flatten(jax.tree_util.tree_map(np.asarray, tree_j), "", flat_j)
                    _flatten(_numpy_tree(tree_t), "", flat_t)
                    assert sorted(flat_t) == sorted(flat_j)
                    for k in flat_j:
                        assert flat_t[k].dtype == flat_j[k].dtype
                        np.testing.assert_array_equal(flat_t[k], flat_j[k])


def _spec_key(spec):
    """A spec's class name and fields: the packages' spec classes differ
    but must describe the same block."""
    return type(spec).__name__, tuple(sorted(vars(spec).items()))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def test_convert_unflatten_round_trip():
    """convert.unflatten inverts rag_tpu's _flatten; to_torch keeps every
    shape, dtype and value and copies (no aliasing of the source)."""
    rng = np.random.default_rng(1)
    tree = {"a": {"w": rng.standard_normal((3, 3, 3, 4, 5)).astype(np.float32),
                  "ops": {"0": {"scale": np.ones(5, np.float32)}}},
            "n": np.arange(4, dtype=np.int32)}
    flat = {}
    _flatten(tree, "units/x/0/params", flat)
    back = unflatten(flat, "units/x/0/params")
    t = to_torch(back, "cpu")
    assert t["a"]["w"].shape == (3, 3, 3, 4, 5)
    assert t["n"].dtype == torch.int32
    np.testing.assert_array_equal(t["a"]["w"].numpy(), tree["a"]["w"])
    np.testing.assert_array_equal(t["a"]["ops"]["0"]["scale"].numpy(), 1.0)
    t["n"][0] = 7
    assert tree["n"][0] == 0


@pytest.mark.parametrize("task", [0, 3])
def test_checkpoint_predict_small(nets, task):
    """The full-width committed model at a small geometry, maxdisp 192."""
    jnet, _, tnet, _ = nets
    left, right = _images(np.random.default_rng(10 + task), 1, 96, 192)
    ref = JaxRoutedInference(jnet).predict(left, right, task=task)
    out = RoutedInference(tnet, device="cpu").predict(left, right, task=task)
    assert out.shape == (1, 96, 192) and out.dtype == np.float32
    assert np.isfinite(ref).all() and 0 <= out.min() and out.max() <= 191
    np.testing.assert_allclose(out, ref, atol=DISP_ATOL, rtol=0)
    assert np.abs(out - ref).mean() <= DISP_MEAN_ATOL


def test_routed_predict_without_router_is_task0(nets):
    _, _, tnet, _ = nets
    ri = RoutedInference(tnet, device="cpu")
    left, right = _images(np.random.default_rng(20), 2, 48, 96)
    np.testing.assert_array_equal(ri.route(left), [0, 0])
    np.testing.assert_array_equal(ri.predict(left, right),
                                  ri.predict(left, right, task=0))


class _Frames:
    """Minimal dataset: ``batches`` as rag_tpu's datasets yield them."""

    def __init__(self, rng, n, h, w):
        self.left, self.right = _images(rng, n, h, w)
        self.disp = rng.uniform(-5.0, 200.0, (n, h, w)).astype(np.float32)

    def batches(self, batch, shuffle, seed=0, drop_last=True):
        for i in range(0, len(self.left), batch):
            sl = slice(i, i + batch)
            yield {"left": self.left[sl], "right": self.right[sl],
                   "disparity": self.disp[sl]}


def test_evaluate_task_path(nets):
    """evaluate(dataset, task): loss, EPE, D1 and Thres* as JAX reports them.
    A pixel whose error sits within DISP_ATOL of a threshold may flip, so
    the rates carry one pixel's weight of slack."""
    jnet, _, tnet, _ = nets
    data = _Frames(np.random.default_rng(30), 2, 48, 96)
    ref = JaxRoutedInference(jnet).evaluate(data, task=3)
    got = RoutedInference(tnet, device="cpu").evaluate(data, task=3)
    assert sorted(got) == sorted(ref)
    one_pixel = 1.0 / (48 * 96 * 0.9)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=DISP_ATOL if k in ("loss", "EPE")
                                   else one_pixel + 1e-7)


@pytest.mark.slow
@pytest.mark.parametrize("task", [0, 1, 2, 3])
def test_checkpoint_predict_eval_geometry(nets, task):
    """Every task path at the reference eval geometry, 1x480x960."""
    jnet, _, tnet, _ = nets
    left, right = _images(np.random.default_rng(40 + task), 1, 480, 960)
    ref = JaxRoutedInference(jnet).predict(left, right, task=task)
    out = RoutedInference(tnet, device="cpu").predict(left, right, task=task)
    assert out.shape == (1, 480, 960)
    np.testing.assert_allclose(out, ref, atol=EVAL_DISP_ATOL, rtol=0)
    assert np.abs(out - ref).mean() <= DISP_MEAN_ATOL


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+rag_tpu\b(?!_torch)"
                        r"|from\s+rag_tpu\b(?!_torch))|\brag_tpu\.(?!\w*_torch)\w",
                        re.MULTILINE)


def test_port_never_imports_jax_or_rag_tpu():
    """No source line of the port imports jax or rag_tpu (rag_tpu_torch
    only), and importing every module of the port loads neither."""
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        code = "\n".join(line for line in path.read_text().splitlines()
                         if not line.lstrip().startswith("#"))
        code = re.sub(r'"""[\s\S]*?"""', "", code)
        for m in _FORBIDDEN.finditer(code):
            bad.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PKG.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    probe = ("import importlib, json, sys\n"
             f"for m in {mods!r}: importlib.import_module(m)\n"
             "print(json.dumps(sorted(k for k in sys.modules "
             "if k.split('.')[0] in ('jax', 'jaxlib', 'rag_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
