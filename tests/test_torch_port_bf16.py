"""The bf16-at-rest precision policy of the port (rag_tpu_torch/ops/
precision.py, ``precision=Precision(torch.bfloat16)``) against rag_tpu's
(rag_tpu/ops/precision.py, ``RAG_TPU_COMPUTE_DTYPE=bfloat16``), on the CPU.
Every case of tests/test_bf16.py has its counterpart here; the port has one
matching layout (channel-first), so the channels-last / channel-first pair
of rag_tpu's cases becomes the port's two kernel paths, the default one
and every variant on.

- The plain versions of the kernels that take bf16 (A, H, B, D, E, F, J,
  K; I's has no bf16 Pallas counterpart, see below) against rag_tpu's
  Pallas kernels in interpret mode on the same bf16 inputs: bf16 outputs within one bf16 ulp of each element beyond the
  float32 sums' own difference, float32 outputs (D's and F's dW, E's dX
  and dY before the cast, K's maps) within F32_RTOL, with rag_tpu's
  dtypes.
- Forward and train step at 24x48: the disparity is float32 and close to
  the float32 one (test_bf16.py's bounds), every parameter gradient,
  parameter, statistic and momentum leaf float32 and finite, the loss
  within 5 % of float32's.
- The gap to rag_tpu: on the committed checkpoint at 24x48, the port's
  bf16 features equal rag_tpu's bit for bit, and the matching net's first
  site is within rag_tpu's own bf16-to-float32 gap of rag_tpu's bf16
  result; the deeper gaps (matching cost, disparity, loss) are printed,
  and measured over eight frames under ``-m slow`` (see the cases).
- The feature dtype policy (TestFeatureDtypePolicy), the head's float32
  upcast, the wrappers' dtype rule, and kernel I's bf16 instance: its
  plain version is the float32 resize of the upcast volume rounded to bf16
  (where rag_tpu's gate sends a bf16 volume to its bf16 matrix products),
  within 2^-6 of the largest float32 output of rag_tpu's ``resize_cf``
  with ``RAG_TPU_RESIZE_KERNEL=1``, forward and adjoint, and
  ``resize_kernel`` runs under a bf16 policy at every entry point.
"""

import dataclasses

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import opt0
from rag_tpu.continual.state import load_checkpoint as jax_load_checkpoint
from rag_tpu.models import stereo as jstereo
from rag_tpu.models.stereo import build_head_specs as jbuild_head_specs
from rag_tpu.models.stereo import build_site_specs as jbuild_site_specs
from rag_tpu.models.stereo import init_sites as jinit_sites
from rag_tpu.ops import pallas_conv3d as jconv
from rag_tpu.ops import pallas_cvstem as jcvstem
from rag_tpu.ops import pallas_resize as jresize
from rag_tpu.ops import pallas_shear as jshear
from rag_tpu.search.genotype import default_genotype as jdefault_genotype
from rag_tpu.train import trainer as jtrainer
from rag_tpu_torch.continual.state import load_checkpoint
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.data.synthetic import SyntheticStereoDataset
from rag_tpu_torch.models import depth as tdepth
from rag_tpu_torch.models.stereo import (
    build_head_specs,
    build_site_specs,
    extract_feature,
    stereo_forward,
)
from rag_tpu_torch.ops import conv3d as tconv
from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops import cvstem as tcvstem
from rag_tpu_torch.ops import disparity as tdisp
from rag_tpu_torch.ops import resize as tresize
from rag_tpu_torch.ops import shear as tshear
from rag_tpu_torch.ops.precision import FP32, Precision, wide
from rag_tpu_torch.ops.variants import KernelVariants
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.train.trainer import (
    differentiable,
    grads_of,
    make_optimizer,
    make_train_step,
)

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_learn_r4")
BF16 = Precision(torch.bfloat16)
# the default path and every variant on
PATHS = {"default": KernelVariants(),
         "variants": KernelVariants(conv3d_dblock=True, resize_kernel=True,
                                    shear_stem=True)}
# float32 sums in another order: the outputs' relative difference, of the
# largest |value| (sums that cancel near zero keep the absolute one)
F32_RTOL = 1e-5


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def path():
    """Task 0's specs, and rag_tpu's PRNGKey(0) init as port tensors."""
    specs_j = {**jbuild_site_specs(jdefault_genotype()),
               **jbuild_head_specs()}
    params, stats = jinit_sites(jax.random.PRNGKey(0), specs_j)
    specs = {**build_site_specs(default_genotype()), **build_head_specs()}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return specs, to_np(params), to_np(stats)


def _state(path):
    specs, params, stats = path
    return specs, to_torch(params, "cpu"), to_torch(stats, "cpu")


def _images(seed, shape=(1, 24, 48, 3)):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def _bf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tb(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits; 0 at 0)."""
    v = np.abs(v.astype(np.float32))
    return np.where(v > 0, 2.0 ** (np.floor(np.log2(np.maximum(v, 1e-38)))
                                   - 7), 0.0)


def assert_bf16_close(got: torch.Tensor, ref):
    """bf16 outputs: each element within one bf16 ulp, beyond F32_RTOL of
    the largest |value| (the float32 sums' difference before rounding)."""
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    t, j = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    tol = _bf16_ulp(np.maximum(np.abs(t), np.abs(j))) \
        + F32_RTOL * np.abs(j).max()
    bad = np.abs(t - j) > tol
    assert not bad.any(), (int(bad.sum()), float(np.abs(t - j).max()))


def assert_f32_close(got: torch.Tensor, ref):
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    j = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), j, rtol=F32_RTOL,
                               atol=F32_RTOL * float(np.abs(j).max()))


# -- the kernels ---------------------------------------------------------------

B, D, CIN, H, W, COUT = 1, 4, 12, 16, 24, 12
C, ND = 12, 8


def _kernel_inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        x=f(B, D, CIN, H, W), w=(0.3 * f(3, 3, 3, CIN, COUT)),
        scale=rng.uniform(0.5, 1.5, COUT).astype(np.float32),
        bias=0.1 * f(COUT), dz=f(B, D, COUT, H, W), xf=f(B, C, H, W),
        yf=f(B, C, H, W), w3=0.2 * f(3, 3, 3, 2 * C, COUT),
        dz2=f(B, ND, COUT, H, W), px=f(B, 9, COUT, H, W),
        py=f(B, 9, COUT, H, W))


@pytest.mark.parametrize("kernel", list("AHBDEFJK"))
def test_bf16_plain_matches_interpret_pallas(monkeypatch, kernel):
    """Kernel ``kernel``'s plain version on bf16 inputs against rag_tpu's
    Pallas kernel in interpret mode on the same inputs."""
    monkeypatch.setenv("RAG_TPU_KERNEL_INTERPRET", "1")
    a = _kernel_inputs()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if kernel in "AH":
        if kernel == "H":
            monkeypatch.setenv("RAG_TPU_CONV3D_V4", "1")
        ref = jconv._conv3d_pallas_cf(_bf(a["x"]), jconv.pack_weights(j["w"]),
                                      j["scale"], j["bias"], True,
                                      interpret=True)
        fn = tconv.conv3d_affine_cf if kernel == "A" \
            else tconv.conv3d_dblock_cf
        assert_bf16_close(fn(_tb(a["x"]), t["w"], t["scale"], t["bias"],
                             True), ref)
    elif kernel == "D":
        ref = jconv.conv3d_dw_pallas(_bf(a["x"]), _bf(a["dz"]),
                                     interpret=True)
        assert_f32_close(tconv.conv3d_dw_cf(_tb(a["x"]), _tb(a["dz"])), ref)
    elif kernel == "B":
        ref = jcvstem.cvstem_forward_cf(
            _bf(a["xf"]), _bf(a["yf"]), jconv.pack_weights(j["w3"]),
            j["scale"], j["bias"], ND, relu=True, interpret=True)
        assert_bf16_close(tcvstem.cvstem_affine(
            _tb(a["xf"]), _tb(a["yf"]), t["w3"], t["scale"], t["bias"], ND,
            True), ref)
    elif kernel == "E":
        rx, ry = jcvstem.cvstem_dxy_pallas(_bf(a["dz2"]), j["w3"], ND,
                                           interpret=True)
        # float32 before the cast: the plain version on the upcast dz
        gx, gy = tcvstem.cvstem_dxy_plain(_tb(a["dz2"]).float(), t["w3"], ND)
        assert_f32_close(gx, rx)
        assert_f32_close(gy, ry)
        # stored in the activations' dtype, as rag_tpu's VJP casts them
        bx, by = tcvstem.cvstem_dxy(_tb(a["dz2"]), t["w3"], ND)
        assert_bf16_close(bx, rx.astype(jnp.bfloat16))
        assert_bf16_close(by, ry.astype(jnp.bfloat16))
    elif kernel == "F":
        ref = jcvstem.cvstem_dw_pallas(_bf(a["xf"]), _bf(a["yf"]),
                                       _bf(a["dz2"]), ND, interpret=True)
        assert_f32_close(tcvstem.cvstem_dw(_tb(a["xf"]), _tb(a["yf"]),
                                           _tb(a["dz2"]), ND), ref)
    elif kernel == "J":
        ref = jshear.shear_forward(_bf(a["px"]), _bf(a["py"]), j["scale"],
                                   j["bias"], ND, W, relu=True,
                                   interpret=True)
        assert_bf16_close(tshear.shear_forward(
            _tb(a["px"]), _tb(a["py"]), t["scale"], t["bias"], ND, True), ref)
    else:
        rx, ry = jshear.shear_adjoint(_bf(a["dz2"]), ND, W, interpret=True)
        gx, gy = tshear.shear_adjoint(_tb(a["dz2"]), ND)
        assert_f32_close(gx, rx)
        assert_f32_close(gy, ry)


def test_bf16_kernel_paths_interpret():
    """The differentiable kernel paths (conv3d_brc_cf: A forward and dx, D;
    cvstem_conv: B, E, F; shear_stem_z: J, K) under bf16 inputs: outputs
    in x's dtype and within 2 % of the float32 composition, dx/dX/dY in
    x's dtype, parameter gradients float32 (test_bf16.py's case)."""
    rng = np.random.default_rng(0)
    x = _tb(rng.standard_normal((1, 4, 12, 16, 24)))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 12, 12))
                         .astype(np.float32) * 0.3)
    s, b = torch.ones(12), torch.zeros(12)
    y = tconv.conv3d_brc_cf(x, w, s, b, True)
    assert y.dtype == torch.bfloat16
    ref = tconv.conv3d_brc_cf_plain(x.float(), w, s, b, True)
    rel = float((y.float() - ref).abs().max() / ref.abs().max())
    assert rel < 0.02, rel
    leaves = [x.clone().requires_grad_(True)] + [
        v.clone().requires_grad_(True) for v in (w, s, b)]
    (tconv.conv3d_brc_cf(*leaves, True).float() ** 2).sum().backward()
    assert leaves[0].grad.dtype == torch.bfloat16     # dx matches x
    assert all(v.grad.dtype == torch.float32 for v in leaves[1:])

    xf = _tb(rng.standard_normal((1, 12, 16, 24)))
    yf = _tb(rng.standard_normal((1, 12, 16, 24)))
    w3 = torch.from_numpy(rng.standard_normal((3, 3, 3, 24, 12))
                          .astype(np.float32) * 0.2)
    for fn in (tcvstem.cvstem_conv, tshear.shear_stem_z):
        z = fn(xf, yf, w3, 8)
        assert z.dtype == torch.bfloat16
        zr = tcvstem.cvstem_brc_plain(xf.float(), yf.float(), w3,
                                      torch.ones(12), torch.zeros(12), 8,
                                      False)
        rel = float((z.float() - zr).abs().max() / zr.abs().max())
        assert rel < 0.02, rel
        leaves = [v.clone().requires_grad_(True) for v in (xf, yf, w3)]
        (fn(*leaves, 8).float() ** 2).sum().backward()
        assert leaves[0].grad.dtype == leaves[1].grad.dtype == torch.bfloat16
        assert leaves[2].grad.dtype == torch.float32


def test_kernel_dtype_rule():
    """What a kernel wrapper takes on the card: activations float32 or
    bf16, one dtype; weights float32; C and G float32 only, I (like A, B,
    D-F, H, J, K) both, through a ``_bf16`` C entry. Every other dtype
    raises (checked before any launch)."""
    x16, x32 = torch.zeros(2, dtype=torch.bfloat16), torch.zeros(2)
    tconv.check_dtypes("k", (x16, x16), (x32,))
    tconv.check_dtypes("k", (x32,), (x32,))
    for acts, floats in (((x16, x32), ()), ((x32.half(),), ()),
                         ((x32.double(),), ()), ((x16,), (x16,)),
                         ((x32,), (x32.double(),))):
        with pytest.raises(ValueError):
            tconv.check_dtypes("k", acts, floats)
    with pytest.raises(ValueError):
        tdisp.check_f32("k", x16)
    assert "rag_resize_taps_cf" in cuda_lib.BF16_ENTRIES
    assert cuda_lib.SIGNATURES["rag_resize_taps_cf_bf16"] == \
        cuda_lib.SIGNATURES["rag_resize_taps_cf"]
    assert not {"rag_soft_argmin", "rag_soft_argmin_bwd"} & set(
        cuda_lib.BF16_ENTRIES)


@pytest.mark.parametrize("kind", list(PATHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_kernel_takes_no_bf16(path, monkeypatch, dtype, kind):
    """resize_cf with kernel I (``resize_kernel``, alone or with every
    other variant): a float32 or bf16 volume reaches kernel I's wrapper
    once and comes out in its dtype, a bf16 one as the float32 plain
    resize of the upcast volume rounded to bf16, bit for bit (kernel I's
    bf16 instance; before it existed this test pinned the raise). With a
    bf16 policy stereo_forward runs its matching resizes through kernel
    I's bf16 instance and make_train_step builds."""
    variants = dataclasses.replace(PATHS[kind], resize_kernel=True)
    calls = []
    real = tresize.resize_taps_cf
    monkeypatch.setattr(tresize, "resize_taps_cf",
                        lambda x, *a, **k: calls.append(x.dtype)
                        or real(x, *a, **k))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 4, 3, 6, 8))
                         .astype(np.float32)).to(dtype)
    out = tresize.resize_cf(x, 8, 12, 16, True, variants)
    assert calls == [dtype] and out.dtype == dtype
    want = tresize.resize_linear(x.float(), (8, 12, 16), (1, 3, 4), True)
    assert torch.equal(out, want.to(dtype))
    if dtype == torch.bfloat16:
        calls.clear()
        specs, params, stats = _state(path)
        left, right = _images(1)
        with torch.no_grad():
            disp, _ = stereo_forward(specs, params, stats, left, right,
                                     variants=variants, precision=BF16)
        assert calls and set(calls) == {torch.bfloat16}
        assert disp.dtype == torch.float32
        assert bool(torch.isfinite(disp).all())
        make_train_step(specs, frozenset(specs), make_optimizer(0.003),
                        variants=variants, precision=BF16)


# the model's resizes at a small size: x shape, target: the cells' 2x down
# and 2x up, and the head's scale of 3 (an upsample by 3 on every axis)
RESIZE_SHAPES = [((1, 8, 4, 12, 24), (4, 6, 12)),
                 ((1, 4, 8, 6, 12), (8, 12, 24)),
                 ((1, 4, 2, 6, 12), (12, 18, 36))]
# kernel I's bf16 instance against rag_tpu's bf16 resize_cf: fixed before
# measuring at 2^-6 of the largest float32 output (rag_tpu rounds to bf16
# after each axis against bf16 matrices, the port once: each is measured
# within 8.2e-3 of it); and 2^-8 to the float32 resize (one rounding)
RESIZE_BF16_RTOL, RESIZE_ROUND_RTOL = 2.0 ** -6, 2.0 ** -8


@pytest.mark.parametrize("shape,target", RESIZE_SHAPES)
def test_resize_bf16_against_rag_tpu(monkeypatch, shape, target):
    """Kernel I's bf16 path (resize_cf with ``resize_kernel``; on CPU
    tensors the bf16 instance's plain version) forward and adjoint, against
    rag_tpu's ``resize_cf`` on the same bf16 volume and cotangent with
    ``RAG_TPU_RESIZE_KERNEL=1`` (its bf16 route, the matrix products):
    within RESIZE_BF16_RTOL of the largest float32 output, within
    RESIZE_ROUND_RTOL of the float32 resize, and equal to the float32 plain
    resize of the upcast input rounded to bf16."""
    monkeypatch.setenv("RAG_TPU_RESIZE_KERNEL", "1")
    rng = np.random.default_rng(sum(shape) + sum(target))
    x = _tb(rng.standard_normal(shape))
    b, d, c, h, w = shape
    g = _tb(rng.standard_normal((b, target[0], c, *target[1:])))
    iv = KernelVariants(resize_kernel=True)
    xt = x.clone().requires_grad_(True)
    out = tresize.resize_cf(xt, *target, True, iv)
    out.backward(g)
    dx = xt.grad
    assert out.dtype == dx.dtype == torch.bfloat16

    def jfwd(v):
        return jresize.resize_cf(v, *target, True)
    jout, vjp = jax.vjp(jfwd, _bf(x.float().numpy()))
    (jdx,) = vjp(_bf(g.float().numpy()))
    assert jout.dtype == jdx.dtype == jnp.bfloat16

    ref = tresize.resize_taps_plain(x.float(), *target)
    dref = tresize.resize_taps_plain(g.float(), d, h, w, True, True)
    for what, got, theirs, f32 in (("forward", out, jout, ref),
                                   ("adjoint", dx, jdx, dref)):
        top = float(f32.abs().max())
        got = got.detach().float()
        assert torch.equal(got, f32.to(torch.bfloat16).float())
        theirs = torch.from_numpy(np.array(theirs.astype(jnp.float32)))
        gaps = [float((a - b).abs().max()) / top
                for a, b in ((got, theirs), (got, f32), (theirs, f32))]
        print(f"[resize bf16] {shape} -> {target} {what}, of max|float32|: "
              "port vs rag_tpu {:.3e}, port vs float32 {:.3e}, rag_tpu vs "
              "float32 {:.3e}".format(*gaps))
        assert gaps[0] <= RESIZE_BF16_RTOL, gaps
        assert gaps[1] <= RESIZE_ROUND_RTOL, gaps


# -- the slice -----------------------------------------------------------------

@pytest.mark.parametrize("kind", list(PATHS))
def test_bf16_forward_close_to_f32(path, kind):
    specs, params, stats = _state(path)
    left, right = _images(1)
    with torch.no_grad():
        d32, _ = stereo_forward(specs, params, stats, left, right,
                                variants=PATHS[kind])
        d16, _ = stereo_forward(specs, params, stats, left, right,
                                variants=PATHS[kind], precision=BF16)
    assert d16.dtype == torch.float32      # the head's output is float32
    # the untrained soft-argmin amplifies matching-score noise: the MEAN
    # disparity, plus a generous per-pixel bound (test_bf16.py's)
    assert abs(float(d32.mean() - d16.mean())) < 1.0
    assert float((d32 - d16).abs().mean()) < 5.0


@pytest.mark.parametrize("kind", list(PATHS))
def test_bf16_param_grads_are_f32(path, kind):
    specs, params, stats = _state(path)
    left, right = _images(1)
    handles, p = differentiable(params, frozenset(specs))
    with torch.enable_grad():
        d, _ = stereo_forward(specs, p, stats, left, right,
                              train_sites=frozenset(specs),
                              variants=PATHS[kind], precision=BF16)
        grads = grads_of((d ** 2).mean(), handles)
    assert grads and all(g.dtype == torch.float32 for g in grads.values())
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def _train_step(path, precision, variants=KernelVariants()):
    specs, params, stats = _state(path)
    rng = np.random.default_rng(3)
    left, right = _images(1, (2, 24, 48, 3))
    gt = torch.from_numpy(rng.uniform(1.0, 100.0, (2, 24, 48))
                          .astype(np.float32))
    opt = make_optimizer(0.003, 5.0)
    step = make_train_step(specs, frozenset(specs), opt, variants=variants,
                           precision=precision)
    return step(params, stats, opt.init(params), 1e-3, left, right, gt)


@pytest.mark.parametrize("kind", list(PATHS))
def test_bf16_train_step_state_stays_f32(path, kind):
    p, s, o, sc = _train_step(path, BF16, PATHS[kind])
    assert np.isfinite(float(sc["loss"]))
    for tree in (p, s, o):
        for k, leaf in _flat(tree):
            assert leaf.dtype == torch.float32, k
            assert bool(torch.isfinite(leaf).all()), k


def test_bf16_train_loss_close_to_f32(path):
    l32 = float(_train_step(path, FP32)[3]["loss"])
    l16 = float(_train_step(path, BF16)[3]["loss"])
    assert abs(l16 - l32) / max(abs(l32), 1e-6) < 0.05, (l16, l32)


@pytest.fixture(scope="module")
def nets():
    return (jax_load_checkpoint(CKPT, 3)[0],
            load_checkpoint(CKPT, 3, device="cpu")[0])


def _frame_gaps(jnet, tnet, monkeypatch, task, seed, interpret=False):
    """One synthetic 24x48 frame pair (maxdisp 48) through task ``task``'s
    path: mean |port bf16 - rag_tpu bf16| and mean |rag_tpu bf16 - rag_tpu
    float32| of the features, of the matching net's first site (stem_3d1,
    after kernel B and one kernel A conv), of the head's input (the
    matching cost), of the disparity, and of the loss of a train step of
    the task's stage. ``interpret``: rag_tpu runs its Pallas kernels in
    interpret mode, whose weights stay float32 as the port's do (its CPU
    path casts them to bf16)."""
    import rag_tpu.ops.convbr_cf as jconvbr_cf
    import rag_tpu_torch.models.stereo as tstereo
    import rag_tpu_torch.ops.volume as tvolume

    seen = {}

    def hook(mod, name, key, to_np, pos=0):
        fn = getattr(mod, name)

        def run(*a, **k):
            out = fn(*a, **k)
            seen.setdefault(key, to_np(out[0] if pos is None else a[pos]))
            return out
        monkeypatch.setattr(mod, name, run)

    jnp_f32 = lambda v: np.asarray(jnp.asarray(v).astype(jnp.float32))
    t_f32 = lambda v: v.detach().float().numpy().copy()
    hook(jconvbr_cf, "apply_convbr_cf", "stem", jnp_f32, None)
    hook(jstereo, "soft_argmin_disparity_fused", "cost", jnp_f32)
    hook(tstereo, "apply_convbr_cf", "stem", t_f32, None)
    hook(tvolume, "fused_soft_argmin", "cost", t_f32)

    specs_j, params_j, stats_j = jnet.path(jnet.archis[task])
    specs_t, params_t, stats_t = tnet.path(tnet.archis[task])
    sites = tnet.trainable_sites(task)
    s = SyntheticStereoDataset(2, 24, 48, seed=seed, device="cpu")._samples()
    left, right, gt = s["left"], s["right"], s["disparity"]
    both = np.concatenate([left, right])
    out = {}
    for mode in ("float32", "bfloat16"):
        monkeypatch.setenv("RAG_TPU_COMPUTE_DTYPE", mode)
        if interpret:
            monkeypatch.setenv("RAG_TPU_KERNEL_INTERPRET", "1")
        seen.clear()
        feat = jnp_f32(jstereo.extract_feature(
            specs_j, params_j, stats_j, jnp.asarray(both), frozenset(), {}))
        disp = np.asarray(jstereo.stereo_forward(
            specs_j, params_j, stats_j, left, right, cf_matching=True,
            fused_head=True, maxdisp=48)[0])
        monkeypatch.delenv("RAG_TPU_KERNEL_INTERPRET", raising=False)
        opt = jtrainer.make_optimizer(0.003, 5.0)
        step = opt0(jtrainer.make_train_step(specs_j, sites, opt, maxdisp=48))
        loss = float(step(params_j, stats_j, opt.init(params_j), 1e-3, left,
                          right, gt)[3]["loss"])
        out[mode] = dict(features=feat, stem=seen["stem"],
                         cost=seen["cost"], disparity=disp, loss=loss)
    monkeypatch.setenv("RAG_TPU_COMPUTE_DTYPE", "float32")
    seen.clear()
    tl, tr, tg = (torch.from_numpy(a) for a in (left, right, gt))
    with torch.no_grad():
        feat = t_f32(extract_feature(specs_t, params_t, stats_t,
                                     torch.from_numpy(both), frozenset(), {},
                                     precision=BF16))
        disp = stereo_forward(specs_t, params_t, stats_t, tl, tr, maxdisp=48,
                              precision=BF16)[0].numpy()
    opt = make_optimizer(0.003, 5.0)
    p = jax.tree_util.tree_map(lambda v: v.clone(), params_t)
    step = make_train_step(specs_t, sites, opt, maxdisp=48, precision=BF16)
    port = dict(features=feat, stem=seen["stem"], cost=seen["cost"],
                disparity=disp,
                loss=float(step(p, stats_t, opt.init(p), 1e-3, tl, tr,
                                tg)[3]["loss"]))
    r16, r32 = out["bfloat16"], out["float32"]
    return {k: (float(np.abs(np.reshape(port[k], np.shape(r16[k]))
                             - r16[k]).mean()),
                float(np.abs(r16[k] - r32[k]).mean())) for k in port}


GAP_KEYS = ("features", "stem", "cost", "disparity", "loss")


def _print_gaps(label, gaps):
    print(label + ", port-to-rag_tpu bf16 gap / rag_tpu's bf16-to-float32 "
          "gap: " + ", ".join(f"{k} {gaps[k][0] / gaps[k][1]:.3f}"
                              for k in GAP_KEYS))


def test_bf16_gap_to_rag_tpu(nets, monkeypatch):
    """The committed checkpoint's task 0 and 3 paths on two synthetic
    24x48 frames each: the port's bf16 result against rag_tpu's bf16 one,
    beside rag_tpu's own bf16-to-float32 gap.

    Held where the two packages' bf16 rounding has not yet compounded: the
    feature net's bf16 output equals rag_tpu's bit for bit, and at the
    matching net's first site (stem_3d1, behind kernels B and A) the gap
    is within rag_tpu's own bf16-to-float32 gap (the bound rag_tpu sets
    itself). Deeper, a bf16 rounding that falls the other way in one
    package perturbs what the next layer rounds, so the two bf16 results
    decorrelate with depth and the gap of the matching cost, the disparity
    and the loss comes to the size of rag_tpu's own gap; those ratios are
    printed (``-s``), not held: test_bf16_gap_over_frames measures them
    over more frames, with rag_tpu's weights kept float32 too."""
    jnet, tnet = nets
    sums = {k: np.zeros(2) for k in GAP_KEYS}
    for task in (0, 3):
        for seed in (0, 1):
            gaps = _frame_gaps(jnet, tnet, monkeypatch, task, seed)
            assert gaps["features"][0] == 0.0, (task, seed, gaps)
            assert gaps["stem"][0] <= gaps["stem"][1], (task, seed, gaps)
            for k in GAP_KEYS:
                sums[k] += gaps[k]
    _print_gaps("four frames", sums)


@pytest.mark.slow
@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "interpret"])
def test_bf16_gap_over_frames(nets, monkeypatch, interpret):
    """test_bf16_gap_to_rag_tpu over eight frames (tasks 0 and 3, seeds
    0-3), with rag_tpu on its CPU path (conv weights cast to bf16) or on
    its Pallas kernels in interpret mode (weights float32, as the port's
    kernels keep them): the same two bounds per frame; every ratio printed
    per frame and summed (``-s``)."""
    jnet, tnet = nets
    sums = {k: np.zeros(2) for k in GAP_KEYS}
    for task in (0, 3):
        for seed in range(4):
            gaps = _frame_gaps(jnet, tnet, monkeypatch, task, seed, interpret)
            _print_gaps(f"task {task} seed {seed}", gaps)
            assert gaps["features"][0] == 0.0, (task, seed, gaps)
            assert gaps["stem"][0] <= gaps["stem"][1], (task, seed, gaps)
            for k in GAP_KEYS:
                sums[k] += gaps[k]
    _print_gaps("eight frames, summed", sums)


class TestFeatureDtypePolicy:
    """The feature net rides the compute dtype, as under rag_tpu's default
    RAG_TPU_BF16_FEATURES=1 (its opt-out has no counterpart)."""

    def test_features_ride_bf16_under_policy(self, path):
        specs, params, stats = _state(path)
        img, _ = _images(3, (2, 24, 48, 3))
        f = extract_feature(specs, params, stats, img, frozenset(), {},
                            precision=BF16)
        assert f.dtype == torch.bfloat16

    def test_train_features_match_rag_tpu(self, path, monkeypatch):
        """Train-mode features (per-half batch statistics) under bf16:
        rag_tpu's feature dtype, its values bit for bit, and its new
        statistics within F32_RTOL."""
        specs, params, stats = _state(path)
        specs_j = {**jbuild_site_specs(jdefault_genotype()),
                   **jbuild_head_specs()}
        img, _ = _images(3, (2, 24, 48, 3))
        monkeypatch.setenv("RAG_TPU_COMPUTE_DTYPE", "bfloat16")
        from rag_tpu.ops.precision import feature_dtype

        jns = {}
        ref = jstereo.extract_feature(specs_j, path[1], path[2],
                                      jnp.asarray(img.numpy()),
                                      frozenset(specs_j), jns, halves=2)
        assert str(feature_dtype()) == str(ref.dtype) == "bfloat16"
        ns = {}
        f = extract_feature(specs, params, stats, img, frozenset(specs), ns,
                            halves=2, precision=BF16)
        assert f.dtype == torch.bfloat16
        np.testing.assert_array_equal(f.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
        for (k, v), (kj, vj) in zip(_flat(ns), _flat(jns)):
            assert k == kj
            np.testing.assert_allclose(v.numpy(), np.asarray(vj),
                                       rtol=F32_RTOL, atol=F32_RTOL)

    def test_f32_default_unaffected(self):
        assert FP32 == Precision() and not FP32.mixed()
        assert FP32.compute_dtype == torch.float32
        x = torch.zeros(2, dtype=torch.float64)
        assert FP32.cast_in(x) is x and wide(x) is x

    def test_train_bn_stats_stay_f32_with_bf16_features(self, path):
        specs, params, stats = _state(path)
        img, _ = _images(3, (2, 24, 48, 3))
        ns = {}
        extract_feature(specs, params, stats, img, frozenset(specs), ns,
                        halves=2, precision=BF16)
        leaves = list(_flat(ns))
        assert leaves and all(v.dtype == torch.float32 for _, v in leaves)

    def test_depth_variant_runs_under_bf16(self):
        """bf16 features reach the depth head's float32 conv: the head
        upcasts at entry, as the stereo head does."""
        g = default_genotype()
        specs = {**tdepth.build_depth_site_specs(g),
                 **tdepth.build_depth_head_specs()}
        gen = torch.Generator().manual_seed(0)
        from rag_tpu_torch.models.stereo import init_sites

        params, stats = init_sites(gen, specs, device="cpu")
        params["depth_head"], stats["depth_head"] = tdepth.init_depth_head(
            gen, device="cpu")
        img, _ = _images(3)
        d, _ = tdepth.depth_forward(specs, params, stats, img,
                                    train_sites=frozenset(specs),
                                    precision=BF16)
        assert d.dtype == torch.float32 and bool(torch.isfinite(d).all())

    def test_fused_head_upcasts_bf16_cost(self):
        """Kernel C takes float32 only: the forward upcasts a bf16 cost
        before the head (precision.wide), and the head's output is
        float32."""
        cost = torch.randn(1, 8, 8, 16).to(torch.bfloat16)
        d = tdisp.fused_soft_argmin(wide(cost).contiguous(), 24, 3)
        assert d.dtype == torch.float32 and d.shape == (1, 24, 48)
        with pytest.raises(ValueError):
            tdisp.check_f32("soft_argmin_fwd", cost)
