"""The port's variant kernels H-K (``KernelVariants``) against the JAX
package's off-by-default Pallas kernels, on the CPU.

Given CPU tensors, the wrappers of kernel H (``conv3d_dblock_cf``), I
(``resize_taps_cf``), J (``shear_forward``) and K (``shear_adjoint``) run
their plain PyTorch versions. Each is held against the TPU kernel it
replaces, run in interpret mode with its gate set as the JAX package's own
tests do (``RAG_TPU_KERNEL_INTERPRET=1`` and ``RAG_TPU_CONV3D_V4``,
``RAG_TPU_RESIZE_KERNEL``), against the JAX plain reference, and (J, K)
against the materialized cost volume + conv ``_xla_cvstem``, on the same
numpy inputs. Kernel I's tap gather is emulated in numpy in both
directions, from the port's own tap tables. The ``torch.autograd.
Function``s of the resize and the shear pass ``gradcheck`` in float64.

Tolerances: integer-valued inputs keep every sum exact, so the shear
assembly, its adjoint and the D-blocked conv's gradients match bit for
bit; float inputs: 1e-6 of max |ref| (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_tpu.ops import pallas_conv3d as jconv
from rag_tpu.ops import pallas_resize as jresize
from rag_tpu.ops import pallas_shear as jshear
from rag_tpu.ops.pallas_cvstem import _xla_cvstem
from rag_tpu_torch.ops import resize as resize_mod
from rag_tpu_torch.ops.conv3d import conv3d_brc_cf, conv3d_dblock_cf
from rag_tpu_torch.ops.resize import _taps_np, resize_cf, resize_taps_cf
from rag_tpu_torch.ops.shear import (
    shear_adjoint,
    shear_forward,
    shear_op,
    shear_stem_z,
    tap_maps,
)
from rag_tpu_torch.ops.variants import KernelVariants

RTOL = 1e-6
RESIZE = KernelVariants(resize_kernel=True)
DBLOCK = KernelVariants(conv3d_dblock=True)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("RAG_TPU_KERNEL_INTERPRET", "1")
    return monkeypatch


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * max(1e-30, float(np.abs(ref).max())))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- kernel I: the tap tables and the resize ---------------------------------


@pytest.mark.parametrize("n_in,n_out", [(64, 32), (32, 64), (7, 13), (13, 7),
                                        (5, 5), (1, 3), (3, 1), (160, 80)])
@pytest.mark.parametrize("transposed", [False, True])
def test_taps_np_bit_identical(n_in, n_out, transposed):
    idx, w = _taps_np(n_in, n_out, True, transposed)
    ridx, rw = jresize._taps_np(n_in, n_out, True, transposed)
    assert idx.dtype == ridx.dtype and w.dtype == rw.dtype
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(w, rw)


# input (2, 6, 5, 16, 24): 2x down, 2x up, odd sizes both ways, identity axes
RESIZE_TARGETS = [(3, 8, 12), (12, 32, 48), (4, 9, 13), (6, 16, 11),
                  (11, 16, 24)]


@pytest.mark.parametrize("target", RESIZE_TARGETS)
def test_resize_cf_matches_jax(interpret, target):
    interpret.setenv("RAG_TPU_RESIZE_KERNEL", "1")
    rng = np.random.default_rng(sum(target))
    x = rng.standard_normal((2, 6, 5, 16, 24)).astype(np.float32)
    g = rng.standard_normal((2, target[0], 5, *target[1:])).astype(np.float32)
    kern = jresize.resize_cf(jnp.asarray(x), *target, True)
    ref = jresize._xla_resize_cf(jnp.asarray(x), *target, True)
    _, vjp = jax.vjp(lambda v: jresize.resize_cf(v, *target, True),
                     jnp.asarray(x))
    (gref,) = vjp(jnp.asarray(g))

    xt = _t(x).requires_grad_(True)
    out = resize_cf(xt, *target, True, RESIZE)
    (gx,) = torch.autograd.grad(out, xt, _t(g))
    _close(out.detach().numpy(), kern)
    _close(out.detach().numpy(), ref)
    _close(gx.numpy(), gref)


def _emulate_resize(x, d2, h2, w2, transposed):
    """numpy form of csrc/resize_taps.cu's arithmetic: per output, the W
    taps gathered and weighted innermost, then the H taps, then the D
    taps, from the port's tap tables (tests/test_torch_port_resize_plan.py
    emulates its blocking and its order of sums within each axis)."""
    d, h, w = x.shape[1], x.shape[3], x.shape[4]
    (id_, wd), (ih, wh), (iw, ww) = (
        _taps_np(*((n2, n) if transposed else (n, n2)), True, transposed)
        for n, n2 in ((d, d2), (h, h2), (w, w2)))
    t = (x[..., iw] * ww).sum(-1)                          # (B,D,C,H,W2)
    t = (t[:, :, :, ih, :] * wh[:, :, None]).sum(4)        # (B,D,C,H2,W2)
    return (t[:, id_] * wd[None, :, :, None, None, None]).sum(2)


@pytest.mark.parametrize("target", RESIZE_TARGETS)
def test_resize_kernel_arithmetic_matches_reference(target):
    rng = np.random.default_rng(7 + sum(target))
    x = rng.standard_normal((2, 6, 5, 16, 24)).astype(np.float32)
    g = rng.standard_normal((2, target[0], 5, *target[1:])).astype(np.float32)
    ref = jresize._xla_resize_cf(jnp.asarray(x), *target, True)
    _, vjp = jax.vjp(lambda v: jresize._xla_resize_cf(v, *target, True),
                     jnp.asarray(x))
    (gref,) = vjp(jnp.asarray(g))
    _close(_emulate_resize(x, *target, False), ref)
    _close(_emulate_resize(g, 6, 16, 24, True), gref)
    # and the wrapper's plain version, both directions
    _close(resize_taps_cf(_t(x), *target).numpy(), ref)
    _close(resize_taps_cf(_t(g), 6, 16, 24, True, True).numpy(), gref)


@pytest.mark.parametrize("n_in,n_out,k", [(32, 64, 4), (6, 11, 3),
                                          (64, 32, 1), (11, 6, 1)])
def test_resize_adjoint_tap_counts(n_in, n_out, k):
    """The adjoint tables kernel I takes on the main path: K = 4 for a 2x
    upsample (the most csrc/resize_taps.cu accepts along H and W), 3 for the
    model's odd-size upsample, 1 for a 2x downsample."""
    idx, w = _taps_np(n_in, n_out, True, True)
    assert idx.shape == (n_in, k) and (np.count_nonzero(w, 1) == k).any()


def test_resize_function_gradcheck():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 2, 5, 7))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda v: resize_cf(v, 2, 9, 4, True, RESIZE), (x,))


def test_resize_default_runs_no_kernel(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("kernel I called on the default path")

    monkeypatch.setattr(resize_mod, "resize_taps_cf", refuse)
    x = torch.randn(1, 4, 2, 6, 8, requires_grad=True)
    resize_cf(x, 2, 3, 4).sum().backward()


# -- kernels J and K: the shear-collapsed stem --------------------------------


def _int_stem(seed, b, c, h, w, cout, nd, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, hi, (b, c, h, w)).astype(np.float32)
    y = rng.integers(lo, hi, (b, c, h, w)).astype(np.float32)
    w3 = rng.integers(lo, hi, (3, 3, 3, 2 * c, cout)).astype(np.float32)
    g = rng.integers(-2, 3, (b, nd, cout, h, w)).astype(np.float32)
    return x, y, w3, g


# tests/test_shear.py's shapes (D < W, D == W, batch 2, W past 128) plus
# num_disp past W and W = 13
SHEAR_CASES = [
    (1, 4, 8, 16, 4, 5),
    (1, 3, 8, 24, 6, 24),
    (2, 4, 16, 16, 4, 8),
    (1, 4, 8, 130, 4, 6),
    (1, 3, 8, 10, 4, 14),
    (2, 2, 8, 13, 3, 6),
]


@pytest.mark.parametrize("b,c,h,w,cout,nd", SHEAR_CASES)
def test_shear_plain_bit_exact(interpret, b, c, h, w, cout, nd):
    """tap_maps, plain J (with an integer affine and ReLU too) and plain K
    on integers: bit-equal to the Pallas kernels in interpret mode and to
    the materialized cost volume + conv."""
    x, y, w3, g = _int_stem(7 * b + nd + w, b, c, h, w, cout, nd)
    px, py = tap_maps(_t(x), _t(y), _t(w3))
    jpx, jpy = jshear.tap_maps(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w3))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))

    one, zero = np.ones(cout, np.float32), np.zeros(cout, np.float32)
    z = shear_forward(px, py, _t(one), _t(zero), nd)
    kern = jshear.shear_forward(jpx, jpy, jnp.asarray(one), jnp.asarray(zero),
                                nd, w, interpret=True)
    np.testing.assert_array_equal(z.numpy(), np.asarray(kern))
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(_xla_cvstem(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(w3), nd)))

    scale = np.arange(1, cout + 1, dtype=np.float32)
    bias = np.full(cout, -3.0, np.float32)
    zr = shear_forward(px, py, _t(scale), _t(bias), nd, relu=True)
    kr = jshear.shear_forward(jpx, jpy, jnp.asarray(scale), jnp.asarray(bias),
                              nd, w, relu=True, interpret=True)
    np.testing.assert_array_equal(zr.numpy(), np.asarray(kr))

    dpx, dpy = shear_adjoint(_t(g), nd)
    kx, ky = jshear.shear_adjoint(jnp.asarray(g), nd, w, interpret=True)
    np.testing.assert_array_equal(dpx.numpy(), np.asarray(kx))
    np.testing.assert_array_equal(dpy.numpy(), np.asarray(ky))


@pytest.mark.parametrize("b,c,h,w,cout,nd", SHEAR_CASES[:2] + SHEAR_CASES[4:])
def test_shear_adjoint_identity_exact(b, c, h, w, cout, nd):
    """<J(px, py), g> == <px, dpx> + <py, dpy> on integers."""
    x, y, w3, g = _int_stem(3 * w + nd, b, c, h, w, cout, nd, -2, 3)
    px, py = tap_maps(_t(x), _t(y), _t(w3))
    z = shear_op(px, py, nd)
    dpx, dpy = shear_adjoint(_t(g), nd)
    lhs = float((z.double() * _t(g).double()).sum())
    rhs = float((px.double() * dpx.double()).sum()
                + (py.double() * dpy.double()).sum())
    assert lhs == rhs, (lhs, rhs)


@pytest.mark.parametrize("b,c,h,w,cout,nd", [(1, 3, 8, 16, 4, 6),
                                             (2, 2, 8, 10, 3, 12)])
def test_shear_stem_gradients_match_jax(b, c, h, w, cout, nd):
    """dX, dY and dW of shear_stem_z (kernel K, then autograd through the
    tap-map convs) against jax.grad of the materialized composition, exact
    on integers."""
    x, y, w3, g = _int_stem(b + w + nd, b, c, h, w, cout, nd, -2, 3)
    xt, yt, wt = (_t(a).requires_grad_(True) for a in (x, y, w3))
    grads = torch.autograd.grad(shear_stem_z(xt, yt, wt, nd), (xt, yt, wt),
                                _t(g))
    ref = jax.grad(lambda a, bb, cc: jnp.vdot(_xla_cvstem(a, bb, cc, nd),
                                              jnp.asarray(g)),
                   argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(w3))
    for got, want in zip(grads, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shear_function_gradcheck():
    rng = np.random.default_rng(4)
    f64 = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: shear_op(a, b, 6),
                                    (f64(1, 9, 2, 3, 5), f64(1, 9, 2, 3, 5)))
    assert torch.autograd.gradcheck(
        lambda x, y, w: shear_stem_z(x, y, w, 4),
        (f64(1, 2, 3, 5), f64(1, 2, 3, 5), f64(3, 3, 3, 4, 2)))


# -- kernel H: the D-blocked conv -------------------------------------------


@pytest.mark.parametrize("b,d,cin,h,w,cout", [(1, 8, 6, 32, 16, 10),
                                              (2, 4, 12, 16, 24, 12),
                                              (1, 2, 4, 8, 13, 1)])
def test_conv_matches_jax_v4(interpret, b, d, cin, h, w, cout):
    """The port's conv with the D-blocked variant against rag_tpu's v4
    kernel (RAG_TPU_CONV3D_V4=1) in interpret mode: the forward on floats,
    and the forward and its dX, dW on integers, bit for bit."""
    interpret.setenv("RAG_TPU_CONV3D_V4", "1")
    rng = np.random.default_rng(d * cin + w)
    x = rng.standard_normal((b, d, cin, h, w)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    scale = (rng.standard_normal(cout) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    out = conv3d_dblock_cf(_t(x), _t(wt), _t(scale), _t(bias), True)
    kern = jconv._conv3d_pallas_cf(jnp.asarray(x), jconv.pack_weights(wt),
                                   jnp.asarray(scale), jnp.asarray(bias),
                                   True, interpret=True)
    _close(out.numpy(), kern)

    xi = rng.integers(-3, 4, x.shape).astype(np.float32)
    wi = rng.integers(-2, 3, wt.shape).astype(np.float32)
    si = rng.integers(1, 3, cout).astype(np.float32)
    bi = rng.integers(-2, 3, cout).astype(np.float32)
    gi = rng.integers(-2, 3, (b, d, cout, h, w)).astype(np.float32)
    ts = [_t(a).requires_grad_(True) for a in (xi, wi, si, bi)]
    y = conv3d_brc_cf(*ts, True, DBLOCK)
    grads = torch.autograd.grad(y, ts, _t(gi))
    fn = lambda *a: jconv.conv3d_brc_cf(*a, True)
    yj, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (xi, wi, si, bi)))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(yj))
    for got, want in zip(grads, vjp(jnp.asarray(gi))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
