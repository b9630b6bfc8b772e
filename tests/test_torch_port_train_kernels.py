"""The port's four backward kernels and its four differentiable kernel
entries against the JAX package, on the CPU.

Kernel D (``conv3d_dw_cf``), E (``cvstem_dxy``), F (``cvstem_dw``) and G
(``soft_argmin_bwd``), given CPU tensors, run their plain PyTorch
versions; each is held against the JAX Pallas kernel it replaces in
interpret mode and against ``jax.vjp`` of the JAX plain reference, on the
same numpy inputs. What the CUDA kernels compute beyond their plain
versions and is reachable here is checked too: kernel G's two passes
(the softmin walk, the D fold, the W fold over warp strips, the H fold)
emulated in numpy, and its fold windows.
The four ``torch.autograd.Function``s (``conv3d_brc_cf``, ``cvstem_conv``,
``cvstem_brc``, ``fused_soft_argmin``) pass ``gradcheck`` in float64, and
a frozen input costs no backward kernel call.

Tolerances: integer-valued inputs keep every sum of the stem's backward
exact, so E and F match bit for bit; float inputs: 1e-5 of the largest
magnitude for the weight gradients (float32 sums in another order), 1e-5
for the head's analytic backward (same formula), 1e-4 against the Pallas
head-backward kernel (its interpolations run as matmuls in another order
over 192 levels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from head_emulation import emulate_head_bwd
from rag_tpu.ops.pallas_conv3d import _xla_conv3d_cf, conv3d_dw_pallas
from rag_tpu.ops.pallas_cvstem import (
    _xla_cvstem,
    cvstem_dw_pallas,
    cvstem_dxy_pallas,
)
from rag_tpu.ops.pallas_kernels import _disp_bwd_pallas, _fsa_bwd
from rag_tpu.ops.resize import _interp_matrix_np as jax_interp_matrix_np
from rag_tpu_torch.ops import conv3d as conv3d_mod
from rag_tpu_torch.ops import cvstem as cvstem_mod
from rag_tpu_torch.ops.conv3d import conv3d_brc_cf, conv3d_dw_cf
from rag_tpu_torch.ops.cvstem import cvstem_brc, cvstem_conv, cvstem_dw, cvstem_dxy
from rag_tpu_torch.ops.disparity import (
    fold_taps_np,
    fused_soft_argmin,
    soft_argmin_bwd,
)

DW_RTOL = 1e-5
DISP_RTOL = 1e-5
DISP_KERNEL_RTOL = 1e-4


def _close(out, ref, rtol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * max(1e-30, float(np.abs(ref).max())))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# (b, d, cin, h, w, cout): the JAX kernel test's shape, the Cout=1 head
# with W not a multiple of 8, merged Cout 48, stem_3d1-like 12 -> 12
DW_CASES = [
    (2, 3, 4, 16, 8, 6),
    (1, 3, 12, 8, 13, 1),
    (1, 2, 16, 8, 10, 48),
    (2, 2, 12, 16, 12, 12),
]


@pytest.mark.parametrize("b,d,cin,h,w,cout", DW_CASES)
def test_conv3d_dw_matches_jax(b, d, cin, h, w, cout):
    rng = np.random.default_rng(cin * 10 + cout + w)
    x = rng.standard_normal((b, d, cin, h, w)).astype(np.float32)
    dz = rng.standard_normal((b, d, cout, h, w)).astype(np.float32)
    out = conv3d_dw_cf(_t(x), _t(dz))
    kern = conv3d_dw_pallas(jnp.asarray(x), jnp.asarray(dz), interpret=True)
    _, vjp_w = jax.vjp(lambda w_: _xla_conv3d_cf(jnp.asarray(x), w_),
                       jnp.zeros((3, 3, 3, cin, cout), jnp.float32))
    (ref,) = vjp_w(jnp.asarray(dz))
    assert out.shape == (3, 3, 3, cin, cout)
    _close(out.numpy(), kern, DW_RTOL)
    _close(out.numpy(), ref, DW_RTOL)


# (b, c, h, w, num_disp, cout): tests/test_cvstem.py's shapes (D == W,
# lane-padded W), the real 12-channel stem, num_disp one short of W
CVSTEM_CASES = [
    (1, 3, 16, 12, 5, 4),
    (2, 2, 8, 10, 4, 3),
    (1, 2, 32, 130, 6, 5),
    (1, 1, 8, 8, 8, 2),
    (1, 12, 8, 20, 6, 12),
    (1, 2, 8, 9, 8, 3),
]


def _stem_data(b, c, h, w, nd, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (b, c, h, w)).astype(np.float32)
    y = rng.integers(-3, 4, (b, c, h, w)).astype(np.float32)
    w3 = rng.integers(-2, 3, (3, 3, 3, 2 * c, cout)).astype(np.float32)
    g = rng.integers(-2, 3, (b, nd, cout, h, w)).astype(np.float32)
    return x, y, w3, g


@pytest.mark.parametrize("b,c,h,w,nd,cout", CVSTEM_CASES)
def test_cvstem_bwd_exact_against_jax(b, c, h, w, nd, cout):
    """E and F on integer data: bit-equal to the Pallas kernels and to
    jax.vjp of the materialized composition."""
    x, y, w3, g = _stem_data(b, c, h, w, nd, cout, b * 11 + w + nd)
    dx, dy = cvstem_dxy(_t(g), _t(w3), nd)
    dw = cvstem_dw(_t(x), _t(y), _t(g), nd)
    kx, ky = cvstem_dxy_pallas(jnp.asarray(g), jnp.asarray(w3), nd,
                               interpret=True)
    kw = cvstem_dw_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(g), nd,
                          interpret=True)
    _, vjp = jax.vjp(lambda a, bb, cc: _xla_cvstem(a, bb, cc, nd),
                     jnp.asarray(x), jnp.asarray(y), jnp.asarray(w3))
    rx, ry, rw = vjp(jnp.asarray(g))
    for out, kern, ref in ((dx, kx, rx), (dy, ky, ry), (dw, kw, rw)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(kern))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("w,nd", [(6, 9), (5, 5), (12, 3)])
def test_cvstem_bwd_num_disp_near_and_past_w(w, nd):
    """num_disp at and past W (planes with no valid column) against
    jax.vjp: every mask and the +d shift at their edges."""
    b, c, h, cout = 1, 2, 4, 3
    x, y, w3, g = _stem_data(b, c, h, w, nd, cout, w * 7 + nd)
    dx, dy = cvstem_dxy(_t(g), _t(w3), nd)
    dw = cvstem_dw(_t(x), _t(y), _t(g), nd)
    _, vjp = jax.vjp(lambda a, bb, cc: _xla_cvstem(a, bb, cc, nd),
                     jnp.asarray(x), jnp.asarray(y), jnp.asarray(w3))
    for out, ref in zip((dx, dy, dw), vjp(jnp.asarray(g))):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _disp_data(b, d, h, w, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, d, h, w)) * 2).astype(np.float32)
    g = rng.standard_normal((b, 3 * h, 3 * w)).astype(np.float32)
    return x, g


# h where the Pallas backward kernel engages (h % 8 == 0, h > 8)
@pytest.mark.parametrize("b,d,h,w,maxdisp", [(1, 8, 16, 16, 24),
                                             (2, 8, 16, 32, 24),
                                             (1, 4, 24, 13, 12)])
def test_soft_argmin_bwd_matches_pallas(b, d, h, w, maxdisp):
    x, g = _disp_data(b, d, h, w, h + w)
    out = soft_argmin_bwd(_t(x), _t(g), maxdisp, 3)
    kern = _disp_bwd_pallas(jnp.asarray(x), jnp.asarray(g), maxdisp, 3,
                            interpret=True)
    (ref,) = _fsa_bwd(maxdisp, 3, jnp.asarray(x), jnp.asarray(g))
    _close(out.numpy(), kern, DISP_KERNEL_RTOL)
    _close(out.numpy(), ref, DISP_RTOL)


# small h, where the Pallas kernel does not engage and JAX takes the
# analytic form; the port's kernel G takes every h
@pytest.mark.parametrize("b,d,h,w,maxdisp", [(1, 4, 3, 5, 12),
                                             (2, 8, 5, 43, 24),
                                             (1, 16, 8, 10, 48)])
def test_soft_argmin_bwd_matches_analytic(b, d, h, w, maxdisp):
    x, g = _disp_data(b, d, h, w, d + h + w)
    out = soft_argmin_bwd(_t(x), _t(g), maxdisp, 3)
    (ref,) = _fsa_bwd(maxdisp, 3, jnp.asarray(x), jnp.asarray(g))
    _close(out.numpy(), ref, DISP_RTOL)


@pytest.mark.parametrize("n_in,n_out", [(64, 192), (128, 384), (4, 12),
                                        (7, 21), (5, 5), (1, 3)])
def test_inverse_tap_tables_rebuild_transpose(n_in, n_out):
    """Kernel G's fold windows (row q: U[s*q - (s-1)/2 + i, q] at scale s)
    hold exactly the columns of the float32 matrix the reference
    contracts with."""
    scale = n_out // n_in
    wts = fold_taps_np(n_in, scale)
    lo = (scale - 1) // 2
    m = np.zeros((n_out, n_in), np.float32)
    for q in range(n_in):
        for i in range(wts.shape[1]):
            o = scale * q - lo + i
            if 0 <= o < n_out:
                m[o, q] += wts[q, i]
            else:
                assert wts[q, i] == 0
    np.testing.assert_array_equal(m, jax_interp_matrix_np(n_in, n_out, False))


def _emulate_disp_bwd(x, g, maxdisp, scale):
    """numpy form of csrc/disp_head.cu's kernel G (tests/head_emulation.py):
    pass 1 recomputes the softmin per output pixel, walks the levels again
    folding dy through the D taps, and folds W over each warp's strip of
    source columns; pass 2 folds H per input voxel."""
    assert scale == 3
    return emulate_head_bwd(x, g, maxdisp)


@pytest.mark.parametrize("b,d,h,w,maxdisp", [(1, 8, 16, 10, 24),
                                             (2, 4, 5, 43, 12)])
def test_disp_bwd_kernel_arithmetic_matches_reference(b, d, h, w, maxdisp):
    x, g = _disp_data(b, d, h, w, 3 * d + w)
    got = _emulate_disp_bwd(x, g, maxdisp, 3)
    (ref,) = _fsa_bwd(maxdisp, 3, jnp.asarray(x), jnp.asarray(g))
    _close(got, ref, DISP_RTOL)


# -- the differentiable entries --------------------------------------------


def _f64(rng, *shape, s=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * s).requires_grad_(True)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3d_brc_cf_gradcheck(relu):
    rng = np.random.default_rng(1)
    args = (_f64(rng, 1, 3, 2, 4, 5), _f64(rng, 3, 3, 3, 2, 3, s=0.3),
            _f64(rng, 3, s=0.3) + 1.0, _f64(rng, 3, s=0.2))
    assert torch.autograd.gradcheck(
        lambda x, w, a, b: conv3d_brc_cf(x, w, a, b, relu), args)


def test_cvstem_conv_gradcheck():
    rng = np.random.default_rng(2)
    args = (_f64(rng, 1, 2, 4, 6), _f64(rng, 1, 2, 4, 6),
            _f64(rng, 3, 3, 3, 4, 3, s=0.3))
    assert torch.autograd.gradcheck(lambda x, y, w: cvstem_conv(x, y, w, 5),
                                    args)


@pytest.mark.parametrize("relu", [True, False])
def test_cvstem_brc_gradcheck(relu):
    rng = np.random.default_rng(3)
    args = (_f64(rng, 1, 2, 4, 6), _f64(rng, 1, 2, 4, 6),
            _f64(rng, 3, 3, 3, 4, 3, s=0.3), _f64(rng, 3, s=0.3) + 1.0,
            _f64(rng, 3, s=0.2))
    assert torch.autograd.gradcheck(
        lambda x, y, w, a, b: cvstem_brc(x, y, w, a, b, 5, relu), args)


def test_fused_soft_argmin_gradcheck():
    rng = np.random.default_rng(4)
    x = _f64(rng, 2, 4, 3, 5, s=2.0)
    assert torch.autograd.gradcheck(lambda v: fused_soft_argmin(v, 12, 3), (x,))


def test_frozen_weights_cost_no_weight_gradient(monkeypatch):
    """Only the input needs a gradient (a frozen site with a trainable
    site upstream): the backwards form dx and never call D or F."""
    def refuse(*args):
        raise AssertionError("weight-gradient kernel called for a frozen site")

    monkeypatch.setattr(conv3d_mod, "conv3d_dw_cf", refuse)
    monkeypatch.setattr(cvstem_mod, "cvstem_dw", refuse)
    rng = np.random.default_rng(5)
    f32 = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
    x = f32(1, 3, 2, 4, 5)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 2, 3)).astype(np.float32))
    one, zero = torch.ones(3), torch.zeros(3)
    conv3d_brc_cf(x, w, one, zero, True).sum().backward()
    xf = f32(1, 2, 4, 6)
    w3 = torch.from_numpy(rng.standard_normal((3, 3, 3, 4, 3)).astype(np.float32))
    cvstem_brc(xf, xf.detach(), w3, one, zero, 5, True).sum().backward()
    assert x.grad is not None and xf.grad is not None
