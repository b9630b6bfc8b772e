"""The port's three kernel functions against the JAX package, on the CPU.

For each of kernel A (conv3d_brc_cf), kernel B (cvstem_brc) and kernel C
(fused_soft_argmin) the port's function, given CPU tensors, runs its plain
PyTorch version; it is held against the JAX Pallas kernel in interpret mode
and against the JAX plain reference, on the same numpy inputs. The CUDA
kernels themselves run only on the card (chip_smoke.py holds each against
its plain version there); what surrounds them and is reachable here -- the
interpolation tap tables and the cost-volume load rule the kernels
implement -- is checked here too.

Tolerances: float32 sums in another order than XLA's give ~1e-6 relative
error per conv; 1e-5 relative (of the output's largest magnitude) leaves
margin. Disparity is an expectation over 192 levels: 1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from head_emulation import emulate_head
from rag_tpu.ops.pallas_conv3d import (
    _conv3d_pallas_cf,
    conv3d_brc_cf as jax_conv3d_brc_cf,
    pack_weights as jax_pack_weights,
)
from rag_tpu.ops.pallas_cvstem import (
    cvstem_brc as jax_cvstem_brc,
    cvstem_forward_cf,
)
from rag_tpu.ops.pallas_kernels import _disp_pallas_raw, _disp_reference
from rag_tpu.ops.resize import _interp_matrix_np as jax_interp_matrix_np
from rag_tpu_torch.ops.conv3d import conv3d_brc_cf
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.cvstem import cvstem_brc
from rag_tpu_torch.ops.disparity import (
    _taps_np,
    fused_soft_argmin,
    soft_argmin_disparity,
)

CONV_RTOL = 1e-5   # of max |ref|: f32 summation order only
DISP_ATOL = 1e-3   # px


def _close(out, ref, rtol=CONV_RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(ref).max())))


def _affine(rng, cout):
    return (rng.standard_normal(cout).astype(np.float32) * 0.5 + 1.0,
            rng.standard_normal(cout).astype(np.float32) * 0.1)


# (b, d, cin, h, w, cout, relu): stem_3d1-like, Cout=1 head with W not a
# multiple of 8, merged Cout=48 with W=10, Cout=24 (two 12-wide tiles)
CONV_CASES = [
    (1, 4, 12, 16, 24, 12, True),
    (1, 3, 12, 8, 13, 1, False),
    (1, 3, 16, 8, 10, 48, True),
    (2, 2, 8, 8, 16, 24, True),
]


@pytest.mark.parametrize("b,d,cin,h,w,cout,relu", CONV_CASES)
def test_conv3d_matches_jax(b, d, cin, h, w, cout, relu):
    rng = np.random.default_rng(cin * 100 + cout + w)
    x = rng.standard_normal((b, d, cin, h, w)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    scale, bias = _affine(rng, cout)
    out = conv3d_brc_cf(torch.from_numpy(x), torch.from_numpy(wt),
                        torch.from_numpy(scale), torch.from_numpy(bias), relu)
    kern = _conv3d_pallas_cf(jnp.asarray(x), jax_pack_weights(jnp.asarray(wt)),
                             jnp.asarray(scale), jnp.asarray(bias), relu,
                             interpret=True)
    plain = jax_conv3d_brc_cf(jnp.asarray(x), jnp.asarray(wt),
                              jnp.asarray(scale), jnp.asarray(bias), relu)
    _close(out.numpy(), kern)
    _close(out.numpy(), plain)


# (b, c, h, w, num_disp, cout): the edge cases tests/test_cvstem.py pins
# (D == W, lane-padded W) plus the real 12-channel stem at Cout 12
CVSTEM_CASES = [
    (1, 3, 16, 12, 5, 4),
    (2, 2, 8, 10, 4, 3),
    (1, 2, 32, 130, 6, 5),
    (1, 1, 8, 8, 8, 2),
    (1, 12, 8, 20, 6, 12),
]


@pytest.mark.parametrize("b,c,h,w,nd,cout", CVSTEM_CASES)
def test_cvstem_matches_jax(b, c, h, w, nd, cout):
    rng = np.random.default_rng(b * 7 + w + nd)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    y = rng.standard_normal((b, c, h, w)).astype(np.float32)
    w3 = (rng.standard_normal((3, 3, 3, 2 * c, cout)) * 0.2).astype(np.float32)
    scale, bias = _affine(rng, cout)
    out = cvstem_brc(torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(w3), torch.from_numpy(scale),
                     torch.from_numpy(bias), nd, relu=True)
    kern = cvstem_forward_cf(jnp.asarray(x), jnp.asarray(y),
                             jax_pack_weights(jnp.asarray(w3)),
                             jnp.asarray(scale), jnp.asarray(bias), nd,
                             relu=True, interpret=True)
    plain = jax_cvstem_brc(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w3),
                           jnp.asarray(scale), jnp.asarray(bias), nd, True)
    assert out.shape == (b, nd, cout, h, w)
    _close(out.numpy(), kern)
    _close(out.numpy(), plain)


@pytest.mark.parametrize("b,c,h,w,nd,cout", CVSTEM_CASES[:4])
def test_cvstem_integer_exact(b, c, h, w, nd, cout):
    """Integer data keeps every sum exact: any masking or shift error in
    the volume shows as a non-zero difference."""
    rng = np.random.default_rng(b * 11 + w + nd)
    x = rng.integers(-3, 4, (b, c, h, w)).astype(np.float32)
    y = rng.integers(-3, 4, (b, c, h, w)).astype(np.float32)
    w3 = rng.integers(-2, 3, (3, 3, 3, 2 * c, cout)).astype(np.float32)
    ones, zeros = np.ones(cout, np.float32), np.zeros(cout, np.float32)
    out = cvstem_brc(torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(w3), torch.from_numpy(ones),
                     torch.from_numpy(zeros), nd, relu=False)
    kern = cvstem_forward_cf(jnp.asarray(x), jnp.asarray(y),
                             jax_pack_weights(jnp.asarray(w3)),
                             jnp.asarray(ones), jnp.asarray(zeros), nd,
                             relu=False, interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(kern))


def _cost_volume_load(x, y, nd, db, hb, jb):
    """numpy form of the cost volume's load rule, csrc/volume_src.cuh::
    CostVolumeSrc::row (ops/cvstem.py::stage_row), over broadcast index
    grids (d, c, h, j) that reach one step past every edge."""
    b, c, h, w = x.shape
    d = db[:, None, None, None]
    cc = np.arange(2 * c)[None, :, None, None]
    hh = hb[None, None, :, None]
    j = jb[None, None, None, :]
    inside = (d >= 0) & (d < nd) & (hh >= 0) & (hh < h) & (j >= d) & (j < w)
    hs = np.clip(hh, 0, h - 1)
    xv = x[:, np.clip(cc, 0, c - 1), hs, np.clip(j, 0, w - 1)]
    yv = y[:, np.clip(cc - c, 0, c - 1), hs, np.clip(j - d, 0, w - 1)]
    v = np.where(cc < c, xv, yv)
    return np.where(inside, v, 0.0)


@pytest.mark.parametrize("w,nd", [(8, 8), (10, 4), (6, 9)])
def test_cost_volume_load_rule_matches_padded_volume(w, nd):
    """The kernel's on-the-fly volume, read over the conv's 1-voxel halo,
    equals the zero-padded materialized volume (the clipped source column
    of the reference never leaks into the W halo)."""
    rng = np.random.default_rng(w + nd)
    b, c, h = 1, 2, 4
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    y = rng.standard_normal((b, c, h, w)).astype(np.float32)
    vol = cost_volume_cf(torch.from_numpy(x).permute(0, 2, 3, 1),
                         torch.from_numpy(y).permute(0, 2, 3, 1), nd)
    padded = torch.nn.functional.pad(vol, (1, 1, 1, 1, 0, 0, 1, 1)).numpy()
    got = _cost_volume_load(x, y, nd, np.arange(-1, nd + 1),
                            np.arange(-1, h + 1), np.arange(-1, w + 1))
    np.testing.assert_array_equal(got, padded)


# (b, d, h, w, maxdisp): W not a multiple of 8, multi-row-tile, tiny
DISP_CASES = [
    (1, 8, 16, 10, 24),
    (2, 8, 8, 16, 24),
    (1, 4, 2, 8, 12),
]


@pytest.mark.parametrize("b,d,h,w,maxdisp", DISP_CASES)
def test_soft_argmin_matches_jax(b, d, h, w, maxdisp):
    rng = np.random.default_rng(d * 10 + h + w)
    x = (rng.standard_normal((b, d, h, w)) * 3).astype(np.float32)
    out = fused_soft_argmin(torch.from_numpy(x), maxdisp, 3)
    plain = soft_argmin_disparity(torch.from_numpy(x), maxdisp, 3)
    kern = _disp_pallas_raw(jnp.asarray(x), maxdisp, 3, interpret=True)
    ref = _disp_reference(jnp.asarray(x), maxdisp, 3)[0]
    assert out.shape == (b, 3 * h, 3 * w)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), atol=DISP_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DISP_ATOL, rtol=0)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())


@pytest.mark.parametrize("n_in,n_out", [(64, 192), (160, 480), (320, 960),
                                        (4, 12), (7, 21), (5, 5)])
def test_tap_tables_rebuild_reference_matrix(n_in, n_out):
    """Kernel C's two-tap tables hold exactly the float32 matrix entries
    the reference contracts with."""
    idx, wts = _taps_np(n_in, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    for r in range(n_out):
        m[r, idx[r, 0]] += wts[r, 0]
        if idx[r, 1] != idx[r, 0]:
            m[r, idx[r, 1]] += wts[r, 1]
        else:
            assert wts[r, 1] == 0
    np.testing.assert_array_equal(m, jax_interp_matrix_np(n_in, n_out, False))


def _emulate_disp_kernel(x, maxdisp, scale):
    """numpy form of soft_argmin_kernel in csrc/disp_head.cu
    (tests/head_emulation.py): per pixel, blend the H/W taps for each
    cost level, take the minimum over the blended source levels, then one
    walk over the disparity levels for sum(e) and sum(k e)."""
    assert scale == 3
    return emulate_head(x, maxdisp)


@pytest.mark.parametrize("b,d,h,w,maxdisp", DISP_CASES)
def test_disp_kernel_arithmetic_matches_reference(b, d, h, w, maxdisp):
    rng = np.random.default_rng(d + h + w)
    x = (rng.standard_normal((b, d, h, w)) * 3).astype(np.float32)
    got = _emulate_disp_kernel(x, maxdisp, 3)
    ref = _disp_reference(jnp.asarray(x), maxdisp, 3)[0]
    np.testing.assert_allclose(got, np.asarray(ref), atol=DISP_ATOL, rtol=0)
