"""Kernels C and G (csrc/disp_head.cu) as redesigned for the H100, on the
CPU: what the CUDA kernels compute beyond their plain versions.

(a) The period: at maxdisp = 3D the D matrix is rebuilt exactly from four
per-residue weights (the periodic instance's constants), the weight-1
levels are exactly 1.0, and the instance is chosen by shape alone; the
general instance's table meets its walk's preconditions. The fold windows
of kernel G rebuild the transposed H/W matrices.
(b) Kernel C's order of arithmetic (tests/head_emulation.py: the
source-level walk, the max over blended source levels, one sums walk)
against the JAX reference and interpret-mode Pallas, within DISP_ATOL.
(c) Kernel G's blocking (``head_bwd_plan``): every input voxel gets every
contribution of its output rows and columns exactly once; kernel C's
staged source tiles (``tile_origin``, periodic instance) hold every tap of
their blocks' pixels.
(d) Kernel G's order of summation (D fold, W fold per strip, H fold): in
float64 within 1e-9 of the plain backward (of max |dx|), in float32 within
DISP_KERNEL_RTOL of interpret-mode Pallas where that engages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_emulation import emulate_head, emulate_head_bwd, general_walk_ok
from rag_tpu.ops.pallas_kernels import (
    _disp_bwd_pallas,
    _disp_pallas_raw,
    _disp_reference,
)
from rag_tpu.ops.resize import _interp_matrix_np as jax_interp_matrix_np
from rag_tpu_torch.ops.disparity import (
    HEAD_LANES,
    HEAD_SRC_COLS,
    HEAD_TILE_COLS,
    HEAD_TILE_ROWS,
    _taps_np,
    d_residues_np,
    fold_taps_np,
    head_bwd_plan,
    head_instance,
    periodic_matrix_np,
    soft_argmin_bwd_plain,
    tile_origin,
)

DISP_ATOL = 1e-3          # px
DISP_KERNEL_RTOL = 1e-4   # of max |dx|, against the Pallas kernel
F64_RTOL = 1e-9           # of max |dx|, float64 emulation vs plain


# -- (a) the period ----------------------------------------------------------

@pytest.mark.parametrize("d,maxdisp", [(64, 192), (160, 480), (320, 960),
                                       (8, 24), (4, 12)])
def test_residues_rebuild_matrix(d, maxdisp):
    res = d_residues_np(d, maxdisp)
    m = jax_interp_matrix_np(d, maxdisp, False)
    assert res is not None
    np.testing.assert_array_equal(periodic_matrix_np(d, res), m)
    ones = m[3 * np.arange(d) + 1, np.arange(d)]
    assert (ones == np.float32(1.0)).all()
    assert m[0, 0] == 1.0 and m[-1, -1] == 1.0


@pytest.mark.parametrize("d,maxdisp,instance", [
    (64, 192, 64), (8, 24, 8), (4, 12, 0), (16, 48, 0), (63, 190, 0),
    (8, 26, 0), (64, 193, 0), (5, 5, 0)])
def test_instance_by_shape(d, maxdisp, instance):
    assert head_instance(d, maxdisp) == instance
    if instance == 0:
        assert general_walk_ok(d, maxdisp)


def test_instance_refuses_downsampled_disparity():
    with pytest.raises(ValueError):
        head_instance(64, 60)


@pytest.mark.parametrize("n", [64, 128, 160, 320, 1, 4, 5, 43])
def test_fold_windows_rebuild_transpose(n):
    """Row q of the fold windows holds U[3q - 1 + i, q]: every nonzero of
    column q of the x3 matrix, in place."""
    f = fold_taps_np(n)
    m = np.zeros((3 * n, n), np.float32)
    for q in range(n):
        for i in range(5):
            o = 3 * q - 1 + i
            if 0 <= o < 3 * n:
                m[o, q] += f[q, i]
            else:
                assert f[q, i] == 0
    np.testing.assert_array_equal(m, jax_interp_matrix_np(n, 3 * n, False))


# -- (b) kernel C's arithmetic -----------------------------------------------

HEAD_CASES = [(1, 8, 16, 10, 24), (2, 8, 8, 16, 24), (1, 4, 2, 8, 12),
              (1, 64, 8, 16, 192), (1, 8, 16, 10, 26), (1, 7, 4, 5, 22)]


@pytest.mark.parametrize("b,d,h,w,maxdisp", HEAD_CASES)
def test_head_arithmetic_matches_reference(b, d, h, w, maxdisp):
    rng = np.random.default_rng(d * 7 + h + w + maxdisp)
    x = (rng.standard_normal((b, d, h, w)) * 3).astype(np.float32)
    got = emulate_head(x, maxdisp)
    ref = _disp_reference(jnp.asarray(x), maxdisp, 3)[0]
    kern = _disp_pallas_raw(jnp.asarray(x), maxdisp, 3, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), atol=DISP_ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(kern), atol=DISP_ATOL, rtol=0)


# -- (c) kernel G's blocking -------------------------------------------------

BWD_SHAPES = [(4, 64, 64, 128, 192), (1, 64, 160, 320, 192),
              (1, 8, 16, 10, 24), (2, 4, 5, 43, 12), (1, 8, 16, 10, 26),
              (1, 4, 3, 5, 12), (1, 1, 1, 1, 3), (2, 8, 5, 21, 24)]


@pytest.mark.parametrize("b,d,h,w,maxdisp", BWD_SHAPES)
def test_bwd_plan_covers_every_contribution_once(b, d, h, w, maxdisp):
    p = head_bwd_plan(b, d, h, w, maxdisp)
    assert p.lanes == 3 * p.strip + 2 <= HEAD_LANES
    assert p.tasks == b * 3 * h * p.strips
    assert p.fold_blocks * p.warps >= p.tasks > (p.fold_blocks - 1) * p.warps
    assert p.workspace == b * d * 3 * h * w
    # W: (source column, output column) folds over the strips' lanes
    count = np.zeros((w, 3 * w), np.int64)
    for strip in range(p.strips):
        q0 = strip * p.strip
        ncols = min(p.strip, w - q0)
        assert ncols >= 1
        computed = {3 * q0 - 1 + lane for lane in range(3 * ncols + 2)
                    if 0 <= 3 * q0 - 1 + lane < 3 * w}
        for j in range(ncols):
            for i in range(5):
                o = 3 * (q0 + j) - 1 + i
                if 0 <= o < 3 * w:
                    assert o in computed
                    count[q0 + j, o] += 1
    uw = jax_interp_matrix_np(w, 3 * w, False).T != 0
    assert (count[uw] == 1).all() and (count[~uw] <= 1).all()
    # H: each source row folds the output rows 3hi - 1 + i inside the map
    count = np.zeros((h, 3 * h), np.int64)
    for hi in range(h):
        for i in range(5):
            if 0 <= 3 * hi - 1 + i < 3 * h:
                count[hi, 3 * hi - 1 + i] += 1
    uh = jax_interp_matrix_np(h, 3 * h, False).T != 0
    assert (count[uh] == 1).all()


@pytest.mark.parametrize("h,w", [(160, 320), (64, 128), (16, 10), (5, 43),
                                 (1, 1), (3, 14)])
def test_staged_tiles_hold_every_tap(h, w):
    """Kernel C's blocks (3 output rows x 32 columns) read every H/W tap of
    their pixels inside their staged HEAD_TILE_ROWS x HEAD_SRC_COLS tile."""
    hi, _ = _taps_np(h, 3 * h)
    wi, _ = _taps_np(w, 3 * w)
    for j in range(h):
        rows = hi[3 * j:3 * j + HEAD_TILE_ROWS] - tile_origin(j, 0)[0]
        assert rows.min() >= 0 and rows.max() < HEAD_TILE_ROWS
        for t in range(-(-3 * w // HEAD_TILE_COLS)):
            c = wi[t * HEAD_TILE_COLS:(t + 1) * HEAD_TILE_COLS] \
                - tile_origin(j, t)[1]
            assert c.min() >= 0 and c.max() < HEAD_SRC_COLS, t


# -- (d) kernel G's order of summation --------------------------------------

def _bwd_data(b, d, h, w, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, d, h, w)) * 2).astype(np.float32)
    g = rng.standard_normal((b, 3 * h, 3 * w)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("b,d,h,w,maxdisp", [
    (1, 8, 16, 10, 24), (2, 4, 5, 43, 12), (1, 8, 16, 10, 26),
    (1, 4, 3, 5, 12), (1, 1, 1, 1, 3), (2, 8, 5, 21, 24)])
def test_bwd_order_float64_matches_plain(b, d, h, w, maxdisp):
    x, g = _bwd_data(b, d, h, w, b + d + h + w)
    got = emulate_head_bwd(x.astype(np.float64), g.astype(np.float64),
                           maxdisp, np.float64)
    ref = soft_argmin_bwd_plain(torch.from_numpy(x).double(),
                                torch.from_numpy(g).double(), maxdisp).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=F64_RTOL * np.abs(ref).max())


# h where the Pallas backward kernel engages (h % 8 == 0, h > 8)
@pytest.mark.parametrize("b,d,h,w,maxdisp", [
    (1, 8, 16, 16, 24), (2, 8, 16, 32, 24), (1, 4, 24, 13, 12),
    (1, 8, 16, 10, 26)])
def test_bwd_order_float32_matches_pallas(b, d, h, w, maxdisp):
    x, g = _bwd_data(b, d, h, w, h + w + maxdisp)
    got = emulate_head_bwd(x, g, maxdisp)
    kern = np.asarray(_disp_bwd_pallas(jnp.asarray(x), jnp.asarray(g),
                                       maxdisp, 3, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=0,
                               atol=DISP_KERNEL_RTOL * np.abs(kern).max())
