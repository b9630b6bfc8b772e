"""The yardstick of the kernels' rooflines: operations and bytes a call
needs, from its shapes, and the least time the H100 could take for them.

The counting functions are copies of chip_smoke.py's ``conv_bound``,
``cvstem_bound``, ``disp_bound``, ``dw_bound``, ``cvstem_dxy_bound``,
``cvstem_dw_bound``, ``disp_bwd_bound``, ``resize_bound``, ``shear_bound``
and ``shear_adj_bound``, cut before their division by a peak: each returns
``(flops, nbytes)``. Their helpers (the interpolation matrix, its tap
table, the shear's nine taps) are copied too, so that nothing here reads
the program. ``bound_s`` prices a count at one peak for every operation:
the H100's dense TF32 rate, because kernel A's float32-accurate products
run on the tensor cores (3xTF32) and would pass 100 % of the 67 TFLOP/s
float32 rate.
"""

from __future__ import annotations

import functools

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least: operations at the TF32 peak or
    bytes at the HBM rate, whichever takes longer."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


# -- copied helpers -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def interp_matrix_np(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) linear interpolation matrix, float64 weights cast to
    float32 (rag_tpu_torch/ops/resize.py::_interp_matrix_np)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    if align_corners:
        if n_out == 1:
            x = np.zeros((1,), np.float64)
        else:
            x = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    else:
        x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0.0, n_in - 1)
    i0 = np.minimum(np.floor(x).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = x - i0
    m = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - w1)
    np.add.at(m, (rows, i1), w1)
    return m.astype(np.float32)


def taps_np(n_in: int, n_out: int, align_corners: bool, transposed: bool):
    """(idx, w) tap table of the matrix or its transpose, padded taps at
    weight 0 (rag_tpu_torch/ops/resize.py::_taps_np)."""
    m = interp_matrix_np(n_in, n_out, align_corners)
    if transposed:
        m = m.T
    k_max = max(int((r != 0).sum()) for r in m) or 1
    idx, wts = [], []
    for r in m:
        nz = np.nonzero(r)[0]
        idx.append(list(nz) + [0] * (k_max - len(nz)))
        wts.append(list(r[nz]) + [0.0] * (k_max - len(nz)))
    return np.array(idx, np.int32), np.array(wts, np.float32)


# the shear stem's nine (plane, column) taps (rag_tpu_torch/ops/shear.py::T9)
T9 = tuple((dd, dw) for dd in range(3) for dw in range(3))


def _taps(n: int) -> int:
    """(output, tap) pairs of a 3-tap zero-padded axis that read inside."""
    return 3 * n - 2 if n > 1 else 1


def _stem_products(nd, w, dv_needed=False):
    """(plane, column, kd, kw) combinations of the stem's conv whose
    product is not structurally zero (chip_smoke.py::_stem_products)."""
    d = np.arange(nd)[:, None, None, None]
    dd = np.arange(3)[None, :, None, None]
    j = np.arange(w)[None, None, :, None]
    kw = np.arange(3)[None, None, None, :]
    dv, jv = d + dd - 1, j + kw - 1
    inside = (dv >= 0) & (dv < nd) & (jv >= 0) & (jv < w)
    inside &= (j >= d) if dv_needed else (jv >= dv)
    return int(inside.sum())


def _shear_terms(nd, w):
    """(plane, column, term) adds of the shear assembly that its masks
    keep (chip_smoke.py::_shear_terms)."""
    d = np.arange(nd)[:, None]
    j = np.arange(w)[None, :]
    n = 0
    for dd, dw in T9:
        s = d + dd - dw
        xm = (j >= s) & (d + dd - 1 >= 0) & (d + dd - 1 <= nd - 1)
        n += int(xm.sum()) + int((xm & (j <= w - dw)).sum())
    return n


# -- the counts ---------------------------------------------------------------

def conv_work(x_shape, cout, eb=4):
    """Kernel A (and H): a 3x3x3 conv of a (B, D, Cin, H, W) volume, or its
    dX. Multiply-adds that read an in-range voxel; bytes: input, weights,
    affine read once, output written once."""
    b, d, cin, h, w = x_shape
    flops = 2.0 * b * _taps(d) * _taps(h) * _taps(w) * cin * cout
    nbytes = (eb * b * d * h * w * (cin + cout)
              + 4.0 * (27 * cin * cout + 2 * cout))
    return flops, nbytes


def cvstem_work(x_shape, nd, cout, eb=4):
    """Kernel B: the stem's conv on the cost volume of two (B, C, H, W)
    feature maps, structural zeros excluded."""
    b, c, h, w = x_shape
    flops = 2.0 * b * _stem_products(nd, w) * _taps(h) * 2 * c * cout
    nbytes = (eb * (2 * b * c * h * w + b * nd * cout * h * w)
              + 4.0 * (27 * 2 * c * cout + 2 * cout))
    return flops, nbytes


def disp_work(x_shape, maxdisp, scale):
    """Kernel C: the soft-argmin head on a (B, D, h, w) cost."""
    b, d, h, w = x_shape
    pixels = b * h * scale * w * scale
    flops = pixels * (9.0 * d + 8.0 * maxdisp)
    nbytes = 4.0 * (b * d * h * w + pixels)
    return flops, nbytes


def dw_work(x_shape, cout, eb=4):
    """Kernel D: a 3x3x3 conv's weight gradient."""
    b, d, cin, h, w = x_shape
    flops = 2.0 * b * _taps(d) * _taps(h) * _taps(w) * cin * cout
    nbytes = eb * b * d * h * w * (cin + cout) + 4.0 * 27 * cin * cout
    return flops, nbytes


def cvstem_dxy_work(dz_shape, c2, nd, eb=4):
    """Kernel E: the stem's gradient into the two feature maps."""
    b, _, cout, h, w = dz_shape
    flops = 2.0 * b * _stem_products(nd, w, dv_needed=True) * _taps(h) \
        * c2 * cout
    nbytes = (eb * (b * nd * cout * h * w + b * c2 * h * w)
              + 4.0 * 27 * c2 * cout)
    return flops, nbytes


def cvstem_dw_work(x_shape, dz_shape, nd, eb=4):
    """Kernel F: the stem's weight gradient."""
    b, c, h, w = x_shape
    cout = dz_shape[2]
    flops = 2.0 * b * _stem_products(nd, w) * _taps(h) * 2 * c * cout
    nbytes = (eb * (2 * b * c * h * w + b * nd * cout * h * w)
              + 4.0 * 27 * 2 * c * cout)
    return flops, nbytes


def disp_bwd_work(x_shape, maxdisp, scale):
    """Kernel G: the head's gradient into its (B, D, h, w) cost."""
    b, d, h, w = x_shape
    kh, kw = (int(np.count_nonzero(interp_matrix_np(n, n * scale, False),
                                   axis=0).max()) for n in (h, w))
    pixels = b * h * scale * w * scale
    flops = (pixels * (9.0 * d + 21.0 * maxdisp)
             + b * d * h * w * kh * (2.0 * kw + 2.0))
    nbytes = 4.0 * (2 * b * d * h * w + pixels)
    return flops, nbytes


def resize_work(x_shape, d2, h2, w2, align_corners=True, transposed=False,
                eb=4):
    """Kernel I: the separable resize of a (B, D, C, H, W) volume."""
    b, d, c, h, w = x_shape
    nnz = []
    for n, n2 in ((d, d2), (h, h2), (w, w2)):
        if n == n2:
            nnz.append(0)
            continue
        _, wts = taps_np(*((n2, n) if transposed else (n, n2)),
                         align_corners, transposed)
        nnz.append(int(np.count_nonzero(wts)))
    flops = 2.0 * (nnz[0] * b * c * h * w + nnz[1] * b * d2 * c * w
                   + nnz[2] * b * d2 * c * h2)
    nbytes = float(eb) * (b * d * c * h * w + b * d2 * c * h2 * w2)
    return flops, nbytes


def shear_work(px_shape, nd, relu=False, eb=4):
    """Kernel J: the shear assembly of the stem from its tap maps."""
    b, _, co, h, w = px_shape
    flops = b * co * h * (_shear_terms(nd, w) + (3.0 if relu else 2.0) * nd * w)
    nbytes = (eb * (2 * b * 9 * co * h * w + b * nd * co * h * w)
              + 4.0 * 2 * co)
    return flops, nbytes


def shear_adj_work(dz_shape, nd, eb=4):
    """Kernel K: the shear assembly taken back."""
    b, _, co, h, w = dz_shape
    flops = float(b * co * h * _shear_terms(nd, w))
    nbytes = eb * b * nd * co * h * w + 4.0 * 2 * b * 9 * co * h * w
    return flops, nbytes
