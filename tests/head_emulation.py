"""numpy forms of kernels C and G (rag_tpu_torch/csrc/disp_head.cu), in the
kernels' order of arithmetic, for the CPU tests.

Both instances share one order: the H/W blend of each cost level
(``fmaf(a0, fmaf(b0, x00, b1 * x01), a1 * fmaf(b0, x10, b1 * x11))``), the
minimum over the D blended source levels, then the levels k in ascending
order, each y_k = fmaf(w0, s[i0], w1 * s[i0 + 1]) (a level with one tap has
w1 = 0, which leaves y_k = s[i0]; the periodic instance writes it as
s[i0]) and e_k = 2^fmaf(-y_k, log2 e, smin * log2 e), summed into se and
sum k e_k. Kernel G walks the levels again, dy_k = e_k * fmaf(k, qk, q0)
with qk = -g / se and q0 = out * (g / se), folds dy into the D
accumulators (fmaf, ascending k), then sums each source column's five
output columns (window weights of ``fold_taps_np``, ascending) over the
warp strips of ``head_bwd_plan``, then each source row's five output rows.

``dtype`` float32 rounds every fma once (computed in float64, then
rounded) and uses numpy's exp2 where the kernel uses the SFU's ex2;
float64 runs the same order in float64.
"""

import numpy as np
import torch

from rag_tpu_torch.ops.disparity import (
    _taps_np,
    fold_taps_np,
    head_bwd_plan,
    tap_tables,
)

LOG2E = 1.4426950408889634


def _fma(a, b, c, dt):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(dt)


def _levels(x, maxdisp, dt):
    """The blended source levels s (B, D, Ho, Wo), the D tap table and the
    softmin sums in the kernels' order: (s, idx, wts, sl, se, sde)."""
    b, d, h, w = x.shape
    x = x.astype(dt)
    idx, wts = (t.numpy() for t in tap_tables(d, h, w, maxdisp, 3,
                                             torch.device("cpu")))
    wts = wts.astype(dt)
    ho, wo = 3 * h, 3 * w
    hr = slice(maxdisp, maxdisp + ho)
    wr = slice(maxdisp + ho, maxdisp + ho + wo)
    h0, h1, a0, a1 = idx[hr, 0], idx[hr, 1], wts[hr, 0], wts[hr, 1]
    w0, w1, b0, b1 = idx[wr, 0], idx[wr, 1], wts[wr, 0], wts[wr, 1]

    def row(hi):
        xr = x[:, :, hi]                                   # (B, D, Ho, w)
        return _fma(b0, xr[..., w0], (b1 * xr[..., w1]).astype(dt), dt)

    s = _fma(a0[:, None], row(h0),
             (a1[:, None] * row(h1)).astype(dt), dt)       # (B, D, Ho, Wo)
    log2e = dt(LOG2E)
    sl = (s.min(axis=1) * log2e).astype(dt)
    se = np.zeros(s[:, 0].shape, dt)
    sde = np.zeros_like(se)
    for k, y in _walk(s, idx[:maxdisp], wts[:maxdisp], dt):
        e = np.exp2(_fma(-y, log2e, sl, dt)).astype(dt)
        se = (se + e).astype(dt)
        sde = _fma(dt(k), e, sde, dt)
    return s, idx[:maxdisp], wts[:maxdisp], sl, se, sde


def _walk(s, di, dw, dt):
    """(k, y_k) in ascending k: y_k = fmaf(w0, s[i0], w1 * s[i0 + 1])."""
    d = s.shape[1]
    for k in range(len(di)):
        i0 = di[k, 0]
        hi = s[:, min(i0 + 1, d - 1)]
        yield k, _fma(dw[k, 0], s[:, i0], (dw[k, 1] * hi).astype(dt), dt)


def emulate_head(x, maxdisp, dtype=np.float32):
    """Kernel C: x (B, D, h, w) -> (B, 3h, 3w)."""
    _, _, _, _, se, sde = _levels(x, maxdisp, dtype)
    return (sde / se).astype(dtype)


def emulate_head_bwd(x, g, maxdisp, dtype=np.float32):
    """Kernel G: x (B, D, h, w), g (B, 3h, 3w) -> dx (B, D, h, w)."""
    dt = dtype
    b, d, h, w = x.shape
    s, di, dw, sl, se, sde = _levels(x, maxdisp, dt)
    g = g.astype(dt)
    gse = (g / se).astype(dt)
    qk = (-gse).astype(dt)
    q0 = ((sde / se).astype(dt) * gse).astype(dt)
    log2e = dt(LOG2E)
    acc = np.zeros(s.shape, dt)                            # (B, D, Ho, Wo)
    for k, y in _walk(s, di, dw, dt):
        e = np.exp2(_fma(-y, log2e, sl, dt)).astype(dt)
        dy = (e * _fma(dt(k), qk, q0, dt)).astype(dt)
        i0 = di[k, 0]
        acc[:, i0] = _fma(dw[k, 0], dy, acc[:, i0], dt)
        if i0 + 1 < d:
            acc[:, i0 + 1] = _fma(dw[k, 1], dy, acc[:, i0 + 1], dt)
    # W fold, strip by strip: source column q0 + j from lanes 3j .. 3j+4,
    # i.e. output columns 3q - 1 + i (zero outside the map)
    plan = head_bwd_plan(b, d, h, w, maxdisp)
    fw, fh = fold_taps_np(w).astype(dt), fold_taps_np(h).astype(dt)
    pad = np.zeros(acc.shape[:3] + (3 * w + 2,), dt)
    pad[..., 1:3 * w + 1] = acc
    ew = np.zeros(acc.shape[:3] + (w,), dt)                # (B, D, Ho, w)
    for strip in range(plan.strips):
        for j in range(min(plan.strip, w - strip * plan.strip)):
            q = strip * plan.strip + j
            v = np.zeros(acc.shape[:3], dt)
            for i in range(5):
                v = _fma(fw[q, i], pad[..., 3 * q + i], v, dt)
            ew[..., q] = v
    # H fold: source row hi from output rows 3hi - 1 + i inside the map
    dx = np.zeros((b, d, h, w), dt)
    for hi in range(h):
        v = np.zeros((b, d, w), dt)
        for i in range(5):
            o = 3 * hi - 1 + i
            if 0 <= o < 3 * h:
                v = _fma(fh[hi, i], ew[:, :, o], v, dt)
        dx[:, :, hi] = v
    return dx


def general_walk_ok(d, maxdisp):
    """The general instance's walk preconditions on the D tap table: the
    lower tap starts at 0, ends at d - 1 and advances by at most one a
    level; a row's second tap is i0 + 1 or carries weight 0."""
    idx, wts = _taps_np(d, maxdisp)
    steps = np.diff(idx[:, 0])
    return (idx[0, 0] == 0 and idx[-1, 0] == d - 1
            and bool(((steps == 0) | (steps == 1)).all())
            and bool(((idx[:, 1] == idx[:, 0] + 1) | (wts[:, 1] == 0)).all()))
