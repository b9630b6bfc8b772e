"""The fused soft-argmin disparity head: kernel C (forward) and kernel G
(backward), with ``fused_soft_argmin`` differentiable.

Kernel C, ``soft_argmin_fwd``, replaces the TPU kernel
rag_tpu/ops/pallas_kernels.py::_disp_pallas_raw (kernel body
_disp_kernel); its plain version is the reference's
rag_tpu/ops/disparity.py::soft_argmin_disparity (== _disp_reference).
Kernel G, ``soft_argmin_bwd``: ``dy_k = -p_k (k - out) g`` pulled back
through the transposed D, H and W interpolations; it replaces
rag_tpu/ops/pallas_kernels.py::_disp_bwd_pallas (body _disp_bwd_kernel),
which engages only for h % 8 == 0 and h > 8; this kernel takes every h at
scale 3. CUDA source of both: rag_tpu_torch/csrc/disp_head.cu.

The head trilinearly upsamples the (B, D, h, w) matching cost to
(maxdisp, scale*h, scale*w) with align_corners=False, softmins over
disparity and takes the expectation sum(d * p(d)).

Bound on the H100: operations. C does ~1 GFLOP at the eval geometry
(0.0145 ms at the float32 peak) against 13 MB in and 1.8 MB out; G ~1.5
GFLOP at the train shape (B=4, D=64, 64x128 -> 192x384; 0.022 ms) against
6.7 MB in and 8.4 MB out. The plain version's cost is the upsampled volume
it stores several times (354 MB each at the eval geometry). Every output
pixel needs maxdisp exponentials (G twice), ~0.02 ms for C at the eval
geometry at the SFU's 16 a clock per SM; in practice both kernels are bound
by instruction issue, so the design removes every instruction a level does
not need.

What the design does about it. One thread per output pixel blends its four
H/W source taps for every cost level. At maxdisp = 3*D and scale 3 the D
axis is periodic with period 3 (``d_residues_np``): the periodic instance
(D in ``HEAD_INSTANCES``, unrolled) keeps the D blended levels in
registers, walks them by source level with four per-residue weights, takes
the max of -y over the D source levels (the same max up to rounding: every
level is a convex combination of two neighbours) and sums e and k*e in one
walk. Kernel C's block is 3 output rows (which read the same 3 source
rows) x 32 columns; its periodic instance stages the block's source tile
(``tile_origin``, D x 3 x 14 floats) in shared memory and blends from it
at fixed offsets. Other shapes run the general instance of the same
kernel, from the per-level two-tap table (``tap_tables``). G recomputes the
softmin, walks the levels once more (exponentials recomputed) folding dy
through the D taps in registers, then a warp folds W over its strip of
source columns through shared memory (``head_bwd_plan``; window weights
``fold_taps_np``) into a (B, D, scale*h, w) workspace that stays in L2
(25.2 MB at the train shape), and a second pass folds H. Every weight is
copied from the float32 matrices the plain version contracts with; sums run
in a fixed order, so two launches of G give the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.conv3d import check_f32, needs_grad
from rag_tpu_torch.ops.resize import _interp_matrix_np, interp_matrix

# D of the periodic instances compiled in csrc/disp_head.cu (the main
# path's 64; 8 keeps the periodic walk in the small checks)
HEAD_INSTANCES = (8, 64)
HEAD_LANES = 32
HEAD_TILE_ROWS = 3   # a block's output rows 3j .. 3j+2 (kernels C and G)
HEAD_TILE_COLS = 32  # kernel C: output columns of a block's rows
HEAD_SRC_COLS = 14   # source columns a periodic instance stages
HEAD_STRIP = 10      # source columns of a warp's strip in G's pass 1
HEAD_FOLD_WARPS = 4  # G's pass-1 block: strips of one output row
HEAD_PITCH = HEAD_LANES + 1   # G's fold buffer row
HEAD_GATHER_THREADS = 128     # G's pass 2


def _softmin(x: torch.Tensor, maxdisp: int, scale: int):
    """The head's softmin p (B, maxdisp, scale*h, scale*w), its levels and
    the three interpolation matrices, in x's dtype."""
    b, d, h, w = x.shape
    u_d, u_h, u_w = (interp_matrix(n, m, False, x.device).to(x.dtype)
                     for n, m in ((d, maxdisp), (h, h * scale), (w, w * scale)))
    y = torch.einsum("Dd,bdhw->bDhw", u_d, x)
    y = torch.einsum("Hh,bDhw->bDHw", u_h, y)
    y = torch.einsum("Ww,bDHw->bDHW", u_w, y)
    dvals = torch.arange(maxdisp, dtype=x.dtype, device=x.device)
    return torch.softmax(-y, dim=1), dvals, (u_d, u_h, u_w)


def soft_argmin_disparity(x: torch.Tensor, maxdisp: int, scale: int = 3) -> torch.Tensor:
    """Plain PyTorch version of kernel C: x (B, D, h, w) -> (B, scale*h,
    scale*w).

    Takes the squeezed cost as _disp_reference and the kernel do; the
    reference's soft_argmin_disparity takes it as (B, D, h, w, 1)."""
    p, dvals, _ = _softmin(x, maxdisp, scale)
    return torch.einsum("d,bdHW->bHW", dvals, p)


def soft_argmin_bwd_plain(x: torch.Tensor, g: torch.Tensor, maxdisp: int,
                          scale: int = 3) -> torch.Tensor:
    """Plain PyTorch version of kernel G: the analytic head backward of
    rag_tpu/ops/pallas_kernels.py::_fsa_bwd. g (B, scale*h, scale*w) ->
    dx (B, D, h, w)."""
    p, dvals, (u_d, u_h, u_w) = _softmin(x, maxdisp, scale)
    out = torch.einsum("d,bdHW->bHW", dvals, p)
    dy = -p * (dvals[None, :, None, None] - out[:, None]) * g[:, None]
    dx = torch.einsum("Dd,bDHW->bdHW", u_d, dy)
    dx = torch.einsum("Hh,bdHW->bdhW", u_h, dx)
    return torch.einsum("Ww,bdhW->bdhw", u_w, dx)


def _taps_np(n_in: int, n_out: int):
    """Two (index, weight) taps per row of the align_corners=False matrix:
    (n_out, 2) int32 and (n_out, 2) float32, weights copied from it. A row
    with one nonzero repeats its index with weight 0."""
    m = _interp_matrix_np(n_in, n_out, False)
    idx = np.zeros((n_out, 2), np.int32)
    wts = np.zeros((n_out, 2), np.float32)
    for r in range(n_out):
        nz = np.nonzero(m[r])[0]
        assert 1 <= len(nz) <= 2, (n_in, n_out, r)
        idx[r, :] = nz[0]
        idx[r, :len(nz)] = nz
        wts[r, :len(nz)] = m[r, nz]
    return idx, wts


@functools.lru_cache(maxsize=16)
def tap_tables(d: int, h: int, w: int, maxdisp: int, scale: int,
               device: torch.device):
    """Device tap tables for the D, H and W axes, stacked in that order."""
    parts = [_taps_np(d, maxdisp), _taps_np(h, h * scale), _taps_np(w, w * scale)]
    idx = np.concatenate([p[0] for p in parts])
    wts = np.concatenate([p[1] for p in parts])
    return (torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device))


def periodic_matrix_np(d: int, res: np.ndarray) -> np.ndarray:
    """The (3d, d) D matrix the periodic instance applies: level 3m+1 reads
    m with weight 1, level 3m reads (m-1, m) with (res[0], res[1]), level
    3m+2 reads (m, m+1) with (res[2], res[3]); levels 0 and 3d-1 read 0 and
    d-1 alone with weight 1."""
    m = np.zeros((3 * d, d), np.float32)
    for s in range(d):
        m[3 * s + 1, s] = 1.0
        if s == 0:
            m[0, 0] = 1.0
        else:
            m[3 * s, s - 1], m[3 * s, s] = res[0], res[1]
        if s == d - 1:
            m[3 * s + 2, s] = 1.0
        else:
            m[3 * s + 2, s], m[3 * s + 2, s + 1] = res[2], res[3]
    return m


@functools.lru_cache(maxsize=64)
def d_residues_np(d: int, maxdisp: int) -> Optional[np.ndarray]:
    """The periodic instance's four per-residue D weights (c0, c1, c2, c3),
    float32 entries of the matrix the plain version contracts with, or
    None where maxdisp != 3d or they do not rebuild that matrix exactly."""
    if maxdisp != 3 * d or d < 2:
        return None
    m = _interp_matrix_np(d, maxdisp, False)
    res = np.array([m[3, 0], m[3, 1], m[2, 0], m[2, 1]], np.float32)
    return res if np.array_equal(periodic_matrix_np(d, res), m) else None


@functools.lru_cache(maxsize=64)
def head_instance(d: int, maxdisp: int) -> int:
    """The kernels' instance for (d, maxdisp): d for the periodic instance
    (d compiled and the residues rebuild the matrix), 0 for the general
    one. Raises where maxdisp < d: the general walk's lower tap must
    advance by at most one a level."""
    if maxdisp < d:
        raise ValueError(f"disparity head: maxdisp {maxdisp} < D {d} (the "
                         "kernels upsample the disparity axis)")
    if d in HEAD_INSTANCES and d_residues_np(d, maxdisp) is not None:
        return d
    return 0


@functools.lru_cache(maxsize=16)
def residue_table(d: int, maxdisp: int, device: torch.device) -> torch.Tensor:
    """(4,) device float32: the periodic instance's residue weights (zeros
    for the general instance, which does not read them)."""
    res = d_residues_np(d, maxdisp)
    return torch.from_numpy(np.zeros(4, np.float32) if res is None
                            else res.copy()).to(device)


def fold_taps_np(n_in: int, scale: int = 3) -> np.ndarray:
    """(n_in, 2*scale - 1) float32 window weights of the transposed
    align_corners=False matrix for an odd scale: row q holds
    U[scale*q - (scale-1)/2 + i, q] (0 outside the output range), which are
    all of column q's nonzeros (asserted)."""
    assert scale % 2 == 1, scale
    m = _interp_matrix_np(n_in, n_in * scale, False)
    k, lo = 2 * scale - 1, (scale - 1) // 2
    out = np.zeros((n_in, k), np.float32)
    for q in range(n_in):
        o = scale * q - lo + np.arange(k)
        ok = (o >= 0) & (o < n_in * scale)
        out[q, ok] = m[o[ok], q]
        assert np.count_nonzero(out[q]) == np.count_nonzero(m[:, q]), q
    return out


@functools.lru_cache(maxsize=16)
def fold_tables(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(w + h, 5) device float32: kernel G's W fold windows, then its
    H fold windows (scale 3)."""
    return torch.from_numpy(np.concatenate([fold_taps_np(w), fold_taps_np(h)])
                            ).to(device)


class HeadPlan(NamedTuple):
    """Kernel C's launch (csrc/disp_head.cu::rag_soft_argmin)."""
    instance: int     # D of the periodic instance, 0 = general
    threads: int      # per block: HEAD_TILE_ROWS x HEAD_TILE_COLS pixels
    blocks: int


class HeadBwdPlan(NamedTuple):
    """Kernel G's blocking (csrc/disp_head.cu::rag_soft_argmin_bwd)."""
    instance: int     # D of the periodic instance, 0 = general
    strip: int        # source columns a warp's strip covers
    lanes: int        # output columns a strip computes: 3 * strip + 2
    strips: int       # strips per output row
    warps: int        # per block of pass 1
    tasks: int        # warps of pass 1: (b, output row, strip) in order
    fold_blocks: int  # blocks of pass 1
    gather_blocks: int  # blocks of pass 2, one thread an input voxel
    workspace: int    # floats of e_w, (b, d, 3h, w)
    smem: int         # bytes of pass 1's fold buffers per block


@functools.lru_cache(maxsize=64)
def head_plan(b: int, d: int, h: int, w: int, maxdisp: int,
              scale: int = 3) -> HeadPlan:
    """Kernel C's launch: blocks of 3 output rows x 32 columns, the
    periodic instance at scale 3 where ``head_instance`` has one."""
    instance = head_instance(d, maxdisp) if scale == 3 else 0
    blocks = (b * -(-h * scale // HEAD_TILE_ROWS)
              * -(-w * scale // HEAD_TILE_COLS))
    return HeadPlan(instance, HEAD_TILE_ROWS * HEAD_TILE_COLS, blocks)


@functools.lru_cache(maxsize=64)
def head_bwd_plan(b: int, d: int, h: int, w: int, maxdisp: int) -> HeadBwdPlan:
    """Kernel G's blocking at scale 3: a warp owns one output row's strip of
    HEAD_STRIP source columns q0 .. and computes output columns
    3*q0 - 1 + lane (lane < 3 * ncols + 2; the one-column halo each side
    is recomputed by the neighbouring strip), then folds W over the strip;
    HEAD_FOLD_WARPS consecutive tasks a block. Pass 2 folds H, one thread
    an input voxel."""
    strips = -(-w // HEAD_STRIP)
    lanes = 3 * HEAD_STRIP + 2
    assert lanes <= HEAD_LANES
    tasks = b * 3 * h * strips
    return HeadBwdPlan(head_instance(d, maxdisp), HEAD_STRIP, lanes, strips,
                       HEAD_FOLD_WARPS, tasks, -(-tasks // HEAD_FOLD_WARPS),
                       -(-(b * d * h * w) // HEAD_GATHER_THREADS),
                       b * d * 3 * h * w,
                       4 * HEAD_FOLD_WARPS * d * HEAD_PITCH)


def tile_origin(j: int, t: int):
    """The source (row, column) at which the staged tile of kernel C's
    block (output rows 3j .., columns 32t ..) starts in the periodic
    instance; the tile holds HEAD_TILE_ROWS rows x HEAD_SRC_COLS columns."""
    return j - 1, t * HEAD_TILE_COLS // 3 - 1


def soft_argmin_fwd(x: torch.Tensor, maxdisp: int = 192, scale: int = 3) -> torch.Tensor:
    """Kernel C, no autograd: x (B, D, h, w) f32 -> (B, scale*h, scale*w)."""
    if not x.is_cuda:
        return soft_argmin_disparity(x, maxdisp, scale)
    b, d, h, w = x.shape
    check_f32("soft_argmin_fwd", x)
    plan = head_plan(b, d, h, w, maxdisp, scale)
    tab_i, tab_w = tap_tables(d, h, w, maxdisp, scale, x.device)
    res = residue_table(d, maxdisp, x.device)
    ho, wo = h * scale, w * scale
    out = torch.empty((b, ho, wo), device=x.device, dtype=torch.float32)
    rc = cuda_lib.lib().rag_soft_argmin(
        x.data_ptr(), tab_i.data_ptr(), tab_w.data_ptr(), res.data_ptr(),
        out.data_ptr(), b, d, h, w, maxdisp, ho, wo, plan.instance,
        cuda_lib.stream_ptr(x))
    soft_argmin_fwd.launches += 1
    cuda_lib.check(rc, "soft_argmin_fwd")
    return out


soft_argmin_fwd.launches = 0


def launch_head_bwd(x: torch.Tensor, g: torch.Tensor, maxdisp: int,
                    plan: HeadBwdPlan, passes: int = 3) -> torch.Tensor:
    """Launch kernel G on the current stream with a given plan: pass 1 (bit
    1 of ``passes``: the D and W folds into the workspace) and pass 2 (bit
    2: the H fold into dx). Counts one launch on ``soft_argmin_bwd``. One
    pass alone is for timing: pass 2 alone reads a workspace left
    unwritten."""
    b, d, h, w = x.shape
    tab_i, tab_w = tap_tables(d, h, w, maxdisp, 3, x.device)
    res = residue_table(d, maxdisp, x.device)
    fold = fold_tables(h, w, x.device)
    ew = torch.empty(plan.workspace, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    rc = cuda_lib.lib().rag_soft_argmin_bwd(
        x.data_ptr(), g.data_ptr(), tab_i.data_ptr(), tab_w.data_ptr(),
        res.data_ptr(), fold.data_ptr(), ew.data_ptr(), dx.data_ptr(),
        b, d, h, w, maxdisp, 3 * h, 3 * w, plan.instance, passes,
        cuda_lib.stream_ptr(x))
    soft_argmin_bwd.launches += 1
    cuda_lib.check(rc, "soft_argmin_bwd")
    return dx


def soft_argmin_bwd(x: torch.Tensor, g: torch.Tensor, maxdisp: int = 192,
                    scale: int = 3) -> torch.Tensor:
    """Kernel G, no autograd: the head's input gradient. x (B, D, h, w),
    g (B, scale*h, scale*w) f32 -> dx (B, D, h, w). The kernel folds the
    windows of a x3 upsample: on the card scale must be 3."""
    if not x.is_cuda:
        return soft_argmin_bwd_plain(x, g, maxdisp, scale)
    b, d, h, w = x.shape
    if g.shape != (b, h * scale, w * scale) or scale != 3:
        raise ValueError(f"soft_argmin_bwd: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, scale {scale} (the kernel "
                         "takes scale 3)")
    check_f32("soft_argmin_bwd", x, g)
    return launch_head_bwd(x, g, maxdisp, head_bwd_plan(b, d, h, w, maxdisp))


soft_argmin_bwd.launches = 0


class _FusedSoftArgmin(torch.autograd.Function):
    """rag_tpu/ops/pallas_kernels.py::fused_soft_argmin's VJP: C forward,
    G backward."""

    @staticmethod
    def forward(ctx, x, maxdisp, scale):
        ctx.save_for_backward(x)
        ctx.maxdisp, ctx.scale = maxdisp, scale
        return soft_argmin_fwd(x, maxdisp, scale)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (soft_argmin_bwd(x, g.contiguous(), ctx.maxdisp, ctx.scale),
                None, None)


def fused_soft_argmin(x: torch.Tensor, maxdisp: int = 192, scale: int = 3) -> torch.Tensor:
    """Fused head: x (B, D, h, w) f32 -> (B, scale*h, scale*w),
    differentiable in x."""
    if needs_grad(x):
        return _FusedSoftArgmin.apply(x, maxdisp, scale)
    return soft_argmin_fwd(x, maxdisp, scale)
