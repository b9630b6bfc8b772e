"""The fused soft-argmin disparity head: kernel C (forward) and kernel G
(backward), with ``fused_soft_argmin`` differentiable.

Kernel C, ``soft_argmin_fwd``, replaces the TPU kernel
rag_tpu/ops/pallas_kernels.py::_disp_pallas_raw (kernel body
_disp_kernel); its plain version is the reference's
rag_tpu/ops/disparity.py::soft_argmin_disparity (== _disp_reference).
CUDA source: rag_tpu_torch/csrc/disp_head.cu.

The head trilinearly upsamples the (B, D, h, w) matching cost to
(maxdisp, scale*h, scale*w) with align_corners=False, softmins over
disparity and takes the expectation sum(d * p(d)).

Bound on the H100: operations, ~1 GFLOP at the eval geometry (0.015 ms
at the fp32 peak) against 13 MB in and 1.8 MB out (0.005 ms); the plain
version's cost is the (B, 192, 480, 960) upsampled volume it stores
several times (354 MB each). The kernel never stores it: one thread per output pixel blends its
H/W taps for each cost level into shared memory, then reduces softmin and
expectation over the 192 levels in registers. The interpolation weights
come from the same float32 matrices the plain version contracts with.

Kernel G, ``soft_argmin_bwd``: ``dy_k = -p_k (k - out) g`` pulled back
through the transposed D, H and W interpolations. Replaces
rag_tpu/ops/pallas_kernels.py::_disp_bwd_pallas (body _disp_bwd_kernel),
which engages only for h % 8 == 0 and h > 8; this kernel takes every h.
CUDA source: rag_tpu_torch/csrc/disp_head.cu. Bound: operations, the
forward's work once more plus the D fold (~0.4 GFLOP at the train shape,
B=4, D=64, 64x128 -> 192x384, against 6.7 MB in and 8.4 MB out). Two
deterministic passes, no atomics: one thread per output pixel recomputes
the 192 logits as kernel C does and folds dy through the D taps into a
(B, D, scale*h, scale*w) workspace (75.5 MB at the train shape, allocated
by the wrapper); then one thread per input voxel gathers that workspace
over the output rows and columns whose H/W taps touch it, from inverse tap
lists built on the host out of the same float32 matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.conv3d import check_f32, needs_grad
from rag_tpu_torch.ops.resize import _interp_matrix_np, interp_matrix


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
    (n_out, 2) int32 and (n_out, 2) float32, weights copied from it."""
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


def _inverse_taps_np(n_in: int, n_out: int):
    """For each input index, the output indices whose align_corners=False
    taps read it and their weights: (n_in, K) int32 and float32, K the
    most any input has, padded with weight 0 (columns of the same float32
    matrix the forward taps come from)."""
    m = _interp_matrix_np(n_in, n_out, False)
    k = int(max(np.count_nonzero(m[:, i]) for i in range(n_in)))
    idx = np.zeros((n_in, k), np.int32)
    wts = np.zeros((n_in, k), np.float32)
    for i in range(n_in):
        nz = np.nonzero(m[:, i])[0]
        idx[i, :len(nz)] = nz
        wts[i, :len(nz)] = m[nz, i]
    return idx, wts


@functools.lru_cache(maxsize=16)
def inverse_tap_tables(h: int, w: int, scale: int, device: torch.device):
    """Device inverse tap tables of the H and W axes:
    (idx_h, wts_h, idx_w, wts_w)."""
    out = []
    for n in (h, w):
        idx, wts = _inverse_taps_np(n, n * scale)
        out += [torch.from_numpy(idx).to(device),
                torch.from_numpy(wts).to(device)]
    return tuple(out)


def soft_argmin_fwd(x: torch.Tensor, maxdisp: int = 192, scale: int = 3) -> torch.Tensor:
    """Kernel C, no autograd: x (B, D, h, w) f32 -> (B, scale*h, scale*w)."""
    if not x.is_cuda:
        return soft_argmin_disparity(x, maxdisp, scale)
    b, d, h, w = x.shape
    check_f32("soft_argmin_fwd", x)
    tab_i, tab_w = tap_tables(d, h, w, maxdisp, scale, x.device)
    ho, wo = h * scale, w * scale
    out = torch.empty((b, ho, wo), device=x.device, dtype=torch.float32)
    rc = cuda_lib.lib().rag_soft_argmin(
        x.data_ptr(), tab_i.data_ptr(), tab_w.data_ptr(), out.data_ptr(),
        b, d, h, w, maxdisp, ho, wo, cuda_lib.stream_ptr(x))
    soft_argmin_fwd.launches += 1
    cuda_lib.check(rc, "soft_argmin_fwd")
    return out


soft_argmin_fwd.launches = 0


def soft_argmin_bwd(x: torch.Tensor, g: torch.Tensor, maxdisp: int = 192,
                    scale: int = 3) -> torch.Tensor:
    """Kernel G, no autograd: the head's input gradient. x (B, D, h, w),
    g (B, scale*h, scale*w) f32 -> dx (B, D, h, w)."""
    if not x.is_cuda:
        return soft_argmin_bwd_plain(x, g, maxdisp, scale)
    b, d, h, w = x.shape
    ho, wo = h * scale, w * scale
    if g.shape != (b, ho, wo):
        raise ValueError(f"soft_argmin_bwd: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, scale {scale}")
    check_f32("soft_argmin_bwd", x, g)
    tab_i, tab_w = tap_tables(d, h, w, maxdisp, scale, x.device)
    inv = inverse_tap_tables(h, w, scale, x.device)
    e = torch.empty((b, d, ho, wo), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    rc = cuda_lib.lib().rag_soft_argmin_bwd(
        x.data_ptr(), g.data_ptr(), tab_i.data_ptr(), tab_w.data_ptr(),
        *[t.data_ptr() for t in inv], e.data_ptr(), dx.data_ptr(),
        b, d, h, w, maxdisp, ho, wo, inv[0].shape[1], inv[2].shape[1],
        cuda_lib.stream_ptr(x))
    soft_argmin_bwd.launches += 1
    cuda_lib.check(rc, "soft_argmin_bwd")
    return dx


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
