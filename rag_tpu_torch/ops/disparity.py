"""Kernel C: the fused soft-argmin disparity head.

Replaces the TPU kernel rag_tpu/ops/pallas_kernels.py::_disp_pallas_raw
(kernel body _disp_kernel); its plain version is the reference's
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
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.resize import _interp_matrix_np, interp_matrix


def soft_argmin_disparity(x: torch.Tensor, maxdisp: int, scale: int = 3) -> torch.Tensor:
    """Plain PyTorch version: x (B, D, h, w) -> (B, scale*h, scale*w).

    Takes the squeezed cost as _disp_reference and the kernel do; the
    reference's soft_argmin_disparity takes it as (B, D, h, w, 1)."""
    b, d, h, w = x.shape
    dev = x.device
    u_d = interp_matrix(d, maxdisp, False, dev)
    u_h = interp_matrix(h, h * scale, False, dev)
    u_w = interp_matrix(w, w * scale, False, dev)
    y = torch.einsum("Dd,bdhw->bDhw", u_d, x)
    y = torch.einsum("Hh,bDhw->bDHw", u_h, y)
    y = torch.einsum("Ww,bDHw->bDHW", u_w, y)
    p = torch.softmax(-y, dim=1)
    dvals = torch.arange(maxdisp, dtype=x.dtype, device=dev)
    return torch.einsum("d,bdHW->bHW", dvals, p)


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


def fused_soft_argmin(x: torch.Tensor, maxdisp: int = 192, scale: int = 3) -> torch.Tensor:
    """Fused head: x (B, D, h, w) f32 -> (B, scale*h, scale*w). Launches
    kernel C for CUDA tensors; the plain version runs only for CPU tensors."""
    if not x.is_cuda:
        return soft_argmin_disparity(x, maxdisp, scale)
    b, d, h, w = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fused_soft_argmin: unsupported x {tuple(x.shape)} "
                         f"{x.dtype} contiguous={x.is_contiguous()}")
    tab_i, tab_w = tap_tables(d, h, w, maxdisp, scale, x.device)
    ho, wo = h * scale, w * scale
    out = torch.empty((b, ho, wo), device=x.device, dtype=torch.float32)
    rc = cuda_lib.lib().rag_soft_argmin(
        x.data_ptr(), tab_i.data_ptr(), tab_w.data_ptr(), out.data_ptr(),
        b, d, h, w, maxdisp, ho, wo, cuda_lib.stream_ptr(x))
    fused_soft_argmin.launches += 1
    cuda_lib.check(rc, "fused_soft_argmin")
    return out


fused_soft_argmin.launches = 0
