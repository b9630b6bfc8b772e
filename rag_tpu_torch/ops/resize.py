"""Separable linear interpolation (bilinear / trilinear) as matrix products,
and kernel I, the channel-first trilinear resize from tap tables.

Counterpart of rag_tpu/ops/resize.py and rag_tpu/ops/pallas_resize.py. Each
axis is resized by a dense (n_out, n_in) interpolation matrix built in
float64 and cast to float32, exactly as the reference builds it, so both
packages contract with bit-identical weights.

``resize_cf`` takes the matrix products by default. Where
``KernelVariants.resize_kernel`` is set it runs kernel I,
``resize_taps_cf``, forward and backward: the backward is the same kernel
on the transposed tap tables, as rag_tpu/ops/pallas_resize.py::_resize_bwd
does. Kernel I replaces rag_tpu/ops/pallas_resize.py::_resize_cf_pallas
(body _resize_kernel). CUDA source: rag_tpu_torch/csrc/resize_taps.cu.
Bound on the H100: bytes (at most 2*27 FLOP per output written; the head's
last up-resize at the eval geometry reads 19.7 MB and writes 157 MB,
0.053 ms). One thread per output element gathers its taps on all three
axes; the TPU kernel blends D by taps and contracts H and W with dense
matrices, which computes the same function with the float32 sums in
another order. Its plain version is the matrix form, which stays the
default path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.conv3d import check_f32, needs_grad
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants


def scale_dimension(dim: int, scale: float) -> int:
    """Target-size rule for intra-cell down/up sampling."""
    return int((float(dim) - 1.0) * scale + 1.0) if dim % 2 == 1 else int(float(dim) * scale)


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
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
    i0 = np.floor(x).astype(np.int64)
    i0 = np.minimum(i0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = x - i0
    m = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - w1)
    np.add.at(m, (rows, i1), w1)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def interp_matrix(n_in: int, n_out: int, align_corners: bool,
                  device: torch.device) -> torch.Tensor:
    """(n_out, n_in) float32 matrix on ``device`` (cached: read-only). Made
    outside inference mode, so a matrix first built while serving can be
    saved for a later backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            _interp_matrix_np(n_in, n_out, align_corners)).to(device)


def resize_linear(x: torch.Tensor, out_sizes, axes, align_corners: bool) -> torch.Tensor:
    """Resize ``x`` along ``axes`` to ``out_sizes`` by linear interpolation."""
    assert len(out_sizes) == len(axes)
    for axis, n_out in zip(axes, out_sizes):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        m = interp_matrix(n_in, n_out, align_corners, x.device).to(x.dtype)
        x = torch.matmul(x.movedim(axis, -1), m.T).movedim(-1, axis)
    return x


@functools.lru_cache(maxsize=None)
def _taps_np(n_in: int, n_out: int, align_corners: bool, transposed: bool):
    """(idx (n_out, K) int32, w (n_out, K) f32) tap table of the
    interpolation matrix (or its transpose). A copy of
    rag_tpu/ops/pallas_resize.py::_taps_np: padded taps have weight 0 and
    index 0."""
    m = _interp_matrix_np(n_in, n_out, align_corners)
    if transposed:
        m = m.T  # (n_in, n_out) -> rows index the ADJOINT's outputs
    rows = []
    k_max = max(int((r != 0).sum()) for r in m) or 1
    for r in m:
        nz = np.nonzero(r)[0]
        idx = list(nz) + [0] * (k_max - len(nz))
        w = list(r[nz]) + [0.0] * (k_max - len(nz))
        rows.append((idx, w))
    idx = np.array([r[0] for r in rows], np.int32)
    w = np.array([r[1] for r in rows], np.float32)
    return idx, w


@functools.lru_cache(maxsize=64)
def tap_table(n_in: int, n_out: int, align_corners: bool, transposed: bool,
              device: torch.device):
    """``_taps_np`` on ``device`` (cached: read-only; made outside inference
    mode, so a table first built while serving can serve a backward)."""
    with torch.inference_mode(False):
        idx, w = _taps_np(n_in, n_out, align_corners, transposed)
        return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def resize_taps_plain(x: torch.Tensor, d2: int, h2: int, w2: int,
                      align_corners: bool = True,
                      transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel I: the matrix products. Forward:
    (B, D, C, H, W) -> (B, d2, C, h2, w2). transposed: the adjoint of the
    forward resize from (d2, h2, w2) to x's sizes, x being its cotangent."""
    if not transposed:
        return resize_linear(x, (d2, h2, w2), (1, 3, 4), align_corners)
    for axis, n_fwd_in in zip((1, 3, 4), (d2, h2, w2)):
        n_fwd_out = x.shape[axis]
        if n_fwd_in == n_fwd_out:
            continue
        m = interp_matrix(n_fwd_in, n_fwd_out, align_corners,
                          x.device).to(x.dtype)
        x = torch.matmul(x.movedim(axis, -1), m).movedim(-1, axis)
    return x


def resize_taps_cf(x: torch.Tensor, d2: int, h2: int, w2: int,
                   align_corners: bool = True,
                   transposed: bool = False) -> torch.Tensor:
    """Kernel I, no autograd: x (B, D, C, H, W) f32 -> (B, d2, C, h2, w2),
    the forward resize, or with ``transposed`` its adjoint (see
    ``resize_taps_plain``)."""
    if not x.is_cuda:
        return resize_taps_plain(x, d2, h2, w2, align_corners, transposed)
    check_f32("resize_taps_cf", x)
    b, d, c, h, w = x.shape
    tabs = [tap_table(*((n2, n) if transposed else (n, n2)), align_corners,
                      transposed, x.device)
            for n, n2 in ((d, d2), (h, h2), (w, w2))]
    if max(tabs[1][0].shape[1], tabs[2][0].shape[1]) > 4:
        raise ValueError(f"resize_taps_cf: {(h, w)} -> {(h2, w2)} needs more "
                         "than 4 taps along H or W")
    out = torch.empty((b, d2, c, h2, w2), device=x.device, dtype=torch.float32)
    rc = cuda_lib.lib().rag_resize_taps_cf(
        x.data_ptr(), *[t.data_ptr() for tab in tabs for t in tab],
        out.data_ptr(), b, d, c, h, w, d2, h2, w2,
        *[tab[0].shape[1] for tab in tabs], cuda_lib.stream_ptr(x))
    resize_taps_cf.launches += 1
    cuda_lib.check(rc, "resize_taps_cf")
    return out


resize_taps_cf.launches = 0


class _ResizeCF(torch.autograd.Function):
    """rag_tpu/ops/pallas_resize.py::resize_cf's custom VJP: kernel I on
    the forward tap tables, and on the transposed ones for the backward."""

    @staticmethod
    def forward(ctx, x, d2, h2, w2, align_corners):
        ctx.in_sizes = (x.shape[1], x.shape[3], x.shape[4])
        ctx.align_corners = align_corners
        return resize_taps_cf(x, d2, h2, w2, align_corners)

    @staticmethod
    def backward(ctx, g):
        dx = resize_taps_cf(g.contiguous(), *ctx.in_sizes, ctx.align_corners,
                            True)
        return dx, None, None, None, None


def resize_cf(x: torch.Tensor, d2: int, h2: int, w2: int,
              align_corners: bool = True,
              variants: KernelVariants = DEFAULT) -> torch.Tensor:
    """Trilinear resize of a channel-first volume (B, D, C, H, W) ->
    (B, d2, C, h2, w2): the matrix products, or kernel I where
    ``variants.resize_kernel``."""
    if not variants.resize_kernel:
        return resize_linear(x, (d2, h2, w2), (1, 3, 4), align_corners)
    x = x.contiguous()
    if needs_grad(x):
        return _ResizeCF.apply(x, d2, h2, w2, align_corners)
    return resize_taps_cf(x, d2, h2, w2, align_corners)
