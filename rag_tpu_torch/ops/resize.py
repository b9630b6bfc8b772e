"""Separable linear interpolation (bilinear / trilinear) as matrix products.

Counterpart of rag_tpu/ops/resize.py and the plain form of
rag_tpu/ops/pallas_resize.py::resize_cf. Each axis is resized by a dense
(n_out, n_in) interpolation matrix built in float64 and cast to float32,
exactly as the reference builds it, so both packages contract with
bit-identical weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def resize_cf(x: torch.Tensor, d2: int, h2: int, w2: int,
              align_corners: bool = True) -> torch.Tensor:
    """Trilinear resize of a channel-first volume (B, D, C, H, W) ->
    (B, d2, C, h2, w2)."""
    return resize_linear(x, (d2, h2, w2), (1, 3, 4), align_corners)
