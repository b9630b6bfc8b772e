"""Kernel B: the concat cost volume fused into the matching stem conv +
folded frozen BatchNorm + ReLU.

Replaces the TPU kernel rag_tpu/ops/pallas_cvstem.py::cvstem_forward_cf
(kernel body _cvstem_kernel) and its H-tiled form cvstem_forward_cf_v3
(_cvstem_kernel_v3) used at the eval geometry; entry point as in
rag_tpu/ops/pallas_cvstem.py::cvstem_brc. CUDA source:
rag_tpu_torch/csrc/cvstem.cu, sharing the tile engine of kernel A.

Bound on the H100: operations, ~51 GFLOP at the eval geometry (24 -> 12
channels at D=64, 160x320) against ~5 MB of features read and 157 MB
written. The design builds each block's haloed slab of the volume in shared
memory straight from the two feature maps, so the 315 MB volume the plain
version materializes never exists; masking happens on load, so the conv's W
halo sees the volume's zeros left of the diagonal.
"""

from __future__ import annotations

import torch

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.conv3d import (
    co_tile,
    conv3d_brc_cf_plain,
    pack_weights,
    pad_channels,
)
from rag_tpu_torch.ops.cost_volume import cost_volume_cf


def cvstem_brc_plain(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
                     relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: materialize the cost volume, then conv."""
    cost = cost_volume_cf(x_cf.permute(0, 2, 3, 1), y_cf.permute(0, 2, 3, 1),
                          num_disp)
    return conv3d_brc_cf_plain(cost, w3, scale, bias, relu)


def cvstem_brc(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
               relu: bool = True) -> torch.Tensor:
    """conv3d(cost_volume_cf(X, Y, num_disp), w3) * scale + bias (+ReLU).

    x_cf, y_cf: (B, C, H, W) left/right features; w3: (3,3,3,2C,Cout);
    returns (B, num_disp, Cout, H, W). Launches kernel B for CUDA tensors;
    the plain version runs only for CPU tensors."""
    if not x_cf.is_cuda:
        return cvstem_brc_plain(x_cf, y_cf, w3, scale, bias, num_disp, relu)
    b, c, h, w = x_cf.shape
    cout = w3.shape[4]
    if (x_cf.dtype != torch.float32 or y_cf.shape != x_cf.shape
            or not x_cf.is_contiguous() or not y_cf.is_contiguous()
            or w3.shape[:4] != (3, 3, 3, 2 * c) or scale.shape != (cout,)
            or bias.shape != (cout,) or num_disp < 1):
        raise ValueError(f"cvstem_brc: unsupported x {tuple(x_cf.shape)} "
                         f"y {tuple(y_cf.shape)} w {tuple(w3.shape)}")
    for t in (y_cf, w3, scale, bias):
        if t.device != x_cf.device or t.dtype != torch.float32:
            raise ValueError("cvstem_brc: all operands must be float32 on "
                             "one device")
    co_t = co_tile(cout)
    n_pad = -(-cout // co_t) * co_t
    wpk = pack_weights(w3, co_t)
    sc = pad_channels(scale, n_pad)
    bi = pad_channels(bias, n_pad)
    out = torch.empty((b, num_disp, cout, h, w), device=x_cf.device,
                      dtype=torch.float32)
    rc = cuda_lib.lib().rag_cvstem_brc(
        x_cf.data_ptr(), y_cf.data_ptr(), wpk.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), b, c, h, w, num_disp, cout, co_t,
        int(relu), cuda_lib.stream_ptr(x_cf))
    cvstem_brc.launches += 1
    cuda_lib.check(rc, "cvstem_brc")
    return out


cvstem_brc.launches = 0
