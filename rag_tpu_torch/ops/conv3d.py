"""Kernel A: 3x3x3 stride-1 conv + per-channel affine + optional ReLU on a
channel-first (B, D, Cin, H, W) volume.

Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::_conv3d_pallas_cf
(kernel bodies _conv3d_kernel and, at the eval geometry, the H-tiled
_conv3d_kernel_v3). CUDA source: rag_tpu_torch/csrc/conv3d.cu with the tile
engine in csrc/conv3x3x3_tile.cuh.

Bound on the H100: operations. At the eval geometry ``stem_3d1`` alone is
2*27*12*12*64*160*320 = 25.5 GFLOP on a 157 MB input (0.38 ms at the fp32
non-tensor peak of 67 TFLOP/s against 0.09 ms to move its bytes). The design
stages a haloed input slab per block in shared memory and keeps 4 pixels x
up to 16 output channels per thread in registers, so every FMA reads its
operands on chip; see the header of conv3x3x3_tile.cuh.

Weights stay in the reference's (3, 3, 3, Cin, Cout) layout; the wrapper
packs them into the kernel's (n_co, Cin, 27, CO_T) tiles per call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rag_tpu_torch.ops import cuda_lib


def co_tile(cout: int) -> int:
    """Output channels per thread: the tile that wastes the fewest padded
    channels among the compiled ones (1, 4, 8, 12, 16)."""
    if cout == 1:
        return 1
    if cout <= 8:
        return 4 if cout <= 4 else 8
    if cout % 16 == 0:
        return 16
    if cout % 12 == 0:
        return 12
    return 16


def pack_weights(w: torch.Tensor, co_t: int) -> torch.Tensor:
    """(3,3,3,Cin,Cout) -> (n_co, Cin, 27, co_t), zero-padded past Cout."""
    cin, cout = w.shape[3], w.shape[4]
    n_co = -(-cout // co_t)
    w27 = F.pad(w.reshape(27, cin, cout), (0, n_co * co_t - cout))
    return w27.reshape(27, cin, n_co, co_t).permute(2, 1, 0, 3).contiguous()


def pad_channels(v: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(v, (0, n - v.shape[0])).contiguous()


def conv3d_brc_cf_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain PyTorch version: the SAME 3x3x3 conv as a sum of 27 shifted
    channel contractions, then the affine and ReLU."""
    b, d, cin, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 0, 0, 1, 1))           # W, H, (C), D halos
    y = None
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                tap = torch.einsum("bdihw,io->bdohw",
                                   xp[:, kd:kd + d, :, kh:kh + h, kw:kw + wd],
                                   w[kd, kh, kw])
                y = tap if y is None else y + tap
    y = y * scale.reshape(1, 1, -1, 1, 1) + bias.reshape(1, 1, -1, 1, 1)
    return torch.relu(y) if relu else y


def conv3d_brc_cf(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Fused conv + affine (+ReLU). x (B,D,Cin,H,W) f32; w (3,3,3,Cin,Cout);
    scale/bias (Cout,). Launches kernel A for CUDA tensors; the plain
    version runs only for CPU tensors."""
    if not x.is_cuda:
        return conv3d_brc_cf_plain(x, w, scale, bias, relu)
    b, d, cin, h, wd = x.shape
    cout = w.shape[4]
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or w.shape[:4] != (3, 3, 3, cin) or scale.shape != (cout,)
            or bias.shape != (cout,)):
        raise ValueError(f"conv3d_brc_cf: unsupported x {tuple(x.shape)} "
                         f"{x.dtype} contiguous={x.is_contiguous()}, "
                         f"w {tuple(w.shape)}")
    for t in (w, scale, bias):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("conv3d_brc_cf: w/scale/bias must be float32 "
                             "on the input's device")
    co_t = co_tile(cout)
    n_pad = -(-cout // co_t) * co_t
    wpk = pack_weights(w, co_t)
    sc = pad_channels(scale, n_pad)
    bi = pad_channels(bias, n_pad)
    out = torch.empty((b, d, cout, h, wd), device=x.device, dtype=torch.float32)
    rc = cuda_lib.lib().rag_conv3d_brc_cf(
        x.data_ptr(), wpk.data_ptr(), sc.data_ptr(), bi.data_ptr(),
        out.data_ptr(), b, d, cin, h, wd, cout, co_t, int(relu),
        cuda_lib.stream_ptr(x))
    conv3d_brc_cf.launches += 1
    cuda_lib.check(rc, "conv3d_brc_cf")
    return out


conv3d_brc_cf.launches = 0
