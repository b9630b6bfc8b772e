"""The concat cost volume fused into the matching stem's 3x3x3 conv:
kernel B (forward), kernel E (dX, dY) and kernel F (dW), with
``cvstem_conv`` and ``cvstem_brc`` differentiable. The (B, D, 2C, H, W)
volume never exists on the card, forward or backward.

Kernel B, ``cvstem_affine``: conv3d(cost_volume_cf(X, Y, D), w3) * scale +
bias (+ReLU). Replaces rag_tpu/ops/pallas_cvstem.py::cvstem_forward_cf
(body _cvstem_kernel) and its H-tiled form cvstem_forward_cf_v3
(_cvstem_kernel_v3). CUDA source: rag_tpu_torch/csrc/cvstem.cu, sharing
the tile engine of kernel A. Bound: operations, ~51 GFLOP at the eval
geometry against ~5 MB of features read and 157 MB written. Each block
builds its haloed slab of the volume in shared memory straight from the
two feature maps, masked on load, so the conv's W halo sees the volume's
zeros left of the diagonal.

Kernel E, ``cvstem_dxy``: with dv = conv3d(dz, flipped io-transposed w3),
``dX[c,h,j] = sum_d [j >= d] dv[d,c,h,j]`` and
``dY[c,h,j] = sum_d [j+d < W] dv[d,C+c,h,j+d]``. Replaces
rag_tpu/ops/pallas_cvstem.py::cvstem_dxy_pallas (body _cvstem_dxy_kernel).
CUDA source: rag_tpu_torch/csrc/cvstem_dxy.cu. Bound: operations, 24.0
GFLOP at the train shape counting only the products the adjoint keeps
(0.358 ms at 67 TFLOP/s). The dX and dY halves run in separate blocks, the
planes d in chunks across blocks (``dxy_plan``); each block stages every dz
plane of its chunk once, for all 12 output channels of its half, and the
partial sums of the chunks are added in chunk order by a second kernel.
``dxy_window``, ``dxy_tap_column`` and ``dxy_ring_slot`` are the kernel's
index rules, which the CPU tests emulate.

Kernel F, ``cvstem_dw``: the stem's weight gradient, on the engine of
csrc/conv3x3x3_dw.cuh with the input slab built from X and Y by the
cost-volume load rule.
Replaces rag_tpu/ops/pallas_cvstem.py::cvstem_dw_pallas (body
_cvstem_dw_kernel). CUDA source: rag_tpu_torch/csrc/cvstem_bwd.cu. Bound:
operations, 24.0 GFLOP at the train shape (0.358 ms), the forward's
products that read a voxel of the volume that is not a structural zero.

``cvstem_conv`` (pre-affine, for a stem whose BatchNorm trains) and
``cvstem_brc`` (frozen BN folded into the affine) follow
rag_tpu/ops/pallas_cvstem.py's two custom VJPs; ``cvstem_brc``'s backward
recomputes the pre-affine z with one more kernel B pass, as _brc_bwd does.
Each wrapper runs its plain PyTorch version for CPU tensors only; on a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.conv3d import (
    check_f32,
    co_tile,
    conv3d_brc_cf_plain,
    conv3d_dw_cf_plain,
    launch_dw,
    needs_grad,
    pack_weights,
    pad_channels,
)
from rag_tpu_torch.ops.cost_volume import cost_volume_cf

# Kernel E's tile (csrc/cvstem_dxy.cu): 8 x 64 pixels, 4 per thread kTX apart
DXY_TH, DXY_TW = 8, 64
DXY_RING = 2          # plane slots: the plane in use and the one streaming in
DXY_HALO = 2          # staged columns left of the tile (and right of it)
DXY_PITCH = 80        # floats per staged row
DXY_BLOCKS = 512      # about two waves at two blocks per SM


class DxyPlan(NamedTuple):
    """Kernel E's blocking of one call (csrc/cvstem_dxy.cu's arguments)."""
    ct: int           # channels of the half per block (a multiple of 4)
    n_cc: int         # blocks along the half's C channels
    chunk: int        # output planes d per block
    n_chunks: int     # blocks along D
    kc: int           # dz channels staged per pass
    n_wt: int         # tiles along W
    n_ht: int         # tiles along H
    blocks: int       # blocks of the partial-sum kernel
    workspace: int    # floats of the partial dX, dY workspace
    smem: int         # dynamic shared memory per block, bytes


@functools.lru_cache(maxsize=None)
def dxy_plan(b: int, d: int, cout: int, c: int, h: int, w: int) -> DxyPlan:
    """Kernel E's blocking for dz (b, d, cout, h, w) and halves of c
    channels: every channel of the half in one block where c <= 12, and
    planes split into chunks (halved from 16 while the grid has fewer than
    DXY_BLOCKS blocks, down to 2) so the card fills."""
    n_cc = -(-c // 12)
    ct = -(-c // (4 * n_cc)) * 4
    n_wt, n_ht = -(-w // DXY_TW), -(-h // DXY_TH)
    chunk = min(16, d)
    while chunk > 2 and n_wt * n_ht * -(-d // chunk) * 2 * b * n_cc < DXY_BLOCKS:
        chunk = max(2, chunk // 2)
    n_chunks = -(-d // chunk)
    passes = -(-cout // 12)
    kc = -(-cout // passes)
    smem = 4 * (27 * kc * ct + DXY_RING * kc * (DXY_TH + 2) * DXY_PITCH)
    return DxyPlan(ct, n_cc, chunk, n_chunks, kc, n_wt, n_ht,
                   n_wt * n_ht * n_chunks * 2 * b * n_cc,
                   2 * n_chunks * b * c * h * w, smem)


def dxy_window(half: int, w0: int, q: int) -> int:
    """First dz column kernel E stages of plane q for the tile at column
    w0: the conv's halo and one more column each side, shifted by +q for
    the dY half so that one copy serves the outputs d = q-1, q, q+1."""
    return w0 - DXY_HALO + (q if half else 0)


def dxy_tap_column(half: int, kd: int) -> int:
    """Staged column of tile pixel x at tap kw, less x + kw, where the
    output plane d = q + 1 - kd reads plane q (dY reads column j + d)."""
    return 1 if half == 0 else 2 - kd


def dxy_ring_slot(q: int) -> int:
    """The ring slot that holds dz plane q."""
    return q % DXY_RING


def pack_dxy_weights(w3: torch.Tensor, ct: int, n_cc: int) -> torch.Tensor:
    """(3,3,3,2C,Cout) -> (2, n_cc, 27, Cout, ct): the dx conv's weights
    W'[tap, co, half*C + cc*ct + i], zero past C."""
    c2, cout = w3.shape[3], w3.shape[4]
    c = c2 // 2
    wf = _flip_io(w3).reshape(27, cout, 2, c)
    wf = torch.nn.functional.pad(wf, (0, n_cc * ct - c))
    return wf.reshape(27, cout, 2, n_cc, ct).permute(2, 3, 0, 1, 4).contiguous()


def _volume(x_cf, y_cf, num_disp):
    return cost_volume_cf(x_cf.permute(0, 2, 3, 1), y_cf.permute(0, 2, 3, 1),
                          num_disp)


def _flip_io(w3: torch.Tensor) -> torch.Tensor:
    """Weights of the dx conv: spatially flipped, in/out transposed."""
    return w3.flip((0, 1, 2)).transpose(3, 4)


def cvstem_brc_plain(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
                     relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of kernel B: materialize the cost volume,
    then conv."""
    return conv3d_brc_cf_plain(_volume(x_cf, y_cf, num_disp), w3, scale,
                               bias, relu)


def cvstem_dxy_plain(dz: torch.Tensor, w3: torch.Tensor, num_disp: int):
    """Plain PyTorch version of kernel E: the dx conv over the whole
    volume, then the adjoint of the volume build."""
    c2 = w3.shape[3]
    c = c2 // 2
    dv = conv3d_brc_cf_plain(dz, _flip_io(w3), dz.new_ones(c2),
                             dz.new_zeros(c2), False)
    w = dz.shape[4]
    j = torch.arange(w, device=dz.device)
    mask = (j[None, :] >= torch.arange(num_disp, device=dz.device)[:, None])
    dx = (dv[:, :, :c] * mask[None, :, None, None, :].to(dz.dtype)).sum(1)
    dy = torch.zeros_like(dx)
    for d in range(min(num_disp, w)):
        dy[..., :w - d] += dv[:, d, c:, :, d:]
    return dx, dy


def cvstem_dw_plain(x_cf: torch.Tensor, y_cf: torch.Tensor, dz: torch.Tensor,
                    num_disp: int) -> torch.Tensor:
    """Plain PyTorch version of kernel F: kernel D's plain version on the
    materialized volume."""
    return conv3d_dw_cf_plain(_volume(x_cf, y_cf, num_disp), dz)


def cvstem_affine(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
                  relu: bool = True) -> torch.Tensor:
    """Kernel B, no autograd. x_cf, y_cf: (B, C, H, W) left/right
    features; w3: (3,3,3,2C,Cout); returns (B, num_disp, Cout, H, W)."""
    if not x_cf.is_cuda:
        return cvstem_brc_plain(x_cf, y_cf, w3, scale, bias, num_disp, relu)
    b, c, h, w = x_cf.shape
    cout = w3.shape[4]
    if (y_cf.shape != x_cf.shape or w3.shape[:4] != (3, 3, 3, 2 * c)
            or scale.shape != (cout,) or bias.shape != (cout,)
            or num_disp < 1):
        raise ValueError(f"cvstem_affine: unsupported x {tuple(x_cf.shape)} "
                         f"y {tuple(y_cf.shape)} w {tuple(w3.shape)}")
    check_f32("cvstem_affine", x_cf, y_cf, w3, scale, bias)
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
    cvstem_affine.launches += 1
    cuda_lib.check(rc, "cvstem_affine")
    return out


cvstem_affine.launches = 0


def cvstem_dxy(dz: torch.Tensor, w3: torch.Tensor, num_disp: int):
    """Kernel E, no autograd: (dX, dY), each (B, C, H, W), for the
    pre-affine stem cotangent dz (B, num_disp, Cout, H, W)."""
    if not dz.is_cuda:
        return cvstem_dxy_plain(dz, w3, num_disp)
    b, d, cout, h, w = dz.shape
    c2 = w3.shape[3]
    c = c2 // 2
    if d != num_disp or w3.shape != (3, 3, 3, c2, cout) or c2 != 2 * c:
        raise ValueError(f"cvstem_dxy: unsupported dz {tuple(dz.shape)}, "
                         f"w {tuple(w3.shape)}, num_disp {num_disp}")
    check_f32("cvstem_dxy", dz, w3)
    return launch_dxy(dz, w3, dxy_plan(b, d, cout, c, h, w))


def launch_dxy(dz: torch.Tensor, w3: torch.Tensor, plan: DxyPlan):
    """Launch kernel E's two passes (partial sums per chunk of planes, then
    their sum in chunk order) on the current stream with a given plan.
    Counts one launch on ``cvstem_dxy``."""
    b, d, cout, h, w = dz.shape
    c = w3.shape[3] // 2
    wpk = pack_dxy_weights(w3, plan.ct, plan.n_cc)
    partial = torch.empty(plan.workspace, device=dz.device,
                          dtype=torch.float32)
    dx = torch.empty((b, c, h, w), device=dz.device, dtype=torch.float32)
    dy = torch.empty_like(dx)
    rc = cuda_lib.lib().rag_cvstem_dxy(
        dz.data_ptr(), wpk.data_ptr(), partial.data_ptr(), dx.data_ptr(),
        dy.data_ptr(), b, d, cout, c, h, w, plan.ct, plan.n_cc, plan.chunk,
        plan.n_chunks, plan.kc, cuda_lib.stream_ptr(dz))
    cvstem_dxy.launches += 1
    cuda_lib.check(rc, "cvstem_dxy")
    return dx, dy


cvstem_dxy.launches = 0


def cvstem_dw(x_cf: torch.Tensor, y_cf: torch.Tensor, dz: torch.Tensor,
              num_disp: int) -> torch.Tensor:
    """Kernel F, no autograd: the stem's dW (3,3,3,2C,Cout) for the
    pre-affine cotangent dz (B, num_disp, Cout, H, W)."""
    if not x_cf.is_cuda:
        return cvstem_dw_plain(x_cf, y_cf, dz, num_disp)
    b, c, h, w = x_cf.shape
    if y_cf.shape != x_cf.shape or dz.shape[:2] != (b, num_disp) \
            or dz.shape[3:] != (h, w):
        raise ValueError(f"cvstem_dw: x {tuple(x_cf.shape)}, y "
                         f"{tuple(y_cf.shape)}, dz {tuple(dz.shape)}")
    check_f32("cvstem_dw", x_cf, y_cf, dz)
    return launch_dw(cvstem_dw, "rag_cvstem_dw", [x_cf, y_cf], dz, 2 * c)


cvstem_dw.launches = 0


class _CvstemConv(torch.autograd.Function):
    """rag_tpu/ops/pallas_cvstem.py::cvstem_conv's VJP: E for dX/dY, F for
    dW, each only where a gradient is needed."""

    @staticmethod
    def forward(ctx, x_cf, y_cf, w3, num_disp):
        cout = w3.shape[4]
        ctx.save_for_backward(x_cf, y_cf, w3)
        ctx.num_disp = num_disp
        return cvstem_affine(x_cf, y_cf, w3, x_cf.new_ones(cout),
                             x_cf.new_zeros(cout), num_disp, False)

    @staticmethod
    def backward(ctx, g):
        x_cf, y_cf, w3 = ctx.saved_tensors
        need_x, need_y, need_w, _ = ctx.needs_input_grad
        g = g.contiguous()
        dx = dy = dw = None
        if need_x or need_y:
            dx, dy = cvstem_dxy(g, w3, ctx.num_disp)
        if need_w:
            dw = cvstem_dw(x_cf, y_cf, g, ctx.num_disp)
        return dx, dy, dw, None


class _CvstemBRC(torch.autograd.Function):
    """rag_tpu/ops/pallas_cvstem.py::cvstem_brc's VJP (_brc_bwd)."""

    @staticmethod
    def forward(ctx, x_cf, y_cf, w3, scale, bias, num_disp, relu):
        out = cvstem_affine(x_cf, y_cf, w3, scale, bias, num_disp, relu)
        ctx.save_for_backward(x_cf, y_cf, w3, scale, out)
        ctx.num_disp, ctx.relu = num_disp, relu
        return out

    @staticmethod
    def backward(ctx, g):
        x_cf, y_cf, w3, scale, out = ctx.saved_tensors
        need_x, need_y, need_w, need_scale, need_bias = ctx.needs_input_grad[:5]
        nd = ctx.num_disp
        gm = g * (out > 0) if ctx.relu else g
        dx = dy = dw = dscale = dbias = None
        if need_bias:
            dbias = gm.sum(dim=(0, 1, 3, 4))
        if need_scale:
            cout = w3.shape[4]
            z = cvstem_affine(x_cf, y_cf, w3, x_cf.new_ones(cout),
                              x_cf.new_zeros(cout), nd, False)
            dscale = (gm * z).sum(dim=(0, 1, 3, 4))
        dz = (gm * scale.reshape(1, 1, -1, 1, 1)).contiguous()
        if need_x or need_y:
            dx, dy = cvstem_dxy(dz, w3, nd)
        if need_w:
            dw = cvstem_dw(x_cf, y_cf, dz, nd)
        return dx, dy, dw, dscale, dbias, None, None


def cvstem_conv(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                num_disp: int) -> torch.Tensor:
    """conv3d(cost_volume(x, y, D), w3), pre-affine (BatchNorm and ReLU
    run outside), differentiable in x_cf, y_cf and w3."""
    if needs_grad(x_cf, y_cf, w3):
        return _CvstemConv.apply(x_cf, y_cf, w3, num_disp)
    cout = w3.shape[4]
    return cvstem_affine(x_cf, y_cf, w3, x_cf.new_ones(cout),
                         x_cf.new_zeros(cout), num_disp, False)


def cvstem_brc(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
               relu: bool = True) -> torch.Tensor:
    """conv3d(cost_volume_cf(X, Y, num_disp), w3) * scale + bias (+ReLU),
    differentiable in every tensor. x_cf, y_cf: (B, C, H, W); w3:
    (3,3,3,2C,Cout); returns (B, num_disp, Cout, H, W)."""
    if needs_grad(x_cf, y_cf, w3, scale, bias):
        return _CvstemBRC.apply(x_cf, y_cf, w3, scale, bias, num_disp, relu)
    return cvstem_affine(x_cf, y_cf, w3, scale, bias, num_disp, relu)
