"""The 3x3x3 stride-1 conv of the matching net on a channel-first
(B, D, Cin, H, W) volume: kernel A (forward, and dx in the backward), its
D-blocked variant kernel H, and kernel D (the weight gradient), with
``conv3d_brc_cf`` differentiable.

Kernel A, ``conv3d_affine_cf``: conv + per-channel affine + optional ReLU.
Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::_conv3d_pallas_cf
(kernel bodies _conv3d_kernel and, at the eval geometry, the H-tiled
_conv3d_kernel_v3). CUDA source: rag_tpu_torch/csrc/conv3d.cu with the tile
engine in csrc/conv3x3x3_tile.cuh. Bound on the H100: operations. At the
eval geometry ``stem_3d1`` alone is 2*27*12*12*64*160*320 = 25.5 GFLOP on a
157 MB input (0.38 ms at the fp32 non-tensor peak of 67 TFLOP/s against
0.09 ms to move its bytes). The design stages a haloed input slab per
block in shared memory and keeps 4 pixels x up to 16 output channels per
thread in registers, so every FMA reads its operands on chip.

Kernel D, ``conv3d_dw_cf``: the weight gradient
``dW[kd,kh,kw,ci,co] = sum_{b,d,h,w} x[b,d+kd-1,ci,h+kh-1,w+kw-1] dz[b,d,co,h,w]``.
Replaces rag_tpu/ops/pallas_conv3d.py::conv3d_dw_pallas_pre (body
_conv3d_dw_kernel), whose grid carries the sum in one revisited output
block. CUDA source: rag_tpu_torch/csrc/conv3d_dw.cu with
csrc/conv3x3x3_dw.cuh. Bound: operations, as the forward (16.3 GFLOP at
``stem_3d1``'s train shape, 0.24 ms). Blocks run in parallel here, so each
(b, d) plane's block writes its partial dW to a workspace and a second
kernel sums the partials in a fixed order: no float atomics, the same
result on every run.

``conv3d_brc_cf`` is the entry point. Without a gradient it is one fused
kernel A call. With one it runs kernel A at identity affine, keeps the
pre-affine ``z`` and applies the affine and ReLU outside, as
rag_tpu/ops/pallas_conv3d.py::_fwd_cf does; the backward (_bwd_cf) is
kernel A again on the masked cotangent with flipped, io-transposed,
scale-folded weights for dx, and kernel D post-scaled for dW.

Kernel H, ``conv3d_dblock_cf``: the D-blocked mode of kernel A, taken for
the forward and dx where ``KernelVariants.conv3d_dblock`` is set (see its
docstring and rag_tpu_torch/csrc/conv3d_dblock.cu).

Weights stay in the reference's (3, 3, 3, Cin, Cout) layout; the wrappers
pack them per call. Each wrapper runs its plain PyTorch version for CPU
tensors only; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants


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


def _shifted(x: torch.Tensor):
    """The 27 zero-padded shifted views x[:, d+kd-1, :, h+kh-1, w+kw-1]."""
    d, h, w = x.shape[1], x.shape[3], x.shape[4]
    xp = F.pad(x, (1, 1, 1, 1, 0, 0, 1, 1))           # W, H, (C), D halos
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                yield (kd, kh, kw), xp[:, kd:kd + d, :, kh:kh + h, kw:kw + w]


def conv3d_brc_cf_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel A: the SAME 3x3x3 conv as a sum of
    27 shifted channel contractions, then the affine and ReLU."""
    y = None
    for tap, xs in _shifted(x):
        t = torch.einsum("bdihw,io->bdohw", xs, w[tap])
        y = t if y is None else y + t
    y = y * scale.reshape(1, 1, -1, 1, 1) + bias.reshape(1, 1, -1, 1, 1)
    return torch.relu(y) if relu else y


def conv3d_dw_cf_plain(x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel D: 27 shifted contractions over
    (b, d, h, w). x (B,D,Cin,H,W), dz (B,D,Cout,H,W) -> (3,3,3,Cin,Cout)."""
    taps = [torch.einsum("bdihw,bdohw->io", xs, dz) for _, xs in _shifted(x)]
    return torch.stack(taps).reshape(3, 3, 3, x.shape[2], dz.shape[2])


def check_f32(name, *ts):
    for t in ts:
        if (t.device != ts[0].device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name}: operands must be contiguous float32 on "
                             f"one device, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def needs_grad(*ts) -> bool:
    """Whether autograd will want a gradient through a call on ts."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _launch_conv(wrapper, entry: str, x: torch.Tensor, w: torch.Tensor,
                 scale: torch.Tensor, bias: torch.Tensor,
                 relu: bool) -> torch.Tensor:
    """Launch a forward conv kernel (A, or H for the D-blocked variant):
    both take the same packed weights and padded affine. Counts one launch
    on ``wrapper``."""
    name = wrapper.__name__
    b, d, cin, h, wd = x.shape
    cout = w.shape[4]
    if (w.shape[:4] != (3, 3, 3, cin) or scale.shape != (cout,)
            or bias.shape != (cout,)):
        raise ValueError(f"{name}: unsupported x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    check_f32(name, x, w, scale, bias)
    co_t = co_tile(cout)
    n_pad = -(-cout // co_t) * co_t
    wpk = pack_weights(w, co_t)
    sc = pad_channels(scale, n_pad)
    bi = pad_channels(bias, n_pad)
    out = torch.empty((b, d, cout, h, wd), device=x.device, dtype=torch.float32)
    rc = getattr(cuda_lib.lib(), entry)(
        x.data_ptr(), wpk.data_ptr(), sc.data_ptr(), bi.data_ptr(),
        out.data_ptr(), b, d, cin, h, wd, cout, co_t, int(relu),
        cuda_lib.stream_ptr(x))
    wrapper.launches += 1
    cuda_lib.check(rc, name)
    return out


def conv3d_affine_cf(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Kernel A: conv + affine (+ReLU), no autograd. x (B,D,Cin,H,W) f32;
    w (3,3,3,Cin,Cout); scale/bias (Cout,)."""
    if not x.is_cuda:
        return conv3d_brc_cf_plain(x, w, scale, bias, relu)
    return _launch_conv(conv3d_affine_cf, "rag_conv3d_brc_cf", x, w, scale,
                        bias, relu)


conv3d_affine_cf.launches = 0


def conv3d_dblock_cf(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Kernel H, the D-blocked mode of kernel A (``KernelVariants.
    conv3d_dblock``): the same function, so the same plain version and
    arguments. Replaces rag_tpu/ops/pallas_conv3d.py::_conv3d_pallas_cf's
    D-blocked form (body _conv3d_kernel_v4). CUDA source:
    rag_tpu_torch/csrc/conv3d_dblock.cu. Bound: operations, as A. Each
    block stages a 6-plane input window once for 4 output planes and every
    thread keeps 4 planes x 2 pixels x up to 16 channels in registers.
    Takes every D (tail planes are masked), where the TPU kernel needed
    d % db == 0."""
    if not x.is_cuda:
        return conv3d_brc_cf_plain(x, w, scale, bias, relu)
    return _launch_conv(conv3d_dblock_cf, "rag_conv3d_dblock_cf", x, w, scale,
                        bias, relu)


conv3d_dblock_cf.launches = 0


def _conv_kernel(dblock: bool):
    """Kernel H's wrapper for the D-blocked variant, else kernel A's, looked
    up when called (so a caller that swaps a module attribute is seen)."""
    return conv3d_dblock_cf if dblock else conv3d_affine_cf


def conv3d_dw_cf(x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Kernel D: the 3x3x3 conv's weight gradient, no autograd.
    x (B,D,Cin,H,W), dz (B,D,Cout,H,W) f32 -> (3,3,3,Cin,Cout)."""
    if not x.is_cuda:
        return conv3d_dw_cf_plain(x, dz)
    b, d, cin, h, wd = x.shape
    cout = dz.shape[2]
    if dz.shape != (b, d, cout, h, wd):
        raise ValueError(f"conv3d_dw_cf: x {tuple(x.shape)} and dz "
                         f"{tuple(dz.shape)} disagree")
    check_f32("conv3d_dw_cf", x, dz)
    return launch_dw(conv3d_dw_cf, "rag_conv3d_dw_cf", [x], dz, cin)


conv3d_dw_cf.launches = 0


def launch_dw(wrapper, entry: str, inputs, dz: torch.Tensor,
              cin: int) -> torch.Tensor:
    """Launch a weight-gradient kernel (D, or F for the stem): one partial
    dW per (b, d) plane into a workspace, then the fixed-order sum, both
    on the current stream. Counts one launch on ``wrapper``."""
    b, d, cout, h, w = dz.shape
    n_out = 27 * cin * cout
    partial = torch.empty(b * d * n_out, device=dz.device, dtype=torch.float32)
    out = torch.empty((3, 3, 3, cin, cout), device=dz.device,
                      dtype=torch.float32)
    rc = getattr(cuda_lib.lib(), entry)(
        *[t.data_ptr() for t in inputs], dz.data_ptr(), partial.data_ptr(),
        out.data_ptr(), b, d, cin, cout, h, w, co_tile(cout),
        cuda_lib.stream_ptr(dz))
    wrapper.launches += 1
    cuda_lib.check(rc, entry)
    return out


class _Conv3dBRC(torch.autograd.Function):
    """Differentiable kernel A, or kernel H where ``dblock``
    (rag_tpu/ops/pallas_conv3d.py:_fwd_cf and _bwd_cf, which run the
    D-blocked kernel for the forward and dx under RAG_TPU_CONV3D_V4). The
    backward skips dx or dW where no gradient is needed, so a frozen site
    costs no kernel D launch."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu, dblock):
        cout = w.shape[4]
        z = _conv_kernel(dblock)(x, w, x.new_ones(cout), x.new_zeros(cout),
                                 False)
        sh = (1, 1, -1, 1, 1)
        y = z * scale.reshape(sh) + bias.reshape(sh)
        ctx.save_for_backward(x, w, scale, bias, z)
        ctx.relu, ctx.dblock = relu, dblock
        return torch.relu(y) if relu else y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, bias, z = ctx.saved_tensors
        need_x, need_w, need_scale, need_bias = ctx.needs_input_grad[:4]
        sh = (1, 1, -1, 1, 1)
        gm = g * ((z * scale.reshape(sh) + bias.reshape(sh)) > 0) \
            if ctx.relu else g
        gm = gm.contiguous()
        dx = dw = dscale = dbias = None
        if need_bias:
            dbias = gm.sum(dim=(0, 1, 3, 4))
        if need_scale:
            dscale = (gm * z).sum(dim=(0, 1, 3, 4))
        if need_x:
            cin = w.shape[3]
            wf = (w.flip((0, 1, 2)).transpose(3, 4)
                  * scale.reshape(1, 1, 1, -1, 1)).contiguous()
            dx = _conv_kernel(ctx.dblock)(gm, wf, x.new_ones(cin),
                                          x.new_zeros(cin), False)
        if need_w:
            dw = conv3d_dw_cf(x, gm) * scale.reshape(1, 1, 1, 1, -1)
        return dx, dw, dscale, dbias, None, None


def conv3d_brc_cf(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, relu: bool,
                  variants: KernelVariants = DEFAULT) -> torch.Tensor:
    """Fused conv + affine (+ReLU), differentiable in x, w, scale, bias.
    x (B,D,Cin,H,W) f32; w (3,3,3,Cin,Cout); scale/bias (Cout,). Kernel A,
    or kernel H where ``variants.conv3d_dblock``."""
    dblock = variants.conv3d_dblock
    if needs_grad(x, w, scale, bias):
        return _Conv3dBRC.apply(x, w, scale, bias, relu, dblock)
    return _conv_kernel(dblock)(x, w, scale, bias, relu)
