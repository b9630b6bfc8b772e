"""The shear-collapsed matching stem: kernel J (forward) and kernel K (its
adjoint), taken for ``stem_3d0`` where ``KernelVariants.shear_stem`` is set.

Counterpart of rag_tpu/ops/pallas_shear.py. The stem conv over the concat
cost volume collapses: the volume is a shear of the right feature map, so
``conv3d(cost_volume_cf(X, Y, D), w3)`` is eighteen (3,1) convs on the
feature maps (``tap_maps``, plain PyTorch, as rag_tpu leaves them to XLA)
plus per-disparity masked, shifted sums of those tap maps (kernel J). The
sums are linear in the tap maps, so the backward is one adjoint kernel (K)
and autograd carries its result through the tap-map convs to dX, dY and dW.

Kernel J, ``shear_forward``: replaces rag_tpu/ops/pallas_shear.py::
shear_forward (body _shear_kernel), with the per-channel affine and
optional ReLU of its epilogue. Kernel K, ``shear_adjoint``: replaces
rag_tpu/ops/pallas_shear.py::shear_adjoint (body _shear_adj_kernel). CUDA
source for both: rag_tpu_torch/csrc/shear.cu, where the index rule, the
class table, the bounds (bytes for both: 0.060 ms for J at the eval
geometry, 0.0385 ms for J and K at the train shape) and the designs are
written out. J: a block takes one (b, co, h) row in pieces of at most
1024 columns x 64 planes (one piece at every main-path shape), stages the
piece's tap-map rows in shared memory, builds the two rows P[j] = sum_t
px[t][j] and R[u] = sum_t py[t][u - k_t] there, and writes the piece's
outputs: first the groups of columns that the diagonal band, the first
and last planes or the last column touch, term by term in the TPU
kernel's order, then the rest as P[j] + R[j - d] (or the zero region's
bias), each thread walking a group of columns down a run of 8 planes. K:
one thread walks each column (dpx) and one each diagonal (dpy) in
ascending d, with running sums from d = 0 and d = 1 written where each
output's range ends, so every output is the TPU kernel's sequential sum:
no float atomics, the same bits on every run. Where a row's 2W + 4
walkers fit one block (W <= 510) the block stages the row's D x W slab of
dz once; wider rows go to column blocks and diagonal blocks that stage
only the columns they read. ``shear_plan`` reads either launch from the
library; ``fwd_plan`` is J's in Python, ``adj_plan`` K's (with
``adj_piece`` and ``adj_window``, the columns a block stages a run).

rag_tpu engages the shear only where its VMEM estimate fits 12 MB
(``shear_vmem_ok``), which keeps it off at 480x960. J and K take every
shape (their shared memory is bounded whatever W and D are), so the port
serves 480x960 through them too; the same holds for D == W, ``num_disp``
past W and any W % 4 (copies and stores of four elements where W % 4 ==
0, of one elsewhere).

Each wrapper runs its plain PyTorch version for CPU tensors only; on a
CUDA tensor it launches its kernel or raises. The plain versions are masked,
shifted sums with direct indexing (never a roll that wraps).

Dtypes (the bf16-at-rest policy, ops.precision): the tap maps are built
in float32 from the upcast features and stored in the features' dtype, as
rag_tpu/ops/pallas_shear.py::shear_stem_z casts them to the compute
dtype. J takes float32 or bfloat16 tap maps at one plan (``fwd_plan``:
groups of four columns for both where W % 4 == 0 and the maps are aligned
to four elements), stages their rows as they are with cp.async in pieces
of four (16 bytes of float32, 8 of bf16), widens a bf16 value as it reads
it, sums in float32 and stores z in the maps' dtype, four columns at once
(one 16- or 8-byte store); so its bf16 output is its float32 output on
the upcast maps, rounded. K takes a float32 or bf16 dz and writes dpx and
dpy in float32. Its bf16 instance takes the float32 instance's runs and
walkers (the slab's cap counts elements: a bf16 slab is half the bytes),
stages dz as it is with cp.async in 16-byte pieces of eight (or 8-byte
pieces of four, ``adj_piece``) and widens each value as a walker reads
it, so dpx and dpy are the float32 instance's on the upcast dz. The plain
versions compute in float32 (or float64) on the upcast inputs; J's casts
its output to the maps' dtype.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.conv3d import check_dtypes, needs_grad
from rag_tpu_torch.ops.precision import wide

# term order: t = 3 * dd + dw
T9 = tuple((dd, dw) for dd in range(3) for dw in range(3))


def _shift_w(x_cf: torch.Tensor, s: int) -> torch.Tensor:
    """Shift along W by s in {-1, 0, 1} with zero fill (x[..., j + s])."""
    if s == 0:
        return x_cf
    if s > 0:
        return F.pad(x_cf[..., s:], (0, s))
    return F.pad(x_cf[..., :s], (-s, 0))


def _conv31(x_cf: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(3,1)-kernel convs over H of a (B, C, H, W) map, several at once.
    k: (n, 3, C, co), n kernels of (kh, cin, cout) -> (B, n, co, H, W)."""
    n, _, c, co = k.shape
    weight = k.permute(0, 3, 2, 1).reshape(n * co, c, 3, 1)
    y = F.conv2d(x_cf, weight.to(x_cf.dtype), padding=(1, 0))
    return y.reshape(x_cf.shape[0], n, co, *y.shape[2:])


def tap_maps(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor):
    """The eighteen per-tap feature maps, stacked (B, 9, co, H, W) x2:
    px[t] = conv31(shift_w(X, dw-1), Wx[dd, :, dw]),
    py[t] = conv31(Y, Wy[dd, :, dw]), t = 3*dd + dw. Four conv2d calls:
    one per W shift of X (its three D taps at once) and one for Y, in
    float32 (or float64) on the upcast features."""
    x_cf, y_cf = wide(x_cf), wide(y_cf)
    c = x_cf.shape[1]
    if w3.shape[:3] != (3, 3, 3) or w3.shape[3] != 2 * c:
        raise ValueError(f"tap_maps: w3 {tuple(w3.shape)} for C={c}")
    wx, wy = w3[:, :, :, :c], w3[:, :, :, c:]       # (dd, kh, dw, cin, co)
    px = torch.stack([_conv31(_shift_w(x_cf, dw - 1), wx[:, :, dw])
                      for dw in range(3)], dim=2)   # (B, dd, dw, co, H, W)
    b, _, _, co, h, w = px.shape
    py = _conv31(y_cf, wy.permute(0, 2, 1, 3, 4).reshape(9, 3, c, co))
    return px.reshape(b, 9, co, h, w), py


def _masks(num_disp: int, w: int, dd: int, dw: int, device):
    """For term (dd, dw): the shift s (D, 1), and the px and py masks
    (D, W) of the forward assembly (D-pad gate, diagonal, W edge)."""
    d = torch.arange(num_disp, device=device)[:, None]
    j = torch.arange(w, device=device)[None, :]
    s = d + dd - dw
    gate = (d + dd - 1 >= 0) & (d + dd - 1 <= num_disp - 1)
    xm = (j >= s) & gate
    return s, xm, xm & (j <= w - dw)


def shear_forward_plain(px: torch.Tensor, py: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        num_disp: int, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel J: (B, 9, co, H, W) tap maps ->
    (B, num_disp, co, H, W), terms added in the kernel's order, in float32
    (or float64) on the upcast maps; the output in their dtype."""
    out_dtype = px.dtype
    px, py = wide(px), wide(py)
    b, _, co, h, w = px.shape
    j = torch.arange(w, device=px.device)[None, :]
    acc = px.new_zeros((b, num_disp, co, h, w))
    zero = px.new_zeros(())
    for t, (dd, dw) in enumerate(T9):
        s, xm, ym = _masks(num_disp, w, dd, dw, px.device)
        acc = acc + torch.where(xm[None, :, None, None, :], px[:, t, None],
                                zero)
        # py at column j - s, read only where the mask holds
        shifted = py[:, t][..., (j - s).clamp(0, w - 1)]   # (B, co, H, D, W)
        acc = acc + torch.where(ym[None, :, None, None, :],
                                shifted.permute(0, 3, 1, 2, 4), zero)
    y = acc * scale.reshape(1, 1, -1, 1, 1) + bias.reshape(1, 1, -1, 1, 1)
    return (torch.relu(y) if relu else y).to(out_dtype)


def shear_adjoint_plain(dz: torch.Tensor, num_disp: int):
    """Plain PyTorch version of kernel K: dz (B, D, co, H, W) -> (dpx, dpy),
    each (B, 9, co, H, W), the sums over d of the forward's masked terms
    taken back to their sources, in float32 (or float64) on the upcast
    dz."""
    dz = wide(dz)
    b, nd, co, h, w = dz.shape
    if nd != num_disp:
        raise ValueError(f"shear_adjoint: dz {tuple(dz.shape)}, num_disp "
                         f"{num_disp}")
    i = torch.arange(w, device=dz.device)[None, :]
    d = torch.arange(nd, device=dz.device)[:, None].expand(nd, w)
    zero = dz.new_zeros(())
    dpx, dpy = [], []
    for dd, dw in T9:
        s, xm, ym = _masks(nd, w, dd, dw, dz.device)
        dpx.append(torch.where(xm[None, :, None, None, :], dz, zero).sum(1))
        # dpy[i] takes dz at the output column j = i + s that read it
        jj = i + s
        keep = (jj >= 0) & (jj < w) & ym.gather(1, jj.clamp(0, w - 1))
        vals = dz[:, d, :, :, jj.clamp(0, w - 1)]          # (D, W, B, co, H)
        dpy.append(torch.where(keep[:, :, None, None, None], vals, zero)
                   .sum(0).permute(1, 2, 3, 0))
    return torch.stack(dpx, 1), torch.stack(dpy, 1)


def shear_forward(px: torch.Tensor, py: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, num_disp: int,
                  relu: bool = False) -> torch.Tensor:
    """Kernel J, no autograd: (B, 9, co, H, W) tap maps -> (B, num_disp,
    co, H, W) stem output, times scale plus bias (+ReLU) per channel."""
    if not px.is_cuda:
        return shear_forward_plain(px, py, scale, bias, num_disp, relu)
    b, nine, co, h, w = px.shape
    if (nine != 9 or py.shape != px.shape or scale.shape != (co,)
            or bias.shape != (co,) or num_disp < 1):
        raise ValueError(f"shear_forward: px {tuple(px.shape)}, py "
                         f"{tuple(py.shape)}, num_disp {num_disp}")
    check_dtypes("shear_forward", (px, py), (scale, bias))
    with cuda_lib.launch(shear_forward, px.dtype):
        out = torch.empty((b, num_disp, co, h, w), device=px.device,
                          dtype=px.dtype)
        rc = cuda_lib.entry("rag_shear_fwd", px.dtype)(
            px.data_ptr(), py.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, num_disp, co, h, w, int(relu),
            cuda_lib.stream_ptr(px))
        cuda_lib.check(rc, "shear_forward")
    return out


shear_forward.launches = shear_forward.launches_bf16 = 0
shear_forward.span = "kernel.J"


def shear_adjoint(dz: torch.Tensor, num_disp: int):
    """Kernel K, no autograd: dz (B, num_disp, co, H, W) -> (dpx, dpy),
    both (B, 9, co, H, W) float32 (float64 for a float64 dz on the
    CPU)."""
    if not dz.is_cuda:
        return shear_adjoint_plain(dz, num_disp)
    b, nd, co, h, w = dz.shape
    if nd != num_disp:
        raise ValueError(f"shear_adjoint: dz {tuple(dz.shape)}, num_disp "
                         f"{num_disp}")
    check_dtypes("shear_adjoint", (dz,))
    with cuda_lib.launch(shear_adjoint, dz.dtype):
        dpx = torch.empty((b, 9, co, h, w), device=dz.device,
                          dtype=torch.float32)
        dpy = torch.empty_like(dpx)
        rc = cuda_lib.entry("rag_shear_adj", dz.dtype)(
            dz.data_ptr(), dpx.data_ptr(), dpy.data_ptr(), b, nd, co, h, w,
            cuda_lib.stream_ptr(dz))
        cuda_lib.check(rc, "shear_adjoint")
    return dpx, dpy


shear_adjoint.launches = shear_adjoint.launches_bf16 = 0
shear_adjoint.span = "kernel.K"


class ShearPlan(NamedTuple):
    """A launch of kernel J or K (csrc/shear.cu::rag_shear_plan)."""
    blocks: int        # J: one a row; K: splits a row
    threads: int       # a block
    smem: int          # bytes of shared memory a block
    planes: int        # J: planes a staged piece; K: dz planes a run
    cols: int          # J: columns a piece; K: the staged slab's row pitch
    runs: int          # J: pieces a row; K: runs of planes a row
    vec: int           # copies in pieces (1: J's of four, K's adj_piece)
                       # or of one element (0)
    splits: int        # blocks a row (K's column and diagonal blocks)
    col_splits: int    # K's column blocks a row (0: one block, both kinds)
    copy_bytes: int    # bytes a copy: 16 or 8 (pieces), 4 or 2 (elements)


def shear_plan(adjoint: bool, b: int, num_disp: int, co: int, h: int,
               w: int, eb: int = 4) -> ShearPlan:
    """The launch kernel J (or K, with adjoint) takes at a shape for
    eb-byte operands (4: float32, 2: bf16), as the library's entry point
    chooses it (operands aligned to a piece). Loads the library: CUDA
    hosts only."""
    out = (ctypes.c_longlong * len(ShearPlan._fields))()
    rc = cuda_lib.lib().rag_shear_plan(int(adjoint), b, num_disp, co, h, w,
                                       eb, ctypes.cast(out, ctypes.c_void_p))
    cuda_lib.check(rc, "shear_plan")
    return ShearPlan(*out)


# kernel J's plain constants (csrc/shear.cu)
FWD_MAX_THREADS = 768   # most threads a block
FWD_PLANES = 8          # planes a task walks
FWD_TILE_COLS = 1024    # most columns a staged piece
FWD_TILE_PLANES = 64    # most planes a staged piece


def _round4(n: int) -> int:
    return (n + 3) & ~3


def fwd_smem_bytes(w: int, tw: int, dp: int, eb: int) -> int:
    """Kernel J's shared memory for pieces of tw columns x dp planes
    (csrc/shear.cu::FwdLayout::bytes): nine px rows of round4(tw) and nine
    py rows of min(round4(W), round4(tw + dp + 9)) eb-byte elements, then
    float32 P (round4(tw)) and R (min(W, tw + dp))."""
    wx = _round4(tw)
    wy = min(_round4(w), _round4(tw + dp + 9))
    return eb * 9 * (wx + wy) + 4 * (wx + min(w, tw + dp))


def fwd_plan(b: int, num_disp: int, co: int, h: int, w: int, eb: int = 4,
             aligned: bool = True) -> ShearPlan:
    """Kernel J's launch in Python (csrc/shear.cu::fwd_plan), for eb-byte
    maps (aligned: px, py and out aligned to four elements): the same for
    float32 and bf16 but for its shared bytes and copy width."""
    vec = w % 4 == 0 and aligned
    tw = -(-w // -(-w // FWD_TILE_COLS))
    if vec:
        tw = _round4(tw)
    dp = -(-num_disp // -(-num_disp // FWD_TILE_PLANES))
    tasks = -(-dp // FWD_PLANES) * (tw // 4 if vec else tw)
    threads = (-(-tasks // 32) * 32 if tasks < FWD_MAX_THREADS
               else FWD_MAX_THREADS)
    return ShearPlan(b * co * h, threads, fwd_smem_bytes(w, tw, dp, eb), dp,
                     tw, -(-w // tw) * -(-num_disp // dp), int(vec), 1, 0,
                     4 * eb if vec else eb)


# kernel K's plain constants (csrc/shear.cu)
ADJ_SLAB = 16384        # most dz elements a staged run (kAdjSlabFloats)
ADJ_MAX_THREADS = 1024  # most walkers a block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def adj_piece(w: int, addr: int, eb: int) -> int:
    """Elements of kernel K's staged pieces (csrc/shear.cu::adj_piece) for
    dz of W columns at address ``addr`` with eb-byte elements: 16 bytes
    (four floats, eight bf16) where W is a multiple of them and dz is
    16-byte aligned; for bf16 else 8 bytes (four) where W % 4 == 0 and dz
    is 8-byte aligned; else 1 (element by element)."""
    n16 = 16 // eb
    if w % n16 == 0 and addr % 16 == 0:
        return n16
    if eb == 2 and w % 4 == 0 and addr % 8 == 0:
        return 4
    return 1


def adj_cols(threads: int, planes: int, piece: int) -> int:
    """K's slab row pitch for a diagonal block (csrc/shear.cu::adj_cols):
    its window of threads + planes - 1 columns widened to whole pieces at
    both ends, rounded to four (eight for pieces of eight)."""
    p = max(piece, 4)
    return _cdiv(threads + planes + 2 * p, p) * p


def adj_plan(b: int, num_disp: int, co: int, h: int, w: int, eb: int = 4,
             addr: int = 0, max_threads: int = ADJ_MAX_THREADS,
             slab: int = ADJ_SLAB) -> ShearPlan:
    """Kernel K's launch in Python (csrc/shear.cu::adj_plan) for eb-byte
    dz at address ``addr``; ``max_threads`` and ``slab`` stand in for the
    library's caps. The runs and walkers take shapes only; the pieces,
    the diagonal blocks' pitch and the bytes take the dtype too."""
    piece = adj_piece(w, addr, eb)
    if 2 * w + 4 <= max_threads:
        threads, ncs, splits = _cdiv(2 * w + 4, 32) * 32, 0, 1
        most = slab // w
    else:
        ncs, nds = _cdiv(w, max_threads), _cdiv(w + 4, max_threads)
        threads = _cdiv(max(_cdiv(w, ncs), _cdiv(w + 4, nds)), 32) * 32
        splits, most = ncs + nds, 1
        while (most + 1) * adj_cols(threads, most + 1, piece) <= slab:
            most += 1
    runs = _cdiv(num_disp, max(most, 1))
    planes = _cdiv(num_disp, runs)
    cols = w if ncs == 0 else adj_cols(threads, planes, piece)
    return ShearPlan(b * co * h * splits, threads, planes * cols * eb,
                     planes, cols, runs, int(piece > 1), splits, ncs,
                     piece * eb)


def adj_window(plan: ShearPlan, w: int, split: int, c0: int, c1: int,
               piece: int):
    """The columns [x0, x1) block ``split`` of a row stages for its run of
    planes [c0, c1) (csrc/shear.cu::shear_adj_kernel): the whole row for
    one block a row; a column block's walkers' columns; a diagonal
    block's window, sliding one column a plane, widened to whole pieces."""
    bd, ncs = plan.threads, plan.col_splits
    if ncs == 0:
        return 0, w
    if split < ncs:
        return split * bd, min(w, split * bd + bd)
    ua = (split - ncs) * bd - 2
    x0, x1 = max(0, ua + c0), min(w, ua + bd + c1 - 1)
    x0, x1 = x0 - x0 % piece, min(w, _cdiv(x1, piece) * piece)
    return x0, max(x1, x0)


def _identity_affine(px: torch.Tensor):
    """(ones, zeros) of J's affine for tap maps px: float32, or float64."""
    co, dt = px.shape[2], torch.promote_types(px.dtype, torch.float32)
    return (torch.ones(co, device=px.device, dtype=dt),
            torch.zeros(co, device=px.device, dtype=dt))


class _ShearOp(torch.autograd.Function):
    """rag_tpu/ops/pallas_shear.py::_shear_op: J at identity affine
    forward, K backward (the maps' cotangents in their dtype)."""

    @staticmethod
    def forward(ctx, px, py, num_disp):
        ctx.num_disp = num_disp
        return shear_forward(px, py, *_identity_affine(px), num_disp)

    @staticmethod
    def backward(ctx, g):
        dpx, dpy = shear_adjoint(g.contiguous(), ctx.num_disp)
        return dpx.to(g.dtype), dpy.to(g.dtype), None


def shear_op(px: torch.Tensor, py: torch.Tensor,
             num_disp: int) -> torch.Tensor:
    """The masked shear assembly at identity affine, differentiable in the
    tap maps."""
    px, py = px.contiguous(), py.contiguous()
    if needs_grad(px, py):
        return _ShearOp.apply(px, py, num_disp)
    return shear_forward(px, py, *_identity_affine(px), num_disp)


def shear_stem_z(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                 num_disp: int) -> torch.Tensor:
    """conv3d(cost_volume_cf(x, y, D), w3) via the shear collapse, pre-BN:
    (B, C, H, W) features -> (B, D, co, H, W), differentiable in x_cf,
    y_cf and w3 (autograd through the tap-map convs, K for the assembly).
    The tap maps and z in x_cf's dtype."""
    px, py = tap_maps(x_cf, y_cf, w3)
    return shear_op(px.to(x_cf.dtype), py.to(x_cf.dtype), num_disp)


def shear_stem_brc(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
                   relu: bool = True) -> torch.Tensor:
    """The serving stem, no autograd: tap maps, then kernel J with the
    folded frozen BatchNorm and the ReLU in its epilogue (as kernel B takes
    them on the default path)."""
    px, py = tap_maps(x_cf, y_cf, w3)
    return shear_forward(px.to(x_cf.dtype).contiguous(),
                         py.to(x_cf.dtype).contiguous(), scale, bias,
                         num_disp, relu)
