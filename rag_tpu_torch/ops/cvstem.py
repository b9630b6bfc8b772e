"""The concat cost volume fused into the matching stem's 3x3x3 conv:
kernel B (forward), kernel E (dX, dY) and kernel F (dW), with
``cvstem_conv`` and ``cvstem_brc`` differentiable. The (B, D, 2C, H, W)
volume never exists on the card, forward or backward.

The volume's load rule is one input policy of the engines of kernels A
and D (csrc/volume_src.cuh::CostVolumeSrc): a staged row of plane p is X's
row from the diagonal j = p on, or Y's row shifted right by p, and zero at
j >= W. ``stage_row``, ``stage_piece``, ``stage_offset`` and
``live_plane`` are its rules in Python, which the CPU tests emulate.

Kernel B, ``cvstem_affine``: conv3d(cost_volume_cf(X, Y, D), w3) * scale +
bias (+ReLU). Replaces rag_tpu/ops/pallas_cvstem.py::cvstem_forward_cf
(body _cvstem_kernel) and its H-tiled form cvstem_forward_cf_v3
(_cvstem_kernel_v3). CUDA source: rag_tpu_torch/csrc/cvstem.cu, kernel A's
engine (csrc/conv3d.cuh: a 3xTF32 implicit GEMM on the tensor cores) with
the cost-volume policy, planned by ``cvstem_plan``. Bound: operations,
45.2 GFLOP at the eval geometry (0.675 ms at 67 TFLOP/s) against ~5 MB of
features read and 157 MB written.

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
index rules, and ``dxy_piece``, ``dxy_stage_base`` and ``dxy_row_pieces``
its bf16 staging rules, which the CPU tests emulate.

Kernel F, ``cvstem_dw``: the stem's weight gradient. Replaces
rag_tpu/ops/pallas_cvstem.py::cvstem_dw_pallas (body _cvstem_dw_kernel).
CUDA source: rag_tpu_torch/csrc/cvstem_bwd.cu, kernel D's register-blocked
float32 engine (csrc/conv3d_dw.cuh) with the cost-volume policy, planned by
``cvstem_dw_plan``. Bound: operations, 24.0 GFLOP at the train shape
(0.358 ms), the forward's products that read a voxel of the volume that is
not a structural zero.

``cvstem_conv`` (pre-affine, for a stem whose BatchNorm trains) and
``cvstem_brc`` (frozen BN folded into the affine) follow
rag_tpu/ops/pallas_cvstem.py's two custom VJPs; ``cvstem_brc``'s backward
recomputes the pre-affine z with one more kernel B pass, as _brc_bwd does.
Each wrapper runs its plain PyTorch version for CPU tensors only; on a
CUDA tensor it launches its kernel or raises.

Dtypes (the bf16-at-rest policy, ops.precision): the features and dz are
float32 or bfloat16, the weights and affine float32. B and F stage the
volume's bf16 rows with cp.async as they are, in their engines' pieces
(B: 8 bytes of four, F: 16 bytes of eight; ops/conv3d.py), at the
float32 instance's plans: a stage that is all Y sits ``stage_offset`` =
p % 4 (B) or p % 8 (F) columns right, so that Y's pieces copy whole at
every plane, and only the X row's diagonal piece and a Y row's piece at
the right edge copy element by element. E copies a bf16 dz plane's rows
with cp.async in pieces (``dxy_piece``: 16 bytes of eight, or 8 bytes of
four) from the piece boundary at or left of its window
(``dxy_stage_base``), into bf16 ring slots it reads that many columns
further on, widening each value as its inner loop reads it. The sums are
the float32 instance's on the upcast inputs bit for bit (but for a zero's
sign). B stores its output
and E dX and dY in the activations' dtype, F stores dW in float32, as
rag_tpu/ops/pallas_cvstem.py does. The plain versions compute in float32
on the upcast inputs and cast to the kernel's output dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.conv3d import (
    CONV_MIN_BLOCKS,
    CONV_MIN_VOXELS,
    CONV_SMS,
    ConvPlan,
    DwPlan,
    _dw_cost_us,
    check_dtypes,
    conv3d_brc_cf_plain,
    conv3d_dw_cf_plain,
    conv_candidates,
    dw_candidates,
    fragment_floats,
    needs_grad,
)
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.precision import wide


# -- the cost volume's load rule (csrc/volume_src.cuh::CostVolumeSrc) --------

def stage_row(half: int, p: int, w: int):
    """The source of a staged row of plane p of the cost volume, in the X
    (half 0) or Y (half 1) half, as (shift, lo, hi): column j reads source
    column j - shift of the feature map's row where lo <= j < hi, and is
    zero elsewhere: left of the diagonal, and at j >= W, where Y[j - p]
    exists but the volume is zero (the reference clips, then masks)."""
    return (p if half else 0), p, w


def stage_piece(half: int, p: int, j0: int, w: int, vec: bool,
                eb: int = 4, n: int = 4):
    """How columns j0 .. j0+n-1 of a row of plane p land in shared memory
    (csrc/volume_src.cuh::stage_piece<n> where rows copy in pieces of n
    elements, ``vec``; else stage_col for each column), for eb-byte
    elements (4: float32, 2: bf16): a list of (copy width in bytes, first
    column of the piece, source column or None for a zero fill). Kernel
    A's engine copies pieces of n = 4 (16 or 8 bytes), kernel D's of 16
    bytes (n = 8 for bf16). One copy of the piece where all n columns are
    inside and the source is aligned to the piece (Y's rows at p % n == 0,
    or any row of a stage offset by ``stage_offset``), one zero fill of it
    where none is; else one element at a time (eb bytes): the piece that
    straddles the diagonal or, offset, W; Y's rows at other planes; every
    piece where W % n != 0."""
    shift, lo, hi = stage_row(half, p, w)
    s0 = j0 - shift
    if vec and lo <= j0 and j0 + n <= hi and s0 % n == 0:
        return [(n * eb, j0, s0)]
    if vec and (j0 + n <= lo or j0 >= hi):
        return [(n * eb, j0, None)]
    return [(eb, j, j - shift if lo <= j < hi else None)
            for j in range(j0, j0 + n)]


def stage_offset(p: int, c0: int, c: int, vec: bool, eb: int = 4,
                 n: int = 4) -> int:
    """The columns right of where a float32 stage starts that a stage of
    plane p whose channels start at c0 sits (csrc/volume_src.cuh::
    CostVolumeSrc::col_offset<n>): p % n for a bf16 stage (eb = 2) that
    copies in pieces of n (``vec``) and is all Y (c0 >= c, the half's
    channel count), so that Y's source j0 - p of its first column
    j0 = w0 - n + p % n lies on a piece boundary; else 0. The engines read
    the stage that many columns further on (kernel A's fragment loads,
    n = 4; kernel D's widening pass, n = 8, shifts it back)."""
    return p % n if eb == 2 and vec and c0 >= c else 0


def live_plane(p: int, w0: int, tw: int) -> bool:
    """Whether plane p of the volume holds a nonzero value under a tile of
    tw columns at w0 and its one-column halo (columns up to w0 + tw):
    plane p is zero left of column p. Kernel B skips the stages of dead
    planes, kernel F the output planes whose three input planes are dead
    (csrc/volume_src.cuh::CostVolumeSrc::last_live_plane)."""
    return p <= w0 + tw


def dw_live_steps(d0: int, n: int, w0: int, tw: int) -> int:
    """The output planes d0 .. d0 + k - 1 of a run of n that a kernel F
    block walks: it stops at the first d whose lowest input plane d - 1 is
    dead, since every later one is too."""
    return max(0, min(n, w0 + tw - d0 + 2))


# Kernel E's tile (csrc/cvstem_dxy.cu): 8 x 64 pixels, 4 per thread kTX apart
DXY_TH, DXY_TW = 8, 64
DXY_RING = 2          # plane slots: the plane in use and the one streaming in
DXY_HALO = 2          # staged columns left of the tile (and right of it)
DXY_PITCH = 80        # floats per staged row
DXY_PITCH_BF16 = 88   # bf16 per staged row of the bf16 instance
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
    smem: int         # dynamic shared memory per block, bytes (float32)

    def smem_for(self, eb: int) -> int:
        """Bytes of shared memory of the instance with eb-byte dz (4:
        float32, 2: bf16): the weights, and two ring slots of kc channels
        x (TH + 2) rows of DXY_PITCH floats or DXY_PITCH_BF16 bf16."""
        pitch = DXY_PITCH if eb == 4 else DXY_PITCH_BF16
        return (4 * 27 * self.kc * self.ct
                + eb * DXY_RING * self.kc * (DXY_TH + 2) * pitch)


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
    plan = DxyPlan(ct, n_cc, chunk, n_chunks, kc, n_wt, n_ht,
                   n_wt * n_ht * n_chunks * 2 * b * n_cc,
                   2 * n_chunks * b * c * h * w, 0)
    return plan._replace(smem=plan.smem_for(4))


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


def dxy_piece_for(w: int, ptr: int, eb: int) -> int:
    """Elements a copy of kernel E's staging moves for dz rows of w
    eb-byte elements at address ptr (csrc/cvstem_dxy.cu::dxy_piece):
    float32 one (a 4-byte cp.async an element); bf16 8 (16-byte pieces)
    where w % 8 == 0 and ptr is 16-byte aligned, else 4 (8-byte pieces)
    where w % 4 == 0 and ptr is 8-byte aligned, else 0 (one element at a
    time by register loads, in the layout of pieces of eight)."""
    if eb == 4:
        return 1
    if w % 8 == 0 and ptr % 16 == 0:
        return 8
    if w % 4 == 0 and ptr % 8 == 0:
        return 4
    return 0


def dxy_piece(dz: torch.Tensor) -> int:
    """``dxy_piece_for`` of a dz tensor."""
    return dxy_piece_for(dz.shape[-1], dz.data_ptr(), dz.element_size())


def dxy_stage_base(half: int, w0: int, q: int, n: int):
    """(base, off): the bf16 instance stages plane q's window for the
    tile at w0 (from ``dxy_window``) in pieces of n from column base, the
    piece boundary at or left of the window's first column, and reads
    window column c at slot column c + off (off = window start - base:
    n - 2 for the dX half, (q - 2) mod n for the dY half). n = 0 (the
    element path) takes the layout of pieces of eight."""
    n = n or 8
    col0 = dxy_window(half, w0, q)
    return col0 - col0 % n, col0 % n


def dxy_row_pieces(base: int, w: int, n: int, h_ok: bool = True):
    """How a staged row of the bf16 instance lands (csrc/cvstem_dxy.cu::
    stage_plane): its pieces from column base, enough to hold the window's
    TW + 2 * HALO columns at any offset, each a list of (copy width in
    bytes, slot column, source column or None for a zero). With pieces (n
    = 8 or 4): one copy of 2n bytes where the piece lies inside [0, w),
    one zero fill of it where it lies outside (or the row is outside
    [0, H), not h_ok); n = 0: every piece of eight element by element (2
    bytes, a zero outside)."""
    size = n or 8
    cols = DXY_TW + 2 * DXY_HALO
    out = []
    for k in range((cols + 2 * size - 2) // size):
        j0 = base + k * size
        if n and (not h_ok or j0 + n <= 0 or j0 >= w):
            out.append([(2 * n, k * n, None)])
        elif n and j0 >= 0 and j0 + n <= w:
            out.append([(2 * n, k * n, j0)])
        else:
            out.append([(2, k * size + e,
                         j0 + e if h_ok and 0 <= j0 + e < w else None)
                        for e in range(size)])
    return out


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
    volume, then the adjoint of the volume build, in float32 (or float64)
    on the upcast dz; dX and dY in dz's dtype."""
    out_dtype = dz.dtype
    dz = wide(dz)
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
    return dx.to(out_dtype), dy.to(out_dtype)


def cvstem_dw_plain(x_cf: torch.Tensor, y_cf: torch.Tensor, dz: torch.Tensor,
                    num_disp: int) -> torch.Tensor:
    """Plain PyTorch version of kernel F: kernel D's plain version on the
    materialized volume."""
    return conv3d_dw_cf_plain(_volume(x_cf, y_cf, num_disp), dz)


# Kernel B: the (mt, nt, db) instances of kernel A's engine compiled with
# the cost-volume policy (csrc/cvstem.cu): those its plans take at the
# eval and train geometries and chip_smoke.py's small shapes, and the
# others scripts/torch_stem_sweep.py times beside them
CVSTEM_INSTANCES = frozenset([(2, 1, 1), (2, 2, 1), (4, 1, 1), (4, 2, 1),
                              (2, 1, 4), (2, 2, 4), (4, 1, 4)])
# conv_candidates' cost of a staged row under the policy: kernel A's 6 for
# a row of 16-byte copies, four times that for the Y half's rows at three
# planes in four (4-byte copies), averaged over the two halves
CVSTEM_ROW_COST = 13
# kernel F: a staged x piece's issue slots, in 16-byte copies, averaged
# over the halves: X's rows copy 16 bytes, Y's 4 bytes at three planes in
# four
CVSTEM_DW_X_COPIES = (1 + 0.25 + 0.75 * 4) / 2
# kernel F's instances of kernel D's engine -> registers a thread (ptxas,
# sm_90a, CUDA 12.8), as conv3d.py::DW_INSTANCES for kernel D
CVSTEM_DW_REGS = {(1, 3): 72, (4, 3): 127, (8, 3): 168, (12, 1): 108}


def cvstem_candidates(b: int, d: int, c: int, h: int, w: int, cout: int):
    """Kernel B's blockings: kernel A's candidates for the (b, d, 2c, h, w)
    volume among CVSTEM_INSTANCES, with the policy's staging cost."""
    return conv_candidates(b, d, 2 * c, h, w, cout,
                           instances=CVSTEM_INSTANCES,
                           row_cost=CVSTEM_ROW_COST)


@functools.lru_cache(maxsize=None)
def cvstem_plan(b: int, d: int, c: int, h: int, w: int,
                cout: int) -> ConvPlan:
    """Kernel B's plan for features (b, c, h, w) and d planes: the first of
    ``cvstem_candidates`` by (enough blocks, estimated cost), as
    conv_plan chooses. At the eval and train geometries it is kernel A's
    plan for the volume, 4 x 32 tiles of four planes a block and both
    n-tiles (112 x 16 of K x N per stage of one half): 4-5 % slower than
    the fastest of the 19 plans timed by scripts/torch_stem_sweep.py on
    the H100 at both (16 x 16 tiles of one plane a block, which A's cost
    model, made for stored volumes, ranks below four planes a block)."""
    return min(cvstem_candidates(b, d, c, h, w, cout),
               key=lambda t: (t[0], t[1]))[2]


def cvstem_live_share(plan: DwPlan, d: int, w: int) -> float:
    """The share of kernel F's block plane steps that run under a plan
    (``dw_live_steps`` over its runs and W tiles)."""
    live = sum(dw_live_steps(dc * plan.db, min(plan.db, d - dc * plan.db),
                             wt * plan.tw, plan.tw)
               for dc in range(plan.n_dc) for wt in range(plan.n_wt))
    return live / (plan.n_wt * d)


@functools.lru_cache(maxsize=None)
def cvstem_dw_plan(b: int, d: int, c: int, h: int, w: int,
                   cout: int) -> DwPlan:
    """Kernel F's blocking: kernel D's candidates for the (b, d, 2c, h, w)
    volume (at 2c = 24, two channel chunks of 12, one half each), chosen
    as dw_plan chooses, with the policy's cost: CVSTEM_DW_X_COPIES per
    staged x piece, F's registers (CVSTEM_DW_REGS), only the plane steps
    that run
    (``cvstem_live_share``), and a tail: blocks left of the diagonal stop
    early, so runs differ in length and an SM's last block runs alone,
    which adds one block's share, 1 / (blocks per SM), to the estimate.
    At the train shape the choice (8 x 16 tiles, runs of 16 planes, 2048
    blocks) is within 0.1 % of the fastest of the 92 blockings timed by
    scripts/torch_stem_sweep.py on the H100; without the tail the estimate
    took runs of 64 planes, 15.6 % slower."""
    big = b * d * h * w >= CONV_MIN_VOXELS
    return min(dw_candidates(b, d, 2 * c, h, w, cout),
               key=lambda p: (big and p.blocks < CONV_MIN_BLOCKS,
                              _dw_cost_us(p, CVSTEM_DW_X_COPIES,
                                          cvstem_live_share(p, d, w),
                                          CVSTEM_DW_REGS)
                              * (1 + 1 / -(-p.blocks // CONV_SMS)),
                              p.n_pos))


def _check_stem(name, x_cf, y_cf, nd):
    if x_cf.dim() != 4 or y_cf.shape != x_cf.shape or nd < 1:
        raise ValueError(f"{name}: unsupported x {tuple(x_cf.shape)}, y "
                         f"{tuple(y_cf.shape)}, num_disp {nd}")


def cvstem_affine(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
                  relu: bool = True) -> torch.Tensor:
    """Kernel B, no autograd. x_cf, y_cf: (B, C, H, W) left/right
    features; w3: (3,3,3,2C,Cout); returns (B, num_disp, Cout, H, W)."""
    if not x_cf.is_cuda:
        return cvstem_brc_plain(x_cf, y_cf, w3, scale, bias, num_disp, relu)
    _check_stem("cvstem_affine", x_cf, y_cf, num_disp)
    b, c, h, w = x_cf.shape
    cout = w3.shape[4]
    if (w3.shape[:4] != (3, 3, 3, 2 * c) or scale.shape != (cout,)
            or bias.shape != (cout,)):
        raise ValueError(f"cvstem_affine: unsupported w {tuple(w3.shape)}")
    check_dtypes("cvstem_affine", (x_cf, y_cf), (w3, scale, bias))
    return launch_cvstem(x_cf, y_cf, w3, scale, bias, num_disp, relu,
                         cvstem_plan(b, num_disp, c, h, w, cout))


def launch_cvstem(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
                  relu: bool, plan: ConvPlan) -> torch.Tensor:
    """Launch kernel B (kernel A's weight pass, then the conv of the cost
    volume) on the current stream with a given plan. Counts one launch on
    ``cvstem_affine``."""
    b, c, h, w = x_cf.shape
    cout = w3.shape[4]
    frag = torch.empty(fragment_floats(plan), device=x_cf.device,
                       dtype=torch.float32)
    out = torch.empty((b, num_disp, cout, h, w), device=x_cf.device,
                      dtype=x_cf.dtype)
    rc = cuda_lib.entry("rag_cvstem_brc", x_cf.dtype)(
        x_cf.data_ptr(), y_cf.data_ptr(), w3.data_ptr(), frag.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, h, w,
        num_disp, cout, int(relu), plan.mt, plan.nt, plan.tw, plan.n_split,
        plan.cc, plan.db, cuda_lib.stream_ptr(x_cf))
    cuda_lib.count(cvstem_affine, x_cf.dtype)
    cuda_lib.check(rc, "cvstem_affine")
    return out


cvstem_affine.launches = cvstem_affine.launches_bf16 = 0


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
    check_dtypes("cvstem_dxy", (dz,), (w3,))
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
    dx = torch.empty((b, c, h, w), device=dz.device, dtype=dz.dtype)
    dy = torch.empty_like(dx)
    rc = cuda_lib.entry("rag_cvstem_dxy", dz.dtype)(
        dz.data_ptr(), wpk.data_ptr(), partial.data_ptr(), dx.data_ptr(),
        dy.data_ptr(), b, d, cout, c, h, w, plan.ct, plan.n_cc, plan.chunk,
        plan.n_chunks, plan.kc, cuda_lib.stream_ptr(dz))
    cuda_lib.count(cvstem_dxy, dz.dtype)
    cuda_lib.check(rc, "cvstem_dxy")
    return dx, dy


cvstem_dxy.launches = cvstem_dxy.launches_bf16 = 0


def cvstem_dw(x_cf: torch.Tensor, y_cf: torch.Tensor, dz: torch.Tensor,
              num_disp: int) -> torch.Tensor:
    """Kernel F, no autograd: the stem's dW (3,3,3,2C,Cout) for the
    pre-affine cotangent dz (B, num_disp, Cout, H, W)."""
    if not x_cf.is_cuda:
        return cvstem_dw_plain(x_cf, y_cf, dz, num_disp)
    _check_stem("cvstem_dw", x_cf, y_cf, num_disp)
    b, c, h, w = x_cf.shape
    if dz.dim() != 5 or dz.shape[:2] != (b, num_disp) \
            or dz.shape[3:] != (h, w):
        raise ValueError(f"cvstem_dw: x {tuple(x_cf.shape)}, dz "
                         f"{tuple(dz.shape)}")
    check_dtypes("cvstem_dw", (x_cf, y_cf, dz))
    return launch_cvstem_dw(x_cf, y_cf, dz, cvstem_dw_plan(
        b, num_disp, c, h, w, dz.shape[2]))


cvstem_dw.launches = cvstem_dw.launches_bf16 = 0


def launch_cvstem_dw(x_cf: torch.Tensor, y_cf: torch.Tensor, dz: torch.Tensor,
                     plan: DwPlan, passes: int = 3) -> torch.Tensor:
    """Launch kernel F on the current stream with a given plan: the blocks'
    partials into a workspace (bit 1 of ``passes``), then their sum in a
    fixed order (bit 2), as kernel D's launch_dw_plan. Counts one launch on
    ``cvstem_dw``."""
    b, c, h, w = x_cf.shape
    d, cout = dz.shape[1], dz.shape[2]
    partial = torch.empty(plan.workspace, device=dz.device,
                          dtype=torch.float32)
    out = torch.empty((3, 3, 3, 2 * c, cout), device=dz.device,
                      dtype=torch.float32)
    rc = cuda_lib.entry("rag_cvstem_dw", dz.dtype)(
        x_cf.data_ptr(), y_cf.data_ptr(), dz.data_ptr(), partial.data_ptr(),
        out.data_ptr(), b, d, c, cout, h, w, plan.ci, plan.co_t, plan.kh_t,
        plan.groups, plan.th, plan.tw, plan.db, passes,
        cuda_lib.stream_ptr(dz))
    cuda_lib.count(cvstem_dw, dz.dtype)
    cuda_lib.check(rc, "cvstem_dw")
    return out


class _CvstemConv(torch.autograd.Function):
    """rag_tpu/ops/pallas_cvstem.py::cvstem_conv's VJP: E for dX/dY, F for
    dW, each only where a gradient is needed."""

    @staticmethod
    def forward(ctx, x_cf, y_cf, w3, num_disp):
        cout = w3.shape[4]
        ctx.save_for_backward(x_cf, y_cf, w3)
        ctx.num_disp = num_disp
        return cvstem_affine(x_cf, y_cf, w3, w3.new_ones(cout),
                             w3.new_zeros(cout), num_disp, False)

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
        gm = wide(g * (out > 0) if ctx.relu else g)
        dx = dy = dw = dscale = dbias = None
        if need_bias:
            dbias = gm.sum(dim=(0, 1, 3, 4))
        if need_scale:
            cout = w3.shape[4]
            z = cvstem_affine(x_cf, y_cf, w3, w3.new_ones(cout),
                              w3.new_zeros(cout), nd, False)
            dscale = (gm * wide(z)).sum(dim=(0, 1, 3, 4))
        # the cotangent of z in the features' dtype (_brc_bwd's cast)
        dz = (gm * scale.reshape(1, 1, -1, 1, 1)).to(x_cf.dtype).contiguous()
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
    return cvstem_affine(x_cf, y_cf, w3, w3.new_ones(cout),
                         w3.new_zeros(cout), num_disp, False)


def cvstem_brc(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, num_disp: int,
               relu: bool = True) -> torch.Tensor:
    """conv3d(cost_volume_cf(X, Y, num_disp), w3) * scale + bias (+ReLU),
    differentiable in every tensor. x_cf, y_cf: (B, C, H, W); w3:
    (3,3,3,2C,Cout); returns (B, num_disp, Cout, H, W)."""
    if needs_grad(x_cf, y_cf, w3, scale, bias):
        return _CvstemBRC.apply(x_cf, y_cf, w3, scale, bias, num_disp, relu)
    return cvstem_affine(x_cf, y_cf, w3, scale, bias, num_disp, relu)
