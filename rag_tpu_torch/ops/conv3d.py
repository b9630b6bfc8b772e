"""The 3x3x3 stride-1 conv of the matching net on a channel-first
(B, D, Cin, H, W) volume: kernel A (forward, and dx in the backward), its
D-blocked variant kernel H, and kernel D (the weight gradient), with
``conv3d_brc_cf`` differentiable.

Kernel A, ``conv3d_affine_cf``: conv + per-channel affine + optional ReLU.
Replaces the TPU kernel rag_tpu/ops/pallas_conv3d.py::_conv3d_pallas_cf
(kernel bodies _conv3d_kernel and, at the eval geometry, the H-tiled
_conv3d_kernel_v3). CUDA source: rag_tpu_torch/csrc/conv3d.cu on the
engine of csrc/conv3d.cuh. Bound on the H100: operations. At the eval
geometry ``stem_3d1`` alone is 2*27*12*12*64*160*320 = 25.5 GFLOP on a 157
MB input (0.38 ms at the fp32 non-tensor peak of 67 TFLOP/s, 0.15 ms for
the three TF32 products of each at 495 TFLOP/s, against 0.09 ms to move
its bytes). The design is an implicit GEMM on the tensor cores
(``mma.sync`` m16n8k8 in 3xTF32: float32 accuracy from three TF32
products), with the input slab of each stage streaming into shared memory
while the previous one is multiplied. ``conv_plan`` picks the tile, the
Cout split and the output planes per block per shape; ``split_tf32`` and
``pack_weights_tf32`` are the plain version of the kernel's first pass,
which splits the weights and writes them in the mma's fragment order.

Kernel D, ``conv3d_dw_cf``: the weight gradient
``dW[kd,kh,kw,ci,co] = sum_{b,d,h,w} x[b,d+kd-1,ci,h+kh-1,w+kw-1] dz[b,d,co,h,w]``.
Replaces rag_tpu/ops/pallas_conv3d.py::conv3d_dw_pallas_pre (body
_conv3d_dw_kernel), whose grid carries the sum in one revisited output
block. CUDA source: rag_tpu_torch/csrc/conv3d_dw.cu on the engine of
csrc/conv3d_dw.cuh, a register-blocked float32 kernel on the CUDA cores.
Bound: operations at every train shape with Cout >= 4 (15.9 GFLOP at
``stem_3d1``'s, 0.24 ms at 67 TFLOP/s), bytes at the Cout-1 head. A thread
owns one (ci, kd), kh_t of its kh taps (1, or all 3 at co_t <= 8) and the
three kw taps x co_t output channels; walking staged rows four columns at
a time it reads kh_t float4s of x and co_t float4 broadcasts of dz for
12*kh_t*co_t FMAs (20.6 per shared load at co_t 4, kh_t 3). ``dw_plan``
cuts the work into blocks of (b, run of output planes, tile of rows x
columns, input-channel chunk, Cout chunk) that fill the card; each block
walks its planes with the next input plane and dz plane landing by
cp.async while the current one multiplies, adds its row groups' sums in a
fixed order and writes one partial dW; a second kernel sums the partials
in a fixed order: no float atomics, the same bits on every run.

``conv3d_brc_cf`` is the entry point. Without a gradient it is one fused
kernel A call. With one it runs kernel A at identity affine, keeps the
pre-affine ``z`` and applies the affine and ReLU outside, as
rag_tpu/ops/pallas_conv3d.py::_fwd_cf does; the backward (_bwd_cf) is
kernel A again on the masked cotangent with flipped, io-transposed,
scale-folded weights for dx, and kernel D post-scaled for dW.

Kernel H, ``conv3d_dblock_cf``: the D-blocked form of the same conv
(rag_tpu's v4 tiling), taken for the forward and dx where
``KernelVariants.conv3d_dblock`` is set. It is kernel A's engine with
``conv_plan_dblock``'s plans, which put four output planes in every block
(db = 4); its launches count on ``conv3d_dblock_cf``.

Kernels B and F (ops/cvstem.py) run the engines of A and D on the
matching stem's cost volume, with plans from the same candidates.

Weights stay in the reference's (3, 3, 3, Cin, Cout) layout; kernel A's
first pass packs them per call. Each wrapper runs its plain PyTorch version
for CPU tensors only; on a CUDA tensor it launches its kernel or raises.

Dtypes (the bf16-at-rest policy, ops.precision): x, and the dx conv's
cotangent, are float32 or bfloat16; weights, scale and bias float32. A
bf16 volume is staged with cp.async as it is, at the float32 instance's
plan: A and H copy 8-byte pieces of four elements into a bf16 slab and
widen it as their fragments load (two TF32 products a multiply-add where
float32 takes three: a bf16 value's TF32 lo part is zero); D copies
16-byte pieces of eight into a landing slab and widens each plane into
its float32 slots in one pass (``dw_smem_bytes``, ``widen_landed``). The
sums are the float32 instance's on the upcast input bit for bit (but for
a zero's sign); A and H store the output in x's dtype, D stores dW in
float32, as rag_tpu/ops/pallas_conv3d.py's kernels do. The plain
versions follow the same rule: a float32 computation on the upcast input,
the output cast to the kernel's output dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.precision import wide
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants


def co_tile(cout: int) -> int:
    """The widest Cout chunk kernel D's plans consider: the one that wastes
    the fewest padded channels among 1, 4, 8, 12 and 16."""
    if cout == 1:
        return 1
    if cout <= 8:
        return 4 if cout <= 4 else 8
    if cout % 16 == 0:
        return 16
    if cout % 12 == 0:
        return 12
    return 16


# Kernel A's tiling (csrc/conv3d.cu): 4 warps, each MT m-tiles of 16 pixels
# along W by NT n-tiles of 8 output channels; a tile is tw wide, 64*MT/tw rows
CONV_TILES = ((4, 64), (4, 32), (4, 16), (2, 64), (2, 32), (2, 16))
# (mt, nt, db) the kernel is compiled for: m-tiles per warp, n-tiles per
# block, output planes per block
CONV_INSTANCES = frozenset(
    [(2, nt, 1) for nt in (1, 2, 3, 4, 6)]
    + [(4, nt, 1) for nt in (1, 2, 3, 4)]
    + [(2, 1, 4), (2, 2, 4), (4, 1, 4), (2, 3, 4)])
# the instances only kernel H's plans take: (2, 3, 4) was measured faster
# than every other db = 4 plan at Cout 24 and 48 (scripts/
# torch_dblock_sweep.py); (2, 4, 4) and (4, 2, 4) were not kept (3 % at one
# shape, none)
CONV_DBLOCK_ONLY = frozenset([(2, 3, 4)])
CONV_NT = (1, 2, 3, 4, 6)
CONV_MAX_CC = 16              # input channels per stage
CONV_SMS = 132                # streaming multiprocessors of the H100 SXM
CONV_MIN_BLOCKS = 2 * CONV_SMS
CONV_MIN_VOXELS = CONV_MIN_BLOCKS * 128


class ConvPlan(NamedTuple):
    """Kernel A's blocking of one call (csrc/conv3d.cu's arguments). The
    plan takes shapes only, so float32 and bf16 run the same one;
    ``smem`` is the float32 instance's bytes, ``smem_for`` either's."""
    mt: int           # m-tiles (16 pixels) per warp
    nt: int           # n-tiles (8 output channels) per block
    tw: int           # tile columns
    th: int           # tile rows
    n_split: int      # blocks across Cout
    cc: int           # input channels per stage
    n_cc: int         # stages per input plane
    ksteps: int       # k-steps of 8 per stage (9 * cc padded)
    n_wt: int         # tiles along W
    n_ht: int         # tiles along H
    db: int           # output planes per block
    blocks: int       # blocks per launch
    smem: int         # dynamic shared memory per block, bytes (float32)

    def smem_for(self, eb: int) -> int:
        """Bytes of shared memory of the instance with eb-byte
        activations (4: float32, 2: bf16)."""
        return conv_smem_bytes(self.cc, self.th, self.tw, self.ksteps, eb)


def _chan_stride(th: int, tw: int, eb: int = 4) -> int:
    """Elements per staged channel (csrc/conv3d.cuh::chan_stride): rows of
    tw + 8 columns, the channel 8 mod 32 words long (float32: 8 mod 32
    elements; bf16, eb = 2: 16 mod 64), so that the four k-columns of a
    fragment load sit on separate banks."""
    n = 32 * 4 // eb
    return ((th + 2) * (tw + 8) + n - 32 // eb - 1) // n * n + 32 // eb


def conv_smem_bytes(cc: int, th: int, tw: int, ksteps: int,
                    eb: int = 4) -> int:
    """Kernel A's shared memory (csrc/conv3d.cuh::conv_setup): two staging
    buffers of cc channels of eb-byte elements, and the k table."""
    return eb * 2 * cc * _chan_stride(th, tw, eb) + 4 * 8 * ksteps


def conv_candidates(b: int, d: int, cin: int, h: int, w: int, cout: int,
                    dblock: bool = False, instances=CONV_INSTANCES,
                    row_cost: int = 6):
    """Every blocking of kernel A's engine for x (b, d, cin, h, w) -> cout
    channels among the compiled ``instances`` (mt, nt, db), as (not enough
    blocks, estimated cost, plan). Where the output holds at least
    CONV_MIN_VOXELS voxels (b*d*h*w) a plan needs at least two waves of
    blocks; a smaller shape needs a tile at least half full. The cost: the
    blocks' warp instructions (per staged input plane: 8 per 16 pixels and
    k-step for the A fragments, ``row_cost`` per staged row; per output
    plane and tap: 7 per 16 pixels, k-step and n-tile for the B load and 3
    mma), scaled up where the grid leaves an SM fewer than four blocks;
    then bigger and wider tiles. Four output planes share a block (db = 4)
    only with tiles of at least four rows, and, unless ``dblock`` (kernel
    H, which takes db = 4 alone), with one n-tile, or two with at least 12
    input channels per stage: where that was measured faster than db = 1 on
    the H100 for kernel A. Kernel H's plans take tiles at most 32 columns
    wide: at db = 4 the 64-wide ones were measured slower than the best
    other tile at every main-path shape (scripts/
    torch_dblock_sweep.py)."""
    n_cc = -(-cin // CONV_MAX_CC)
    cc = -(-cin // n_cc)
    ksteps = -(-9 * cc // 8)
    n_nt = -(-cout // 8)
    splits = []
    for n_split in range(1, n_nt + 1):
        need = -(-n_nt // n_split)
        if need > CONV_NT[-1]:
            continue
        nt = min(x for x in CONV_NT if x >= need)
        if (n_split - 1) * nt * 8 < cout:      # no split left empty
            splits.append((n_split, nt))
    big = b * d * h * w >= CONV_MIN_VOXELS
    for mt, tw in CONV_TILES:
        if dblock and tw > 32:
            continue
        th = 64 * mt // tw
        n_wt, n_ht = -(-w // tw), -(-h // th)
        fill = ((w - (n_wt - 1) * tw) / tw) * ((h - (n_ht - 1) * th) / th)
        m_tiles = th * tw // 16
        for (n_split, nt), db in ((s_, db) for s_ in splits
                                  for db in ((4,) if dblock else (1, 4))):
            if (mt, nt, db) not in instances or (db == 4 and (
                    th < 4 or (not dblock and (
                        (mt, nt, db) in CONV_DBLOCK_ONLY
                        or (nt == 2 and cc < 12))))):
                continue
            blocks = n_wt * n_ht * -(-d // db) * b * n_split
            per_block = (db + 2) * n_cc * (m_tiles * ksteps * 8
                                           + cc * (th + 2) * row_cost) \
                + 3 * db * n_cc * m_tiles * ksteps * 7 * nt
            plan = ConvPlan(mt, nt, tw, th, n_split, cc, n_cc, ksteps, n_wt,
                            n_ht, db, blocks,
                            conv_smem_bytes(cc, th, tw, ksteps))
            ok = blocks >= CONV_MIN_BLOCKS if big else fill >= 0.5
            # the work of all blocks, scaled up where the grid leaves an SM
            # fewer than four blocks to hide latency with
            key = (blocks * per_block * (1 + 1 / min(blocks / CONV_SMS, 4)),
                   -th * tw, -tw)
            yield not ok, key, plan


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, d: int, cin: int, h: int, w: int,
              cout: int) -> ConvPlan:
    """Kernel A's tile, Cout split and planes per block for x (b, d, cin,
    h, w) -> cout channels: the first of ``conv_candidates`` by (enough
    blocks, estimated cost)."""
    return min(conv_candidates(b, d, cin, h, w, cout),
               key=lambda c: (c[0], c[1]))[2]


@functools.lru_cache(maxsize=None)
def conv_plan_dblock(b: int, d: int, cin: int, h: int, w: int,
                     cout: int) -> ConvPlan:
    """Kernel H's plan: kernel A's engine with four output planes a block
    (db = 4), the first of the db = 4 candidates by the same rule. One
    exists at every shape: the (mt, 1, 4) instances with a tile of at
    least four rows and at most 32 columns and ceil(Cout / 8) splits
    always qualify. On the 29 conv shapes of a request and a task-0 step
    the choice is within 1 % of the fastest db = 4 plans timed."""
    return min(conv_candidates(b, d, cin, h, w, cout, dblock=True),
               key=lambda c: (c[0], c[1]))[2]


def conv_block_region(plan: ConvPlan, bx: int, by: int, bz: int):
    """The outputs block (bx, by, bz) of a plan computes, as the kernel
    decodes its index: (b, output planes, output channels, rows, columns),
    the last four as ranges not clipped to the volume."""
    wt, ht = bx % plan.n_wt, bx // plan.n_wt
    b, ns = bz // plan.n_split, bz % plan.n_split
    return (b, range(by * plan.db, (by + 1) * plan.db),
            range(ns * plan.nt * 8, (ns + 1) * plan.nt * 8),
            range(ht * plan.th, (ht + 1) * plan.th),
            range(wt * plan.tw, (wt + 1) * plan.tw))


# Kernel D's blocking (csrc/conv3d_dw.cu)
DW_MAX_THREADS = 288          # 9 warps a block
DW_MAX_CI = 16                # input channels per block
DW_MAX_SMEM = 110 * 1024      # bytes of shared memory: two blocks an SM
DW_MAX_WORKSPACE = 8 << 20    # floats of partials (32 MB)
DW_SEGS = 8                   # partial segments per output in the sum pass
# (co_t, kh_t) the kernel is compiled for -> registers a thread (ptxas,
# sm_90a, CUDA 12.8), which set how many blocks an SM holds. All three kh
# taps a thread up to 8 output channels; at 12 the 108 sums would leave
# no registers, so one tap (the fastest at stem_3d1's 12 -> 12 in the
# blocking sweeps)
DW_INSTANCES = {(1, 3): 56, (4, 3): 96, (8, 3): 168, (12, 1): 106}


class DwPlan(NamedTuple):
    """Kernel D's blocking of one call (csrc/conv3d_dw.cu's arguments).
    Shapes only, so float32 and bf16 run the same plan; ``smem`` is the
    float32 instance's bytes, ``smem_for`` either's."""
    ci: int           # input channels per block
    n_ci: int         # blocks across Cin
    co_t: int         # output channels per block (and thread)
    n_co: int         # blocks across Cout
    kh_t: int         # kh taps per thread: 1 or all 3
    groups: int       # row groups per block of 9 * ci / kh_t threads
    th: int           # tile rows
    tw: int           # tile columns
    db: int           # output planes per block
    n_dc: int         # runs of planes along D
    n_ht: int         # tiles along H
    n_wt: int         # tiles along W
    threads: int      # per block
    n_pos: int        # partials per output: b * n_dc * n_ht * n_wt
    blocks: int       # blocks of the first pass
    workspace: int    # floats of partials
    smem: int         # dynamic shared memory per block, bytes (float32)

    def smem_for(self, eb: int) -> int:
        """Bytes of shared memory of the instance with eb-byte
        activations (4: float32, 2: bf16)."""
        return dw_smem_bytes(self.ci, self.co_t, self.th, self.tw, eb)


def _pitch(n: int, r: int) -> int:
    """The least p >= n with p % 32 == r (n >= r)."""
    return (n - r + 31) // 32 * 32 + r


def dw_smem_bytes(ci: int, co_t: int, th: int, tw: int, eb: int = 4) -> int:
    """Bytes of kernel D's shared memory (csrc/conv3d_dw.cuh::dw_run):
    four float32 x-plane slots of ci channels x (th + 2) rows of a row
    pitch = 12 mod 32, the channel pitch = 4 mod 32, and two float32 dz
    slots of co_t x th rows of tw + 4; with eb = 2 (bf16) one dz slot and
    the landing slab, one x plane (rows of tw + 16: 16-byte pieces from
    w0 - 8) and one dz plane of bf16 without pitch padding. At least the
    row groups' float32 sum buffer."""
    rs = _pitch(tw + 8, 12)
    cs = _pitch((th + 2) * rs, 4)
    slots = 4 * ci * cs + (2 if eb == 4 else 1) * co_t * th * (tw + 4)
    landing = 0 if eb == 4 else ci * (th + 2) * (tw + 16) + co_t * th * tw
    return max(4 * slots + eb * landing, 4 * 27 * ci * co_t)


def dw_blocking(b: int, d: int, cin: int, h: int, w: int, cout: int,
                th: int, tw: int, db: int, co_t: int, kh_t: int) -> DwPlan:
    """Kernel D's plan for a given tile (th rows x tw columns), db output
    planes per block, co_t output channels per block and kh_t kh taps per
    thread (a key of DW_INSTANCES): input-channel chunks of at most
    DW_MAX_CI, the most row groups (1, 2, 4, 8 or 16, dividing th) within
    DW_MAX_THREADS, and the counts that follow."""
    n_ci = -(-cin // DW_MAX_CI)
    ci = -(-cin // n_ci)
    owners = 9 * ci // kh_t
    groups = max(p for p in (1, 2, 4, 8, 16)
                 if th % p == 0 and owners * p <= DW_MAX_THREADS)
    n_dc, n_ht, n_wt = -(-d // db), -(-h // th), -(-w // tw)
    n_pos = b * n_dc * n_ht * n_wt
    n_co = -(-cout // co_t)
    return DwPlan(ci, n_ci, co_t, n_co, kh_t, groups, th, tw, db, n_dc,
                  n_ht, n_wt, owners * groups, n_pos, n_pos * n_ci * n_co,
                  n_pos * 27 * cin * cout, dw_smem_bytes(ci, co_t, th, tw))


# dw_plan's cost model, fitted to the blockings timed by
# scripts/torch_dw_sweep.py on the H100: warp instructions issue at
# DW_IPC a cycle and scheduler while an SM holds at least DW_FULL_WARPS
# warps (proportionally less below), each plane step of a block waits
# DW_STEP_CYCLES beyond its instructions (not the copies' latency: a
# deeper ring did not shorten it), which the other blocks an SM holds
# hide, and a staged 16-byte copy costs DW_COPY_ISSUE issue slots
DW_IPC, DW_FULL_WARPS, DW_STEP_CYCLES, DW_COPY_ISSUE = 0.6, 12, 3000, 32
DW_CLOCK_MHZ = 1755


def _dw_cost_us(p: DwPlan, x_copies: float = 1.0, live: float = 1.0,
                regs=DW_INSTANCES) -> float:
    """dw_plan's estimate of a plan's time, in microseconds. A staged x
    piece costs ``x_copies`` 16-byte copies' issue slots, a share ``live``
    of the blocks' plane steps runs, and ``regs`` gives the instances'
    registers (kernel F's input policy: ops/cvstem.py::cvstem_dw_plan)."""
    warps = -(-p.threads // 32)
    per_sm = min(65536 // (32 * warps * regs[(p.co_t, p.kh_t)]),
                 (228 << 10) // (p.smem + 1024), 64 // warps, 32)
    chunk = 12 * p.kh_t * p.co_t + p.kh_t + p.co_t + 3
    step = warps * (p.th // p.groups) * ((p.tw // 4) * chunk + 8 * p.kh_t) \
        + -(-(x_copies * p.ci * (p.th + 2) * (p.tw + 8)
              + p.co_t * p.th * p.tw) // (4 * 32)) * DW_COPY_ISSUE
    n_sm = -(-p.blocks // CONV_SMS)
    held = min(per_sm, n_sm)
    ipc = DW_IPC * min(1.0, held * warps / DW_FULL_WARPS)
    cycles = n_sm * (p.db * live + 1) * (step / (4 * ipc)
                                         + DW_STEP_CYCLES / held)
    # the sum pass: the workspace written and read at 2.5 TB/s, and its
    # rounds of eight loads
    return (cycles / DW_CLOCK_MHZ + 2 * p.workspace * 4 / 2.5e6
            + -(-p.n_pos // (DW_SEGS * 8)) * 0.6)


def dw_candidates(b: int, d: int, cin: int, h: int, w: int, cout: int):
    """Every blocking dw_plan weighs: tiles of 1-16 rows x 16, 32 or 64
    columns, every run of planes, each compiled (co_t, kh_t) with co_t
    from 4 up to co_tile(cout) (1 at Cout 1), within DW_MAX_SMEM and
    DW_MAX_WORKSPACE."""
    for co_t, kh_t in DW_INSTANCES:
        if (co_t == 1) != (cout == 1) or co_t > co_tile(cout):
            continue
        for tw in (16, 32, 64):
            for th in (1, 2, 4, 8, 16):
                for db in sorted({-(-d // n) for n in range(1, d + 1)}):
                    p = dw_blocking(b, d, cin, h, w, cout, th, tw, db, co_t,
                                    kh_t)
                    if p.smem <= DW_MAX_SMEM and \
                            p.workspace <= DW_MAX_WORKSPACE:
                        yield p


@functools.lru_cache(maxsize=None)
def dw_plan(b: int, d: int, cin: int, h: int, w: int, cout: int) -> DwPlan:
    """Kernel D's blocking for x (b, d, cin, h, w) and dz with cout
    channels, among dw_candidates. Where the output holds at least
    CONV_MIN_VOXELS positions the first pass gets at least two waves of
    blocks (CONV_MIN_BLOCKS). Among those, the least estimated time
    (_dw_cost_us): per block, warp instructions per plane (12*kh_t*co_t
    FMAs, kh_t + co_t shared loads and 3 of loop per thread and 4
    columns, 8 per row and kh tap; DW_COPY_ISSUE per 16-byte copy staged)
    issued at a rate set by the warps an SM holds, and a wait of
    DW_STEP_CYCLES shared by the blocks an SM holds, over its planes and
    one more, on the most loaded SM; plus the workspace's bytes written
    and read and the sum pass's rounds of eight loads. Ties go to fewer
    partials. On the five shapes of a task-0 step the choice is within
    2 % of the fastest blocking timed."""
    big = b * d * h * w >= CONV_MIN_VOXELS
    return min(dw_candidates(b, d, cin, h, w, cout),
               key=lambda p: (big and p.blocks < CONV_MIN_BLOCKS,
                              _dw_cost_us(p), p.n_pos))


def dw_block_region(plan: DwPlan, bx: int, by: int, bz: int):
    """What block (bx, by, bz) of a plan's first pass sums, as the kernel
    decodes its index: (b, output planes, rows, columns, input channels,
    output channels), the last five as ranges not clipped to the volume.
    Its partial is row bx of the workspace."""
    wt, r = bx % plan.n_wt, bx // plan.n_wt
    ht, r = r % plan.n_ht, r // plan.n_ht
    dc, b = r % plan.n_dc, r // plan.n_dc
    return (b, range(dc * plan.db, (dc + 1) * plan.db),
            range(ht * plan.th, (ht + 1) * plan.th),
            range(wt * plan.tw, (wt + 1) * plan.tw),
            range(by * plan.ci, (by + 1) * plan.ci),
            range(bz * plan.co_t, (bz + 1) * plan.co_t))


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits) as the card's
    cvt.rna.tf32.f32 does: to nearest, ties away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def widen_bits(h: torch.Tensor) -> torch.Tensor:
    """bf16 -> float32 as the kernels widen a staged element
    (csrc/async_copy.cuh::widen_bits): its 16 bits shifted to the top of
    a float32's 32."""
    return (h.contiguous().view(torch.int16).to(torch.int32) << 16).view(
        torch.float32)


def widen_landed(landed: torch.Tensor, lead: int, cols: int) -> torch.Tensor:
    """Kernel D's widening pass over bf16 rows on the last axis
    (csrc/conv3d_dw.cuh::widen_rows): ``cols`` float32 columns, column c
    landed column c + lead, zero where that lies outside the landed row."""
    n = landed.shape[-1]
    out = torch.zeros((*landed.shape[:-1], cols), dtype=torch.float32)
    c0, c1 = max(0, -lead), min(cols, n - lead)
    out[..., c0:c1] = widen_bits(landed[..., c0 + lead:c1 + lead])
    return out


def split_tf32(w: torch.Tensor) -> torch.Tensor:
    """[hi | lo] of the flattened weights in one buffer: hi = tf32(w) (as
    tf32_round) and lo = w - hi exactly, the 13 bits hi drops. w must be
    contiguous."""
    flat = w.reshape(-1)
    n = flat.numel()
    buf = flat.new_empty(2 * n)
    hi = buf[:n]
    torch.add(flat.view(torch.int32), 0x1000, out=hi.view(torch.int32))
    hi.view(torch.int32).bitwise_and_(-0x2000)
    torch.sub(flat, hi, out=buf[n:])
    return buf


def fragment_floats(plan: ConvPlan) -> int:
    """Floats of kernel A's B fragments for a plan."""
    return plan.n_split * 3 * plan.n_cc * plan.ksteps * plan.nt * 32 * 4


def pack_weights_tf32(w: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Plain version of kernel A's first pass (csrc/conv3d.cu::
    conv3d_pack_kernel, which computes the same bits on the card, where
    these torch ops would cost the wrapper more host time than the kernel
    takes at the quarter-resolution shapes).
    (3,3,3,Cin,Cout) -> the B fragments of split_tf32's hi and lo for a
    plan, (n_split, 3 * n_cc, ksteps, nt, 32 lanes, 4),
    where lane g*4+t of k-step ks in stage (kd, chunk) holds hi(k, n),
    hi(k+4, n), lo(k, n), lo(k+4, n) for k = 8*ks + t and
    n = (split*nt + n-tile)*8 + g, and k = (3*kh + kw) * cc + ci reads
    input channel chunk*cc + ci; zero past 9*cc, Cin and Cout. lo is
    w - hi exactly; the tensor cores read its TF32 bits, which leaves
    hi + tf32(lo) within 2^-22 of w."""
    cin, cout = w.shape[3], w.shape[4]
    n_w = 27 * cin * cout
    table = torch.cat([split_tf32(w), w.new_zeros(1)])
    stage = torch.arange(3 * plan.n_cc).reshape(-1, 1, 1, 1, 1, 1, 1)
    ks = torch.arange(plan.ksteps).reshape(1, -1, 1, 1, 1, 1, 1)
    n_tile = torch.arange(plan.n_split * plan.nt).reshape(1, 1, -1, 1, 1, 1, 1)
    g = torch.arange(8).reshape(1, 1, 1, -1, 1, 1, 1)
    t = torch.arange(4).reshape(1, 1, 1, 1, -1, 1, 1)
    part = torch.arange(2).reshape(1, 1, 1, 1, 1, -1, 1)   # hi, lo
    kk = torch.arange(2).reshape(1, 1, 1, 1, 1, 1, -1)     # k, k + 4
    kd, chunk = stage // plan.n_cc, stage % plan.n_cc
    k = ks * 8 + t + 4 * kk
    ci = chunk * plan.cc + k % plan.cc
    n = n_tile * 8 + g
    valid = (k < 9 * plan.cc) & (ci < cin) & (n < cout)
    idx = torch.where(valid, ((kd * 9 + k // plan.cc) * cin + ci) * cout + n
                      + part * n_w, torch.full_like(k, 2 * n_w))
    # (stage, ks, split*nt, g, t, part, kk) -> (split, stage, ks, nt, lane, 4)
    idx = idx.reshape(3 * plan.n_cc, plan.ksteps, plan.n_split, plan.nt, 8,
                      4, 4)
    idx = idx.permute(2, 0, 1, 3, 4, 5, 6).reshape(
        plan.n_split, 3 * plan.n_cc, plan.ksteps, plan.nt, 32, 4)
    return table[idx.to(w.device)]


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
    27 shifted channel contractions, then the affine and ReLU, in float32
    (or x's float64) on the upcast x; the output in x's dtype."""
    y = None
    for tap, xs in _shifted(wide(x)):
        t = torch.einsum("bdihw,io->bdohw", xs, w[tap])
        y = t if y is None else y + t
    y = y * scale.reshape(1, 1, -1, 1, 1) + bias.reshape(1, 1, -1, 1, 1)
    return (torch.relu(y) if relu else y).to(x.dtype)


def conv3d_dw_cf_plain(x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel D: 27 shifted contractions over
    (b, d, h, w). x (B,D,Cin,H,W), dz (B,D,Cout,H,W) -> (3,3,3,Cin,Cout),
    in float32 (or float64) whatever the inputs' dtype."""
    dz = wide(dz)
    taps = [torch.einsum("bdihw,bdohw->io", xs, dz)
            for _, xs in _shifted(wide(x))]
    return torch.stack(taps).reshape(3, 3, 3, x.shape[2], dz.shape[2])


def stages_in_pieces(*acts: torch.Tensor, n: int = 4) -> bool:
    """Whether an engine stages these activations' rows in pieces of n
    elements with cp.async (csrc/volume_src.cuh's vec<n>()): rows of a
    multiple of n elements and every tensor aligned to a piece. Kernel A's
    engine (A, B, H) takes n = 4 (16 bytes of float32, 8 of bf16), kernel
    D's (D, F) 16 bytes (``dw_piece``). Else they copy one element at a
    time."""
    return all(t.shape[-1] % n == 0
               and t.data_ptr() % (n * t.element_size()) == 0 for t in acts)


def dw_piece(eb: int) -> int:
    """Elements of kernel D's staged pieces of 16 bytes (csrc/
    conv3d_dw.cuh::kPiece): 4 floats, 8 bf16."""
    return 16 // eb


# the dtypes of the activations a kernel of A, B, D-F, H, J or K takes
ACT_DTYPES = (torch.float32, torch.bfloat16)


def check_dtypes(name, acts=(), floats=()):
    """The wrappers' operand rule: every tensor contiguous and on one
    device; ``acts`` (volumes, features, cotangents, tap maps) all float32
    or all bfloat16; ``floats`` (weights, affine) float32. Any other dtype
    raises."""
    ts = (*acts, *floats)
    act = acts[0].dtype if acts and acts[0].dtype in ACT_DTYPES else None
    for i, t in enumerate(ts):
        dt = act if i < len(acts) else torch.float32
        if (t.device != ts[0].device or t.dtype != dt
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: operands must be contiguous, on one device, "
                f"activations float32 or bfloat16 and weights float32; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def check_f32(name, *ts):
    """The operand rule of kernels C, G and I (and A's weight pass):
    contiguous float32 on one device."""
    check_dtypes(name, (), ts)


def needs_grad(*ts) -> bool:
    """Whether autograd will want a gradient through a call on ts."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _check_conv_args(name, x, w, scale, bias):
    if (x.dim() != 5 or w.dim() != 5 or w.shape[:4] != (3, 3, 3, x.shape[2])
            or scale.shape != (w.shape[4],) or bias.shape != (w.shape[4],)):
        raise ValueError(f"{name}: unsupported x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    check_dtypes(name, (x,), (w, scale, bias))


def conv3d_affine_cf(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Kernel A: conv + affine (+ReLU), no autograd. x (B,D,Cin,H,W)
    float32 or bf16; w (3,3,3,Cin,Cout), scale/bias (Cout,) float32;
    the output in x's dtype."""
    if not x.is_cuda:
        return conv3d_brc_cf_plain(x, w, scale, bias, relu)
    _check_conv_args("conv3d_affine_cf", x, w, scale, bias)
    return launch_conv(x, w, scale, bias, relu,
                       conv_plan(*x.shape, w.shape[4]))


def launch_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, relu: bool, plan: ConvPlan,
                counter=None) -> torch.Tensor:
    """Launch kernel A's engine (its weight pass, then the conv) on the
    current stream with a given plan. Counts one launch on ``counter``:
    ``conv3d_affine_cf`` (kernel A) unless another wrapper is given, on
    its ``launches_bf16`` for a bf16 x."""
    b, d, cin, h, wd = x.shape
    cout = w.shape[4]
    counter = counter or conv3d_affine_cf
    with cuda_lib.launch(counter, x.dtype):
        frag = torch.empty(fragment_floats(plan), device=x.device,
                           dtype=torch.float32)
        out = torch.empty((b, d, cout, h, wd), device=x.device,
                          dtype=x.dtype)
        rc = cuda_lib.entry("rag_conv3d_brc_cf", x.dtype)(
            x.data_ptr(), w.data_ptr(), frag.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, d, cin, h, wd, cout,
            int(relu), plan.mt, plan.nt, plan.tw, plan.n_split, plan.cc,
            plan.db, cuda_lib.stream_ptr(x))
        cuda_lib.check(rc, counter.__name__)
    return out


def pack_weights_cuda(w: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Kernel A's weight pass alone on a CUDA tensor, shaped as
    pack_weights_tf32's result (chip_smoke.py holds the two bit for
    bit)."""
    check_f32("pack_weights_cuda", w)
    frag = torch.empty(fragment_floats(plan), device=w.device,
                       dtype=torch.float32)
    rc = cuda_lib.lib().rag_conv3d_pack(
        w.data_ptr(), frag.data_ptr(), w.shape[3], w.shape[4], plan.nt,
        plan.n_split, plan.cc, cuda_lib.stream_ptr(w))
    cuda_lib.check(rc, "pack_weights_cuda")
    return frag.reshape(plan.n_split, 3 * plan.n_cc, plan.ksteps, plan.nt, 32,
                        4)


conv3d_affine_cf.launches = conv3d_affine_cf.launches_bf16 = 0
conv3d_affine_cf.span = "kernel.A"


def conv3d_dblock_cf(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Kernel H (``KernelVariants.conv3d_dblock``): the same function as
    kernel A, so the same plain version and arguments. Replaces
    rag_tpu/ops/pallas_conv3d.py::_conv3d_pallas_cf's D-blocked form (body
    _conv3d_kernel_v4). It runs kernel A's engine (csrc/conv3d.cu) with
    ``conv_plan_dblock``'s plan, which keeps v4's D-blocking: four output
    planes a block, each staged input plane feeding the three that read
    it. Bound: operations, as A. Takes every D (tail planes are masked),
    where the TPU kernel needed d % 4 == 0."""
    if not x.is_cuda:
        return conv3d_brc_cf_plain(x, w, scale, bias, relu)
    _check_conv_args("conv3d_dblock_cf", x, w, scale, bias)
    return launch_conv(x, w, scale, bias, relu,
                       conv_plan_dblock(*x.shape, w.shape[4]),
                       conv3d_dblock_cf)


conv3d_dblock_cf.launches = conv3d_dblock_cf.launches_bf16 = 0
conv3d_dblock_cf.span = "kernel.H"


def _conv_kernel(dblock: bool):
    """Kernel H's wrapper for the D-blocked variant, else kernel A's, looked
    up when called (so a caller that swaps a module attribute is seen)."""
    return conv3d_dblock_cf if dblock else conv3d_affine_cf


def conv3d_dw_cf(x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Kernel D: the 3x3x3 conv's weight gradient, no autograd.
    x (B,D,Cin,H,W), dz (B,D,Cout,H,W), both float32 or both bf16 ->
    (3,3,3,Cin,Cout) float32."""
    if not x.is_cuda:
        return conv3d_dw_cf_plain(x, dz)
    b, d, cin, h, wd = x.shape
    cout = dz.shape[2]
    if dz.shape != (b, d, cout, h, wd):
        raise ValueError(f"conv3d_dw_cf: x {tuple(x.shape)} and dz "
                         f"{tuple(dz.shape)} disagree")
    check_dtypes("conv3d_dw_cf", (x, dz))
    return launch_dw_plan(x, dz, dw_plan(b, d, cin, h, wd, cout))


conv3d_dw_cf.launches = conv3d_dw_cf.launches_bf16 = 0
conv3d_dw_cf.span = "kernel.D"


def launch_dw_plan(x: torch.Tensor, dz: torch.Tensor, plan: DwPlan,
                   passes: int = 3) -> torch.Tensor:
    """Launch kernel D on the current stream with a given plan: its first
    pass (bit 1 of ``passes``: the blocks' partials into a workspace) and
    its sum pass (bit 2: the partials summed in a fixed order into dW).
    Counts one launch on ``conv3d_dw_cf``. One pass alone is for timing:
    the sum pass alone reads a workspace left unwritten."""
    b, d, cin, h, w = x.shape
    cout = dz.shape[2]
    with cuda_lib.launch(conv3d_dw_cf, x.dtype):
        partial = torch.empty(plan.workspace, device=x.device,
                              dtype=torch.float32)
        out = torch.empty((3, 3, 3, cin, cout), device=x.device,
                          dtype=torch.float32)
        rc = cuda_lib.entry("rag_conv3d_dw_cf", x.dtype)(
            x.data_ptr(), dz.data_ptr(), partial.data_ptr(), out.data_ptr(),
            b, d, cin, cout, h, w, plan.ci, plan.co_t, plan.kh_t,
            plan.groups, plan.th, plan.tw, plan.db, passes,
            cuda_lib.stream_ptr(x))
        cuda_lib.check(rc, "conv3d_dw_cf")
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
        z = _conv_kernel(dblock)(x, w, w.new_ones(cout), w.new_zeros(cout),
                                 False)
        sh = (1, 1, -1, 1, 1)
        y = wide(z) * scale.reshape(sh) + bias.reshape(sh)
        ctx.save_for_backward(x, w, scale, bias, z)
        ctx.relu, ctx.dblock = relu, dblock
        return (torch.relu(y) if relu else y).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, scale, bias, z = ctx.saved_tensors
        need_x, need_w, need_scale, need_bias = ctx.needs_input_grad[:4]
        sh = (1, 1, -1, 1, 1)
        # gm in x's dtype (the output's); the parameter gradients sum in
        # float32
        gm = g * ((wide(z) * scale.reshape(sh) + bias.reshape(sh)) > 0) \
            if ctx.relu else g
        gm = gm.contiguous()
        dx = dw = dscale = dbias = None
        if need_bias:
            dbias = wide(gm).sum(dim=(0, 1, 3, 4))
        if need_scale:
            dscale = (wide(gm) * wide(z)).sum(dim=(0, 1, 3, 4))
        if need_x:
            cin = w.shape[3]
            wf = (w.flip((0, 1, 2)).transpose(3, 4)
                  * scale.reshape(1, 1, 1, -1, 1)).contiguous()
            dx = _conv_kernel(ctx.dblock)(gm, wf, w.new_ones(cin),
                                          w.new_zeros(cin), False)
        if need_w:
            dw = conv3d_dw_cf(x, gm) * scale.reshape(1, 1, 1, 1, -1)
        return dx, dw, dscale, dbias, None, None


def conv3d_brc_cf(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, relu: bool,
                  variants: KernelVariants = DEFAULT) -> torch.Tensor:
    """Fused conv + affine (+ReLU), differentiable in x, w, scale, bias.
    x (B,D,Cin,H,W) float32 or bf16, the output and dx in its dtype;
    w (3,3,3,Cin,Cout), scale/bias (Cout,) float32, their gradients
    float32. Kernel A, or kernel H where ``variants.conv3d_dblock``."""
    dblock = variants.conv3d_dblock
    if needs_grad(x, w, scale, bias):
        return _Conv3dBRC.apply(x, w, scale, bias, relu, dblock)
    return _conv_kernel(dblock)(x, w, scale, bias, relu)
