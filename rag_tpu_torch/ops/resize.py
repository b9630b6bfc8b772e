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
Bound on the H100: bytes (the head's last up-resize at the eval geometry
reads 19.7 MB and writes 157 MB, 0.053 ms). The kernel is separable with D
last: a block owns (b, c, a tile of output rows x columns, a run of output
planes), stages the rows its H taps read of each source plane its D taps
read into a cp.async ring, interpolates each staged plane in H and W once
into a register window, and blends each output plane from the window.
``resize_plan`` picks the tile and the run per shape; ``resize_tables``
lists, per tile and run, the source rows and planes to stage and, per
output, where its taps sit in those lists; ``axis_blocks`` is the rule for
one axis. The TPU kernel blends D by taps and contracts H and W with dense
matrices, which computes the same function with the float32 sums in
another order. Its plain version is the matrix form, which stays the
default path.

Dtypes (the bf16-at-rest policy, ops.precision): kernel I takes a float32
or a bf16 volume (and cotangent) and returns one of the same dtype. The
bf16 instance runs the float32 instance's plan, tables and sums on the
widened values and rounds once, at the store, so its output is the
float32 instance's on the upcast input, rounded to bf16; its ring holds
the bf16 rows as they are, copied in 16-byte pieces of eight
(``resize_piece``, ``resize_stage``). That is not rag_tpu's bf16
arithmetic: rag_tpu's gate sends a bf16 volume to its matrix products,
which contract against a bf16 copy of each matrix and round after every
axis (``resize_linear``, which the default path keeps); one rounding
comes closer to the exact resize.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from rag_tpu_torch.ops import cuda_lib
from rag_tpu_torch.ops.conv3d import CONV_SMS, check_dtypes, needs_grad
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
    """Resize ``x`` along ``axes`` to ``out_sizes`` by linear interpolation,
    contracting against a copy of each matrix in x's dtype (a bf16 x
    against a bf16 matrix, as rag_tpu/ops/resize.py does)."""
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


def resize_taps_plain(x: torch.Tensor, d2: int, h2: int, w2: int,
                      align_corners: bool = True,
                      transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel I: the matrix products. Forward:
    (B, D, C, H, W) -> (B, d2, C, h2, w2). transposed: the adjoint of the
    forward resize from (d2, h2, w2) to x's sizes, x being its cotangent.
    A bf16 x: the float32 version on the upcast x, rounded to bf16 (the
    bf16 instance's definition)."""
    if x.dtype == torch.bfloat16:
        return resize_taps_plain(x.float(), d2, h2, w2, align_corners,
                                 transposed).to(torch.bfloat16)
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


# Kernel I's blocking (csrc/resize_taps.cu): 4 warps, each warp's lanes 2
# output rows x 16 output columns; a thread owns qc columns 16 apart in
# each of rpw rows 8 apart, so a block's tile is 8*rpw rows x 16*qc columns
RESIZE_THREADS = 128
RESIZE_TILES = ((1, 4), (2, 2), (4, 1))   # (qc, rpw) the kernel is compiled for
RESIZE_K = (2, 4)                         # taps per output an axis may have
RESIZE_RING = 4                           # staged planes: 3 in flight + 1 read
RESIZE_MAX_SMEM = 100 * 1024              # bytes: at least two blocks an SM
# registers a thread for K taps (ptxas, sm_90a, CUDA 12.8), which set how
# many blocks an SM holds
RESIZE_REGS = {2: 80, 4: 113}
# resize_plan's rule, from the blockings scripts/torch_resize_sweep.py
# timed on the H100: runs of output planes are cut shorter while the
# planes they restage add at most RESIZE_RESTAGE to the planes staged and
# the grid holds fewer than RESIZE_WAVES waves of resident blocks
RESIZE_RESTAGE, RESIZE_WAVES = 1 / 8, 4


class ResizePlan(NamedTuple):
    """Kernel I's blocking of one call (csrc/resize_taps.cu's arguments)."""
    qc: int           # columns per thread (16 apart)
    rpw: int          # rows per thread (8 apart)
    k: int            # taps per output the tables hold on every axis
    th: int           # tile rows (8 * rpw)
    tw: int           # tile columns (16 * qc)
    run: int          # output planes per block
    n_wt: int         # tiles along W2
    n_ht: int         # tiles along H2
    n_runs: int       # runs of planes along D2
    rows: int         # staged rows per plane, the most of any tile
    pitch: int        # floats per staged row (the widest tile's span)
    planes: int       # source planes per run, the most of any run
    blocks: int       # b * c * n_runs * n_ht * n_wt
    smem: int         # dynamic shared memory per block, bytes (float32)

    def pitch_for(self, piece: int) -> int:
        """Elements a staged row at a piece of ``piece`` elements
        (``resize_piece``): the plan's pitch, or for bf16 pieces of eight
        round8(pitch + 4), an offset span in whole 16-byte pieces."""
        return -(-(self.pitch + 4) // 8) * 8 if piece == 8 else self.pitch

    def smem_for(self, eb: int, piece: int) -> int:
        """Shared bytes a block for eb-byte elements staged in pieces of
        ``piece`` (csrc/resize_taps.cu::resize_entry)."""
        return eb * RESIZE_RING * self.rows * self.pitch_for(piece)


def resize_piece(w: int, addr: int, eb: int) -> int:
    """Elements of kernel I's staged pieces (csrc/resize_taps.cu::piece_of)
    for x of W columns at address ``addr`` with eb-byte elements: float32
    4 (16 bytes) where W % 4 == 0 and x is 16-byte aligned, else 1; bf16 8
    (16 bytes) where W % 8 == 0 and x is 16-byte aligned, else 4 (8
    bytes) where W % 4 == 0 and x is 8-byte aligned, else 1."""
    if eb == 4:
        return 4 if w % 4 == 0 and addr % 16 == 0 else 1
    if w % 8 == 0 and addr % 16 == 0:
        return 8
    return 4 if w % 4 == 0 and addr % 8 == 0 else 1


def resize_stage(lo: int, n_col: int, piece: int):
    """A W tile's staged span in pieces (csrc/resize_taps.cu): (base,
    off, width), the columns [base, base + width) copied from the piece
    boundary at or left of its first column lo, whole pieces, the span's
    columns [lo, lo + n_col) read off columns on."""
    base = lo - lo % piece
    off = lo - base
    return base, off, -(-(off + n_col) // piece) * piece


def _axis_table(n: int, n2: int, align_corners: bool, transposed: bool):
    """The tap table of one axis resized from n to n2 (the adjoint's, with
    transposed): (idx, w) of shape (n2, K)."""
    return _taps_np(*((n2, n) if transposed else (n, n2)), align_corners,
                    transposed)


@functools.lru_cache(maxsize=None)
def axis_blocks(n: int, n2: int, align_corners: bool, transposed: bool,
                tile: int, contiguous: bool):
    """One axis cut into tiles of ``tile`` consecutive outputs. Per tile
    the source indices it stages: the ones its outputs' real taps read
    (weight != 0; padded taps are skipped), or with ``contiguous`` the
    span from the first down to a multiple of 4 to the last up to one
    (within n), for 16-byte copies. Per output: the position of its first
    real tap in its tile's list and its count of real taps; its real taps
    are consecutive source indices, so they sit at consecutive positions.
    Returns (lists, first, count)."""
    idx, w = _axis_table(n, n2, align_corners, transposed)
    count = np.count_nonzero(w, 1).astype(np.int32)
    lists, first = [], np.zeros(n2, np.int32)
    for t0 in range(0, n2, tile):
        sl = slice(t0, min(n2, t0 + tile))
        src = np.unique(idx[sl][w[sl] != 0]).astype(np.int32)
        if contiguous and len(src):
            src = np.arange(src[0] // 4 * 4, min(n, -(-(src[-1] + 1) // 4) * 4),
                            dtype=np.int32)
        lists.append(src)
        first[sl] = np.where(count[sl] > 0, np.searchsorted(src, idx[sl, 0]),
                             0)
    for o in range(n2):
        t = lists[o // tile]
        assert (t[first[o]:first[o] + count[o]] == idx[o, :count[o]]).all()
    return lists, first, count


def resize_blocking(b, d, c, h, w, d2, h2, w2, align_corners, transposed,
                    qc, rpw, run):
    """Kernel I's plan for a tile (qc, rpw) and a run of output planes."""
    k = max(_axis_table(n, n2, align_corners, transposed)[0].shape[1]
            for n, n2 in ((d, d2), (h, h2), (w, w2)))
    if k > RESIZE_K[-1]:
        raise ValueError(f"kernel I: {(d, h, w)} -> {(d2, h2, w2)} needs "
                         f"{k} taps per output on an axis, more than "
                         f"{RESIZE_K[-1]}")
    k = min(x for x in RESIZE_K if x >= k)
    th, tw = 8 * rpw, 16 * qc
    cols = axis_blocks(w, w2, align_corners, transposed, tw, True)[0]
    rows = axis_blocks(h, h2, align_corners, transposed, th, False)[0]
    planes = axis_blocks(d, d2, align_corners, transposed, run, False)[0]
    n_wt, n_ht, n_runs = len(cols), len(rows), len(planes)
    pitch = max(4, -(-max(len(t) for t in cols) // 4) * 4)
    n_rows = max(1, max(len(t) for t in rows))
    return ResizePlan(qc, rpw, k, th, tw, run, n_wt, n_ht, n_runs, n_rows,
                      pitch, max(1, max(len(t) for t in planes)),
                      b * c * n_runs * n_ht * n_wt,
                      4 * RESIZE_RING * n_rows * pitch)


def resize_work(plan: ResizePlan, d, h, w, d2, h2, w2, align_corners,
                transposed):
    """(planes staged per (b, c), summed over runs; the work resize_plan
    weighs: the floats they stage plus twice the lanes that gather from
    them, over every tile)."""
    cols = axis_blocks(w, w2, align_corners, transposed, plan.tw, True)[0]
    rows = axis_blocks(h, h2, align_corners, transposed, plan.th, False)[0]
    planes = axis_blocks(d, d2, align_corners, transposed, plan.run,
                         False)[0]
    steps = sum(len(t) for t in planes)
    staged = steps * sum(len(t) for t in rows) * sum(len(t) for t in cols)
    lanes = steps * plan.n_ht * plan.th * plan.n_wt * plan.tw
    return steps, staged + 2 * lanes


def resize_candidates(b, d, c, h, w, d2, h2, w2, align_corners=True,
                      transposed=False):
    """For each tile of RESIZE_TILES within RESIZE_MAX_SMEM, its plan with
    the runs resize_plan's rule gives: starting from the whole of D2, runs
    (D2 cut into equal runs) are cut shorter while the planes they restage
    keep the planes staged within 1 + RESIZE_RESTAGE of the whole run's
    and the grid holds fewer than RESIZE_WAVES waves of the blocks an SM
    holds (by its registers and shared memory). Yields (work, plan)."""
    runs = sorted({-(-d2 // n) for n in range(1, d2 + 1)}, reverse=True)
    sizes = (d, h, w, d2, h2, w2, align_corners, transposed)
    for qc, rpw in RESIZE_TILES:
        plan = resize_blocking(b, d, c, h, w, d2, h2, w2, align_corners,
                               transposed, qc, rpw, runs[0])
        steps0, work = resize_work(plan, *sizes)
        per_sm = min(65536 // (RESIZE_THREADS * RESIZE_REGS[plan.k]),
                     (228 << 10) // (plan.smem + 1024))
        for run in runs[1:]:
            if plan.blocks >= RESIZE_WAVES * CONV_SMS * per_sm:
                break
            shorter = resize_blocking(b, d, c, h, w, d2, h2, w2,
                                      align_corners, transposed, qc, rpw, run)
            steps, shorter_work = resize_work(shorter, *sizes)
            if steps > steps0 * (1 + RESIZE_RESTAGE):
                break
            plan, work = shorter, shorter_work
        if plan.smem <= RESIZE_MAX_SMEM:
            yield work, plan


@functools.lru_cache(maxsize=None)
def resize_plan(b: int, d: int, c: int, h: int, w: int, d2: int, h2: int,
                w2: int, align_corners: bool = True,
                transposed: bool = False) -> ResizePlan:
    """Kernel I's tile and run of output planes for x (b, d, c, h, w) ->
    (b, d2, c, h2, w2) (or the adjoint's, with transposed): among
    ``resize_candidates``, the least work, the floats staged plus twice the
    lanes that gather (every lane of a tile, inside the volume or not), per
    plane staged; then the wider tile. On the 18 shapes of a request and a
    task-0 step the choice summed over a request and a step is within 6 %
    of the fastest blockings timed."""
    cands = list(resize_candidates(b, d, c, h, w, d2, h2, w2, align_corners,
                                   transposed))
    if not cands:
        raise ValueError(f"resize_plan: no tile of kernel I fits "
                         f"{(d, h, w)} -> {(d2, h2, w2)}")
    return min(cands, key=lambda c_: (c_[0], -c_[1].tw))[1]


def resize_block_region(plan: ResizePlan, c: int, bx: int):
    """The outputs block bx of a plan computes for a volume of c channels,
    as the kernel decodes its index (W tiles fastest, then H tiles, runs,
    channels, batch): (b, channel, output planes, rows, columns), the last
    three as ranges not clipped to the volume."""
    wt, r = bx % plan.n_wt, bx // plan.n_wt
    ht, r = r % plan.n_ht, r // plan.n_ht
    run, r = r % plan.n_runs, r // plan.n_runs
    return (r // c, r % c, range(run * plan.run, (run + 1) * plan.run),
            range(ht * plan.th, (ht + 1) * plan.th),
            range(wt * plan.tw, (wt + 1) * plan.tw))


@functools.lru_cache(maxsize=None)
def resize_tables(plan: ResizePlan, d: int, h: int, w: int, d2: int, h2: int,
                  w2: int, align_corners: bool = True,
                  transposed: bool = False):
    """Kernel I's tables for a plan, as the kernel reads them: one int32
    and one float32 array, each the concatenation, in this order, of
      int32: per W tile its first staged column and staged columns
             (n_wt each); per output column the offset of its first real
             tap from its tile's first column, and its real taps (w2 each);
             per H tile its staged rows (n_ht), and their source rows
             (n_ht x plan.rows); per output row the slot of its first real
             tap and its real taps (h2 each); per run its staged planes
             (n_runs) and their source planes (n_runs x plan.planes); per
             output plane the list position of its last real tap (-1 if
             none) and its real taps (d2 each);
      float32: the weights of each output column's real taps, in tap order
             (w2 x plan.k), of each output row's (h2 x plan.k), and of each
             output plane's from the last to the first (d2 x plan.k), zero
             past its real taps."""
    k = plan.k
    cols, off_w, cnt_w = axis_blocks(w, w2, align_corners, transposed,
                                     plan.tw, True)
    rows, slot_h, cnt_h = axis_blocks(h, h2, align_corners, transposed,
                                      plan.th, False)
    planes, first_d, cnt_d = axis_blocks(d, d2, align_corners, transposed,
                                         plan.run, False)

    def padded(lists, n):
        out = np.zeros((len(lists), n), np.int32)
        for i, t in enumerate(lists):
            out[i, :len(t)] = t
        return out

    def weights(n, n2, reverse=False):
        _, wt = _axis_table(n, n2, align_corners, transposed)
        out = np.zeros((n2, k), np.float32)
        for o in range(n2):
            real = wt[o][wt[o] != 0]
            real = real[::-1] if reverse else real
            out[o, :len(real)] = real
        return out

    last_d = np.where(cnt_d > 0, first_d + cnt_d - 1, -1).astype(np.int32)
    itab = np.concatenate([
        np.array([t[0] if len(t) else 0 for t in cols], np.int32),
        np.array([len(t) for t in cols], np.int32), off_w, cnt_w,
        np.array([len(t) for t in rows], np.int32),
        padded(rows, plan.rows).ravel(), slot_h, cnt_h,
        np.array([len(t) for t in planes], np.int32),
        padded(planes, plan.planes).ravel(), last_d, cnt_d])
    ftab = np.concatenate([weights(w, w2).ravel(), weights(h, h2).ravel(),
                           weights(d, d2, True).ravel()])
    return itab.astype(np.int32), ftab.astype(np.float32)


@functools.lru_cache(maxsize=256)
def resize_setup(shape, d2: int, h2: int, w2: int, align_corners: bool,
                 transposed: bool, device: torch.device):
    """(plan, int32 tables, float32 tables) of kernel I for x of ``shape``
    on ``device``, in one cached lookup (the wrapper's host time is most of
    a small call's). Read-only; made outside inference mode, so tables
    first built while serving can serve a backward."""
    b, d, c, h, w = shape
    plan = resize_plan(b, d, c, h, w, d2, h2, w2, align_corners, transposed)
    with torch.inference_mode(False):
        itab, ftab = resize_tables(plan, d, h, w, d2, h2, w2, align_corners,
                                   transposed)
        return (plan, torch.from_numpy(itab).to(device),
                torch.from_numpy(ftab).to(device))


def launch_resize(x: torch.Tensor, itab: torch.Tensor, ftab: torch.Tensor,
                  out: torch.Tensor, plan: ResizePlan) -> None:
    """Launch kernel I's instance for x's dtype on the current stream into
    ``out`` with a plan and its tables (``resize_tables``) on the card;
    counts nothing."""
    b, d, c, h, w = x.shape
    _, d2, _, h2, w2 = out.shape
    rc = cuda_lib.entry("rag_resize_taps_cf", x.dtype)(
        x.data_ptr(), itab.data_ptr(), ftab.data_ptr(), out.data_ptr(),
        b, d, c, h, w, d2, h2, w2, plan.k, plan.qc, plan.rpw, plan.run,
        plan.rows, plan.pitch, plan.planes, cuda_lib.stream_ptr(x))
    cuda_lib.check(rc, "resize_taps_cf")


def resize_taps_cf(x: torch.Tensor, d2: int, h2: int, w2: int,
                   align_corners: bool = True,
                   transposed: bool = False) -> torch.Tensor:
    """Kernel I, no autograd: x (B, D, C, H, W) float32 or bf16 -> (B, d2,
    C, h2, w2) of x's dtype, the forward resize, or with ``transposed``
    its adjoint (see ``resize_taps_plain``)."""
    if not x.is_cuda:
        return resize_taps_plain(x, d2, h2, w2, align_corners, transposed)
    check_dtypes("resize_taps_cf", (x,))
    plan, itab, ftab = resize_setup(tuple(x.shape), d2, h2, w2,
                                    align_corners, transposed, x.device)
    b, _, c, _, _ = x.shape
    out = torch.empty((b, d2, c, h2, w2), device=x.device, dtype=x.dtype)
    launch_resize(x, itab, ftab, out, plan)
    cuda_lib.count(resize_taps_cf, x.dtype)
    return out


resize_taps_cf.launches = resize_taps_cf.launches_bf16 = 0


class _ResizeCF(torch.autograd.Function):
    """rag_tpu/ops/pallas_resize.py::resize_cf's custom VJP: kernel I on
    the forward tap tables, and on the transposed ones for the backward
    (the cotangent's dtype in, the same dtype out, as rag_tpu's
    ``_resize_bwd`` returns ``g.dtype``)."""

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
    (B, d2, C, h2, w2) of x's dtype: the matrix products, or kernel I
    where ``variants.resize_kernel``, float32 or bf16 (the bf16-at-rest
    policy). Without the variant a bf16 x contracts against a bf16 copy
    of each matrix, as rag_tpu/ops/resize.py does; with it kernel I's bf16
    instance rounds once, where rag_tpu/ops/pallas_resize.py's gate sends
    a bf16 volume to those matrix products (see the module docstring)."""
    if not variants.resize_kernel:
        return resize_linear(x, (d2, h2, w2), (1, 3, 4), align_corners)
    x = x.contiguous()
    if needs_grad(x):
        return _ResizeCF.apply(x, d2, h2, w2, align_corners)
    return resize_taps_cf(x, d2, h2, w2, align_corners)
