"""Kernel I's blocking (``resize_taps_cf``, csrc/resize_taps.cu) and kernel
H's plan (``conv3d_dblock_cf``: kernel A's engine with db = 4), checked on
the CPU against the plain versions and the JAX package's Pallas kernel in
interpret mode.

The CUDA kernels run only on the card (chip_smoke.py holds each against its
plain version there). What decides their results and is plain Python is
checked here:

(a) ``resize_plan`` at every kernel I call of a 1x480x960 request and of a
    training step of task 0's stage (4 x 192 x 384 crops), forward and
    adjoint, and at chip_smoke.py's small shapes: the blocks cover every
    output element exactly once, none is empty, a block fits its shared
    memory, and a call whose input or output holds at least 264 x 4096
    floats gets at least 264 blocks (two waves on 132 SMs).
(b) the kernel's order of summation, read from ``resize_tables`` through
    the kernel's own layout of them: per block, the staged rows and column
    span of each listed source plane, each pixel's W taps summed innermost,
    then its H taps, into a window of the last planes, and each output
    plane's D taps from the last to the first. In float64 on random data
    the emulation is within 1e-9 of the plain version, forward and adjoint.
(c) on integer data with dyadic weights (5 -> 9 and 9 -> 17 with
    align_corners, and their adjoints) the emulation in float32 equals
    rag_tpu's ``_resize_cf_pallas(interpret=True)`` bit for bit.
(d) kernel H's plan at every conv call of those paths has db = 4 and a
    tile at most 32 columns wide, its blocks (``conv_block_region``) cover
    every output once and it fits its shared memory; kernel A's plans there are the ones it had before H
    moved onto its engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.ops.pallas_resize import _resize_cf_pallas
from rag_tpu_torch.ops.conv3d import (
    CONV_INSTANCES,
    conv_block_region,
    conv_plan,
    conv_plan_dblock,
)
from rag_tpu_torch.ops.conv3d import CONV_MIN_BLOCKS
from rag_tpu_torch.ops.resize import (
    RESIZE_MAX_SMEM,
    RESIZE_RESTAGE,
    RESIZE_RING,
    resize_block_region,
    resize_blocking,
    resize_plan,
    resize_tables,
    resize_taps_cf,
    resize_taps_plain,
    resize_work,
)
from test_torch_port_redesign import MAIN_PATH_CONVS

# (x shape, target (d2, h2, w2)) of every kernel I forward call of the
# committed checkpoint's task paths: serving at 1x480x960 (features
# 160x320, D 64) and training at 4x192x384 (64x128): the cells' down and
# up resizes and the head's two
FWD_SERVE = [
    ((1, 64, 12, 160, 320), (32, 80, 160)),
    ((1, 32, 24, 80, 160), (16, 40, 80)),
    ((1, 64, 12, 160, 320), (16, 40, 80)),
    ((1, 16, 48, 40, 80), (32, 80, 160)),
    ((1, 16, 24, 40, 80), (32, 80, 160)),
    ((1, 32, 12, 80, 160), (64, 160, 320)),
]
FWD_TRAIN = [
    ((4, 64, 12, 64, 128), (32, 32, 64)),
    ((4, 32, 24, 32, 64), (16, 16, 32)),
    ((4, 64, 12, 64, 128), (16, 16, 32)),
    ((4, 16, 48, 16, 32), (32, 32, 64)),
    ((4, 16, 24, 16, 32), (32, 32, 64)),
    ((4, 32, 12, 32, 64), (64, 64, 128)),
]


def _adjoint(call):
    """The adjoint call of a forward call: the cotangent of the output's
    shape back to the input's sizes on the transposed tables."""
    (b, d, c, h, w), (d2, h2, w2) = call
    return (b, d2, c, h2, w2), (d, h, w), True


# chip_smoke.py's small shapes for kernel I (transposed last)
SMALL = [((1, 6, 5, 16, 24), (3, 8, 12), False),
         ((2, 6, 5, 16, 24), (12, 32, 48), False),
         ((1, 6, 3, 11, 13), (4, 6, 7), False),
         ((1, 6, 5, 16, 24), (6, 16, 11), False),
         ((2, 12, 5, 32, 48), (6, 16, 24), True),
         ((1, 11, 3, 11, 11), (6, 6, 6), True),
         ((1, 3, 4, 8, 12), (6, 16, 24), True),
         ((1, 16, 2, 20, 40), (4, 5, 10), False),
         ((1, 4, 2, 5, 10), (16, 20, 40), True)]
MAIN_PATH_RESIZES = ([(x, t, False) for x, t in FWD_SERVE + FWD_TRAIN]
                     + [_adjoint(c) for c in FWD_SERVE + FWD_TRAIN])


def _plan(shape, target, transposed):
    return resize_plan(*shape, *target, True, transposed)


def _clip(r: range, n: int) -> range:
    return range(r.start, min(r.stop, n))


# -- (a) the plan covers every output once -----------------------------------


@pytest.mark.parametrize("shape,target,transposed",
                         MAIN_PATH_RESIZES + SMALL)
def test_resize_plan_covers_and_fills(shape, target, transposed):
    b, d, c, h, w = shape
    d2, h2, w2 = target
    plan = _plan(shape, target, transposed)
    assert plan.th == 8 * plan.rpw and plan.tw == 16 * plan.qc
    assert plan.blocks == b * c * plan.n_runs * plan.n_ht * plan.n_wt
    assert plan.smem == 4 * RESIZE_RING * plan.rows * plan.pitch
    assert plan.smem <= RESIZE_MAX_SMEM and plan.pitch % 4 == 0
    if b * c * max(d * h * w, d2 * h2 * w2) >= CONV_MIN_BLOCKS * 4096:
        assert plan.blocks >= CONV_MIN_BLOCKS
    # the runs restage at most 1/8 more planes than one run of all of D2
    sizes = (d, h, w, d2, h2, w2, True, transposed)
    whole = resize_blocking(b, d, c, h, w, d2, h2, w2, True, transposed,
                            plan.qc, plan.rpw, d2)
    assert resize_work(plan, *sizes)[0] <= \
        (1 + RESIZE_RESTAGE) * resize_work(whole, *sizes)[0]
    # (b, c) and the runs of planes: each once; tiles: each (h, w) once
    seen_bc = np.zeros((b, c), np.int32)
    seen_d = np.zeros(d2, np.int32)
    seen_hw = np.zeros((h2, w2), np.int32)
    per_tile = plan.n_runs * plan.n_ht * plan.n_wt
    for bx in range(plan.blocks):
        bb, cc, planes, rows, cols = resize_block_region(plan, c, bx)
        planes, rows, cols = _clip(planes, d2), _clip(rows, h2), \
            _clip(cols, w2)
        assert len(planes) and len(rows) and len(cols), "empty block"
        if bx % per_tile == 0:
            seen_bc[bb, cc] += 1
        if bx < per_tile:
            if bx % (plan.n_ht * plan.n_wt) == 0:
                seen_d[planes.start:planes.stop] += 1
            if bx < plan.n_ht * plan.n_wt:
                seen_hw[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (seen_bc == 1).all() and (seen_d == 1).all()
    assert (seen_hw == 1).all()


# -- (b), (c) the kernel's order of summation --------------------------------


def unpack_tables(plan, itab, ftab, d2, h2, w2):
    """resize_tables' arrays cut as csrc/resize_taps.cu::rag_resize_taps_cf
    cuts them."""
    out, i = {}, 0
    for name, n in [("wt_lo", plan.n_wt), ("wt_n", plan.n_wt),
                    ("col_off", w2), ("col_n", w2), ("ht_n", plan.n_ht),
                    ("ht_rows", plan.n_ht * plan.rows), ("row_slot", h2),
                    ("row_n", h2), ("run_n", plan.n_runs),
                    ("run_planes", plan.n_runs * plan.planes),
                    ("pl_last", d2), ("pl_n", d2)]:
        out[name] = itab[i:i + n]
        i += n
    assert i == len(itab)
    out["ht_rows"] = out["ht_rows"].reshape(plan.n_ht, plan.rows)
    out["run_planes"] = out["run_planes"].reshape(plan.n_runs, plan.planes)
    j = 0
    for name, n in [("col_w", w2), ("row_w", h2), ("pl_w", d2)]:
        out[name] = ftab[j:j + n * plan.k].reshape(n, plan.k)
        j += n * plan.k
    assert j == len(ftab)
    return out


def emulate_resize(x: np.ndarray, d2: int, h2: int, w2: int,
                   transposed: bool, plan=None) -> np.ndarray:
    """Kernel I's blocks and order of sums, in x's dtype (see the module
    doc); every output is written by exactly one block."""
    b_, d, c_, h, w = x.shape
    plan = plan or resize_plan(b_, d, c_, h, w, d2, h2, w2, True, transposed)
    tab = unpack_tables(plan, *resize_tables(plan, d, h, w, d2, h2, w2, True,
                                             transposed), d2, h2, w2)
    dt = x.dtype.type
    out = np.full((b_, d2, c_, h2, w2), np.nan, x.dtype)
    for bx in range(plan.blocks):
        bb, c, planes, rows, cols = resize_block_region(plan, c_, bx)
        wt, ht = cols.start // plan.tw, rows.start // plan.th
        run = planes.start // plan.run
        oh = np.arange(rows.start, rows.stop)[:, None]       # tile rows
        ow = np.arange(cols.start, cols.stop)[None, :]       # tile columns
        ok = (oh < h2) & (ow < w2)
        ohc, owc = np.minimum(oh, h2 - 1), np.minimum(ow, w2 - 1)
        rn = np.where(oh < h2, tab["row_n"][ohc], 0)
        cn = np.where(ow < w2, tab["col_n"][owc], 0)
        lo, n_col = tab["wt_lo"][wt], tab["wt_n"][wt]
        src_rows = tab["ht_rows"][ht, :tab["ht_n"][ht]]
        src_planes = tab["run_planes"][run, :tab["run_n"][run]]
        win = [np.zeros(ok.shape, x.dtype) for _ in range(plan.k)]
        e = -1
        for od in _clip(planes, d2):
            n, last = tab["pl_n"][od], tab["pl_last"][od]
            while e < last:
                e += 1
                staged = x[bb, src_planes[e], c][src_rows][:, lo:lo + n_col]
                acc_h = np.zeros(ok.shape, x.dtype)
                for qq in range(plan.k):
                    slot = tab["row_slot"][ohc] + qq
                    acc_w = np.zeros(ok.shape, x.dtype)
                    for k in range(plan.k):
                        col = tab["col_off"][owc] + k
                        use = (qq < rn) & (k < cn)
                        val = staged[np.where(use, slot, 0),
                                     np.where(use, col, 0)]
                        acc_w = np.where(
                            k < cn, acc_w + dt(tab["col_w"][owc, k]) * val,
                            acc_w)
                    acc_h = np.where(qq < rn,
                                     acc_h + dt(tab["row_w"][ohc, qq]) * acc_w,
                                     acc_h)
                win = [acc_h] + win[:-1]
            acc = np.zeros(ok.shape, x.dtype)
            for j in range(n):
                acc = acc + dt(tab["pl_w"][od, j]) * win[j]
            blk = out[bb, od, c]
            sub = blk[rows.start:rows.stop, cols.start:cols.stop]
            assert np.isnan(sub).all(), "an output written twice"
            sub[...] = acc[:sub.shape[0], :sub.shape[1]]
    assert not np.isnan(out).any(), "an output left unwritten"
    return out


# (x shape, target, transposed): 2x down and up, odd sizes, identity axes,
# a 4x downsample (whose listed rows and planes skip the unread ones), the
# adjoints of a 2x and an odd-size upsample (4 and 3 taps), W % 4 != 0
EMU_CASES = SMALL + [((2, 9, 3, 17, 34), (5, 9, 17), True),
                     ((1, 13, 2, 7, 21), (7, 13, 41), False)]


@pytest.mark.parametrize("shape,target,transposed", EMU_CASES)
def test_resize_emulation_float64(shape, target, transposed):
    rng = np.random.default_rng(sum(shape) + sum(target))
    x = rng.standard_normal(shape)
    got = emulate_resize(x, *target, transposed)
    ref = resize_taps_plain(torch.from_numpy(x), *target, True,
                            transposed).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-9 * float(np.abs(ref).max()))


@pytest.mark.parametrize("shape,target,transposed", EMU_CASES[:4])
def test_resize_emulation_at_other_tiles(shape, target, transposed):
    """The same order of sums at every tile of the kernel and runs of one
    and of three output planes."""
    from rag_tpu_torch.ops.resize import RESIZE_TILES

    b, d, c, h, w = shape
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape)
    ref = resize_taps_plain(torch.from_numpy(x), *target, True,
                            transposed).numpy()
    for qc, rpw in RESIZE_TILES:
        for run in (1, 3):
            plan = resize_blocking(b, d, c, h, w, *target, True,
                                   transposed, qc, rpw, run)
            got = emulate_resize(x, *target, transposed, plan)
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-9 * float(np.abs(ref).max()))


# dyadic weights: align_corners 5 -> 9 and 9 -> 17 put every sample on a
# half step, so sums of small integers stay exact in float32
DYADIC = [((2, 5, 3, 9, 5), (9, 17, 9), False),
          ((1, 9, 2, 5, 9), (17, 9, 17), False),
          ((2, 9, 3, 17, 9), (5, 9, 5), True),
          ((1, 17, 2, 9, 17), (9, 5, 9), True)]


@pytest.mark.parametrize("shape,target,transposed", DYADIC)
def test_resize_emulation_equals_pallas_on_integers(shape, target,
                                                    transposed):
    rng = np.random.default_rng(11 + sum(shape))
    x = rng.integers(-8, 9, shape).astype(np.float32)
    got = emulate_resize(x, *target, transposed)
    kern = np.asarray(_resize_cf_pallas(jnp.asarray(x), *target, True,
                                        transposed, True))
    np.testing.assert_array_equal(got, kern)
    # the wrapper on CPU tensors is the plain version, exact here too
    np.testing.assert_array_equal(
        resize_taps_cf(torch.from_numpy(x), *target, True, transposed)
        .numpy(), kern)


# -- (d) kernel H's plan -------------------------------------------------------

# kernel A's plans at MAIN_PATH_CONVS before kernel H moved onto its engine
# (the fields of ConvPlan: mt, nt, tw, th, n_split, cc, n_cc, ksteps, n_wt,
# n_ht, db, blocks, smem)
A_PLANS = {
    ((1, 64, 12, 160, 320), 12): (2, 2, 32, 4, 1, 12, 1, 14, 10, 40, 4, 6400, 25792),
    ((1, 64, 12, 160, 320), 1): (4, 1, 64, 4, 1, 12, 1, 14, 5, 40, 4, 3200, 44224),
    ((1, 64, 4, 160, 320), 4): (4, 1, 64, 4, 1, 4, 1, 5, 5, 40, 4, 3200, 14752),
    ((1, 64, 4, 160, 320), 8): (4, 1, 64, 4, 1, 4, 1, 5, 5, 40, 4, 3200, 14752),
    ((1, 64, 4, 160, 320), 12): (4, 2, 64, 4, 1, 4, 1, 5, 5, 40, 1, 12800, 14752),
    ((1, 32, 8, 80, 160), 8): (2, 1, 32, 4, 1, 8, 1, 9, 5, 20, 4, 800, 17184),
    ((1, 32, 8, 80, 160), 16): (4, 2, 32, 8, 1, 8, 1, 9, 5, 10, 1, 1600, 27424),
    ((1, 32, 8, 80, 160), 24): (4, 3, 32, 8, 1, 8, 1, 9, 5, 10, 1, 1600, 27424),
    ((1, 16, 16, 40, 80), 16): (2, 2, 16, 8, 1, 16, 1, 18, 5, 5, 1, 400, 34368),
    ((1, 16, 16, 40, 80), 32): (2, 4, 16, 8, 1, 16, 1, 18, 5, 5, 1, 400, 34368),
    ((1, 16, 16, 40, 80), 48): (2, 6, 16, 8, 1, 16, 1, 18, 5, 5, 1, 400, 34368),
    ((4, 64, 12, 64, 128), 12): (2, 2, 32, 4, 1, 12, 1, 14, 4, 16, 4, 4096, 25792),
    ((4, 64, 12, 64, 128), 1): (4, 1, 64, 4, 1, 12, 1, 14, 2, 16, 4, 2048, 44224),
    ((4, 64, 12, 64, 128), 4): (4, 1, 64, 4, 1, 12, 1, 14, 2, 16, 4, 2048, 44224),
    ((4, 64, 4, 64, 128), 4): (4, 1, 64, 4, 1, 4, 1, 5, 2, 16, 4, 2048, 14752),
    ((4, 64, 4, 64, 128), 8): (4, 1, 64, 4, 1, 4, 1, 5, 2, 16, 4, 2048, 14752),
    ((4, 64, 4, 64, 128), 12): (4, 2, 64, 4, 1, 4, 1, 5, 2, 16, 1, 8192, 14752),
    ((4, 32, 8, 32, 64), 8): (2, 1, 32, 4, 1, 8, 1, 9, 2, 8, 4, 512, 17184),
    ((4, 32, 8, 32, 64), 16): (4, 2, 64, 4, 1, 8, 1, 9, 1, 8, 1, 1024, 29472),
    ((4, 32, 8, 32, 64), 24): (4, 3, 64, 4, 1, 8, 1, 9, 1, 8, 1, 1024, 29472),
    ((4, 16, 16, 16, 32), 16): (2, 2, 32, 4, 1, 16, 1, 18, 1, 4, 1, 256, 34368),
    ((4, 16, 16, 16, 32), 32): (2, 4, 32, 4, 1, 16, 1, 18, 1, 4, 1, 256, 34368),
    ((4, 16, 16, 16, 32), 48): (2, 6, 32, 4, 1, 16, 1, 18, 1, 4, 1, 256, 34368),
    ((4, 64, 1, 64, 128), 12): (4, 2, 64, 4, 1, 1, 1, 2, 2, 16, 1, 8192, 3712),
    ((4, 64, 8, 64, 128), 4): (4, 1, 64, 4, 1, 8, 1, 9, 2, 16, 4, 2048, 29472),
    ((4, 32, 16, 32, 64), 8): (2, 1, 32, 4, 1, 16, 1, 18, 2, 8, 4, 512, 34368),
    ((4, 32, 24, 32, 64), 8): (2, 1, 32, 4, 1, 12, 2, 14, 2, 8, 4, 512, 25792),
    ((4, 16, 32, 16, 32), 16): (2, 2, 32, 4, 1, 16, 2, 18, 1, 4, 1, 256, 34368),
    ((4, 16, 48, 16, 32), 16): (2, 2, 32, 4, 1, 16, 3, 18, 1, 4, 1, 256, 34368),
}
# chip_smoke.py's small shapes for kernels A and H
SMALL_CONVS = [((1, 4, 12, 16, 24), 12), ((1, 3, 12, 8, 13), 1),
               ((2, 3, 16, 9, 70), 48), ((1, 7, 12, 12, 40), 16),
               ((1, 1, 4, 8, 8), 4), ((1, 3, 12, 10, 80), 36),
               ((2, 2, 36, 9, 80), 12), ((1, 5, 36, 20, 33), 36)]


@pytest.mark.parametrize("shape,cout", MAIN_PATH_CONVS + SMALL_CONVS)
def test_dblock_plan_covers_once(shape, cout):
    b, d, cin, h, w = shape
    plan = conv_plan_dblock(b, d, cin, h, w, cout)
    assert plan.db == 4 and plan.th >= 4 and plan.tw <= 32
    assert (plan.mt, plan.nt, plan.db) in CONV_INSTANCES
    assert plan.smem <= 227 * 1024
    n_x, n_d = plan.n_wt * plan.n_ht, -(-d // plan.db)
    assert plan.blocks == n_x * n_d * b * plan.n_split
    seen = np.zeros((b, d, cout, h, w), np.int32)
    for bz in range(b * plan.n_split):
        for by in range(n_d):
            for bx in range(n_x):
                bb, planes, chans, rows, cols = conv_block_region(plan, bx, by,
                                                                  bz)
                planes, chans = _clip(planes, d), _clip(chans, cout)
                rows, cols = _clip(rows, h), _clip(cols, w)
                assert len(planes) and len(chans) and len(rows) and \
                    len(cols), "empty block"
                seen[bb, planes.start:planes.stop, chans.start:chans.stop,
                     rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,cout", MAIN_PATH_CONVS)
def test_conv_plan_unchanged(shape, cout):
    assert tuple(conv_plan(*shape, cout)) == A_PLANS[(shape, cout)]
