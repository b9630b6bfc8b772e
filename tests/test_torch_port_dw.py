"""Kernel D's blocking (``conv3d_dw_cf``, csrc/conv3d_dw.cu), emulated in
torch on the CPU against the plain version and the JAX package's Pallas
kernel in interpret mode.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there, and two launches against each other). What decides
its result and is plain Python is checked here:

(a) ``dw_plan`` at every kernel D call of a training step of the committed
    checkpoint's task-0 stage (4 x 192 x 384 crops) and at chip_smoke.py's
    small shapes: the blocks cover every (plane, position, input channel,
    output channel) once and none is empty; a call whose output has at
    least 264 x 128 positions gets at least 264 blocks (two waves on 132
    SMs); the workspace stays within 32 MB and a block within its shared
    memory; at Cout >= 4 a thread does at least 6 FMAs per shared load.
(b) the order of summation: each block's row groups summed apart over
    their rows, the groups added in group order, the partials written to
    the workspace (every entry written), the sum pass's segments of
    partials each added in order and the segments in segment order. In
    float64 on random data the emulation is within 1e-9 of the plain
    version; on integer data (every sum exact in float32) within 1e-9 of
    the Pallas kernel, at the plan's blocking and at forced ones with row
    groups, runs of planes and W tiles that leave ragged edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.ops.pallas_conv3d import conv3d_dw_pallas
from rag_tpu_torch.ops.conv3d import (
    CONV_MIN_BLOCKS,
    CONV_MIN_VOXELS,
    DW_MAX_SMEM,
    DW_MAX_THREADS,
    DW_SEGS,
    conv3d_dw_cf,
    conv3d_dw_cf_plain,
    dw_block_region,
    dw_blocking,
    dw_plan,
)

# (x shape, cout) of every kernel D call in one training step of task 0's
# stage at 4 x 192 x 384 (quarter resolution and the cells at 1/3, 1/6
# and 1/12 of it, merged Couts included), then chip_smoke.py's small
# shapes for kernel D
MAIN_PATH_DW = [
    ((4, 64, 4, 64, 128), 4), ((4, 64, 4, 64, 128), 8),
    ((4, 64, 4, 64, 128), 12), ((4, 64, 12, 64, 128), 12),
    ((4, 64, 12, 64, 128), 1), ((4, 32, 8, 32, 64), 8),
    ((4, 32, 8, 32, 64), 16), ((4, 32, 8, 32, 64), 24),
    ((4, 16, 16, 16, 32), 16), ((4, 16, 16, 16, 32), 32),
    ((4, 16, 16, 16, 32), 48),
]
SMALL_DW = [
    ((1, 4, 12, 16, 24), 12), ((1, 3, 12, 8, 13), 1), ((2, 3, 16, 9, 70), 48),
    ((1, 7, 12, 12, 40), 16), ((1, 1, 4, 8, 8), 4), ((1, 3, 12, 10, 80), 36),
    ((2, 2, 36, 9, 80), 12), ((1, 5, 36, 20, 33), 36),
    ((1, 3, 4, 10, 13), 4), ((2, 3, 8, 9, 16), 8), ((2, 9, 4, 32, 64), 4),
]


def _clip(r: range, n: int) -> range:
    return range(r.start, min(r.stop, n))


def _blocks(plan):
    for bx in range(plan.n_pos):
        for by in range(plan.n_ci):
            for bz in range(plan.n_co):
                yield bx, by, bz


@pytest.mark.parametrize("shape,cout", MAIN_PATH_DW + SMALL_DW)
def test_dw_plan_covers_and_fills(shape, cout):
    b, d, cin, h, w = shape
    plan = dw_plan(b, d, cin, h, w, cout)
    assert plan == dw_blocking(b, d, cin, h, w, cout, plan.th, plan.tw,
                               plan.db, plan.co_t, plan.kh_t)
    assert plan.threads == 9 * plan.ci // plan.kh_t * plan.groups
    assert plan.threads <= DW_MAX_THREADS
    assert plan.th % plan.groups == 0 and plan.tw % 4 == 0
    assert plan.smem <= DW_MAX_SMEM
    assert 4 * plan.workspace <= 32 << 20
    assert plan.blocks == plan.n_pos * plan.n_ci * plan.n_co
    if b * d * h * w >= CONV_MIN_VOXELS:
        assert plan.blocks >= CONV_MIN_BLOCKS
    # positions: the first-pass blocks (bx) tile (b, d, h, w) exactly once
    seen = np.zeros((b, d, h, w), np.int32)
    for bx in range(plan.n_pos):
        bb, planes, rows, cols, _, _ = dw_block_region(plan, bx, 0, 0)
        planes, rows, cols = _clip(planes, d), _clip(rows, h), _clip(cols, w)
        assert len(planes) and len(rows) and len(cols), "empty block"
        seen[bb, planes.start:planes.stop, rows.start:rows.stop,
             cols.start:cols.stop] += 1
    assert (seen == 1).all()
    # channels: the (by, bz) chunks tile (cin, cout) exactly once
    chans = np.zeros((cin, cout), np.int32)
    for by in range(plan.n_ci):
        for bz in range(plan.n_co):
            _, _, _, _, cis, cos = dw_block_region(plan, 0, by, bz)
            cis, cos = _clip(cis, cin), _clip(cos, cout)
            assert len(cis) and len(cos), "empty block"
            chans[cis.start:cis.stop, cos.start:cos.stop] += 1
    assert (chans == 1).all()
    # (a): per 4 columns of a row, kh_t float4s of x and co_t of dz feed
    # 12 * kh_t * co_t FMAs; a row starts with 2 * kh_t more loads of x
    if cout >= 4:
        per_row = plan.tw // 4
        fmas = per_row * 12 * plan.kh_t * plan.co_t
        loads = per_row * (plan.kh_t + plan.co_t) + 2 * plan.kh_t
        assert fmas / loads >= 6


def emulate_dw(x: torch.Tensor, dz: torch.Tensor, plan) -> torch.Tensor:
    """Kernel D's order of summation for a plan (see the module doc)."""
    b_, d_, cin, h_, w_ = x.shape
    cout = dz.shape[2]
    xp = F.pad(x, (1, 1, 1, 1, 0, 0, 1, 1))
    ws = torch.full((plan.n_pos, 3, 3, 3, cin, cout), float("nan"),
                    dtype=x.dtype)
    rpg = plan.th // plan.groups
    for bx, by, bz in _blocks(plan):
        b, planes, rows, cols, cis, cos = dw_block_region(plan, bx, by, bz)
        planes, cols = _clip(planes, d_), _clip(cols, w_)
        ci_s = slice(cis.start, min(cis.stop, cin))
        co_s = slice(cos.start, min(cos.stop, cout))
        d_s = slice(planes.start, planes.stop)
        acc = None
        for g in range(plan.groups):
            grows = _clip(rows[g * rpg:(g + 1) * rpg], h_)
            part = torch.zeros((3, 3, 3, ci_s.stop - ci_s.start,
                                co_s.stop - co_s.start), dtype=x.dtype)
            if len(grows):
                gz = dz[b, d_s, co_s, grows.start:grows.stop,
                        cols.start:cols.stop]
                for kd in range(3):
                    for kh in range(3):
                        for kw in range(3):
                            xs = xp[b, planes.start + kd:planes.stop + kd,
                                    ci_s, grows.start + kh:grows.stop + kh,
                                    cols.start + kw:cols.stop + kw]
                            part[kd, kh, kw] = torch.einsum(
                                "dihw,dohw->io", xs, gz)
            acc = part if acc is None else acc + part
        ws[bx, :, :, :, ci_s, co_s] = acc
    assert not torch.isnan(ws).any(), "workspace entry left unwritten"
    flat = ws.reshape(plan.n_pos, -1)
    seg_len = -(-plan.n_pos // DW_SEGS)
    total = None
    for s in range(DW_SEGS):
        seg = torch.zeros(flat.shape[1], dtype=x.dtype)
        for p in range(s * seg_len, min((s + 1) * seg_len, plan.n_pos)):
            seg = seg + flat[p]
        total = seg if total is None else total + seg
    return total.reshape(3, 3, 3, cin, cout)


# (b, d, cin, h, w, cout): Cin 4 -> 4, 12 -> 1, 16 -> 16, W = 13, B = 2;
# each at its plan and at forced blockings (th, tw, db, co_t, kh_t) with
# row groups, runs of planes, ragged tiles and ragged channel chunks
EMU_CASES = [
    ((2, 5, 4, 10, 13, 4), None), ((2, 5, 4, 10, 13, 4), (8, 16, 2, 4, 3)),
    ((2, 5, 4, 10, 13, 4), (4, 32, 3, 4, 3)),
    ((2, 3, 12, 8, 13, 1), None), ((2, 3, 12, 8, 13, 1), (4, 16, 2, 1, 3)),
    ((2, 3, 16, 6, 13, 16), None),
    ((2, 3, 16, 6, 13, 16), (4, 16, 1, 12, 1)),
    ((1, 4, 20, 5, 24, 36), (2, 16, 4, 8, 3)),
]


def _plan_for(case, forced):
    b, d, cin, h, w, cout = case
    if forced is None:
        return dw_plan(b, d, cin, h, w, cout)
    return dw_blocking(b, d, cin, h, w, cout, *forced)


@pytest.mark.parametrize("case,forced", EMU_CASES)
def test_dw_emulation_float64(case, forced):
    b, d, cin, h, w, cout = case
    rng = np.random.default_rng(cin * 100 + cout + w)
    x = torch.from_numpy(rng.standard_normal((b, d, cin, h, w)))
    dz = torch.from_numpy(rng.standard_normal((b, d, cout, h, w)))
    plan = _plan_for(case, forced)
    got = emulate_dw(x, dz, plan)
    ref = conv3d_dw_cf_plain(x, dz)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-9 * float(ref.abs().max()))


@pytest.mark.parametrize("case,forced", EMU_CASES[:7])
def test_dw_emulation_equals_pallas_on_integers(case, forced):
    b, d, cin, h, w, cout = case
    rng = np.random.default_rng(cin + cout * 7 + w)
    x = rng.integers(-3, 4, (b, d, cin, h, w)).astype(np.float32)
    dz = rng.integers(-2, 3, (b, d, cout, h, w)).astype(np.float32)
    plan = _plan_for(case, forced)
    got = emulate_dw(torch.from_numpy(x).double(),
                     torch.from_numpy(dz).double(), plan)
    kern = np.asarray(conv3d_dw_pallas(jnp.asarray(x), jnp.asarray(dz),
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, rtol=0, atol=1e-9)
    # the wrapper on CPU tensors is the plain version, exact here too
    np.testing.assert_array_equal(
        conv3d_dw_cf(torch.from_numpy(x), torch.from_numpy(dz)).numpy(),
        kern)
