"""Kernels F (``cvstem_dw``) and B (``cvstem_affine``) on the engines of
kernels D and A with the cost-volume input policy, emulated on the CPU
against the plain versions and the JAX package's Pallas kernels in
interpret mode.

The CUDA kernels run only on the card (chip_smoke.py holds each against its
plain version there, and two launches of F against each other). What
decides their results and is plain Python is checked here:

(a) the policy's staging rules (ops/cvstem.py::stage_row, stage_piece,
    live_plane, dw_live_steps, the Python form of csrc/volume_src.cuh):
    every piece's source column and copy width (16 bytes only where the
    source is aligned and wholly inside), the diagonal's zero fill and the
    right-halo mask. Staged in numpy over every plane, at the main-path
    tiles and at ragged ones, the slab equals the zero-padded materialized
    volume exactly, on integer data: D >= W, W % 4 != 0, and C <= 8, where
    one channel chunk holds both halves. A plane is dead under a tile
    exactly where it is zero under the tile and its halo.
(b) kernel F's plan (``cvstem_dw_plan``) covers every (plane, position,
    input channel, output channel) once at the train shape and at
    chip_smoke.py's small stem shapes, with two waves of blocks where the
    output has 264 x 128 positions; its order of summation (row groups,
    the live run of planes, partials, the sum pass's segments) emulated in
    float64 is within 1e-9 of ``cvstem_dw_plain``, and on integers equals
    the Pallas kernel.
(c) kernel B's plan (``cvstem_plan``) covers every output once at the eval
    and train geometries with at least 264 blocks, on compiled instances;
    kernel B's 3xTF32 arithmetic (kernel A's, through pack_weights_tf32 at
    B's plan, on the volume's stages) is within CONV_RTOL = 1e-5 of the
    largest output of ``cvstem_brc_plain`` and of the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rag_tpu.ops.pallas_conv3d import pack_weights as jax_pack_weights
from rag_tpu.ops.pallas_cvstem import cvstem_dw_pallas, cvstem_forward_cf
from rag_tpu_torch.ops.conv3d import (
    CONV_MIN_BLOCKS,
    CONV_MIN_VOXELS,
    DW_MAX_SMEM,
    DW_MAX_THREADS,
    DW_SEGS,
    conv_block_region,
    dw_block_region,
    dw_blocking,
    pack_weights_tf32,
    tf32_round,
)
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.cvstem import (
    CVSTEM_INSTANCES,
    cvstem_brc_plain,
    cvstem_dw,
    cvstem_dw_plain,
    cvstem_dw_plan,
    cvstem_plan,
    dw_live_steps,
    live_plane,
    stage_piece,
)
from test_torch_port_redesign import _fragments_to_b, _tf32_trunc

CONV_RTOL = 1e-5   # of max |plain|, as kernel A is held


def _volume_np(x, y, nd):
    """The materialized (B, D, 2C, H, W) volume of (B, C, H, W) maps."""
    return cost_volume_cf(torch.from_numpy(x).permute(0, 2, 3, 1),
                          torch.from_numpy(y).permute(0, 2, 3, 1),
                          nd).numpy()


# -- (a) the staging rules ----------------------------------------------------

def _stage_slab(x, y, nd, p, h0, th, w0, tw, c0, n_chan, vec):
    """Plane p's slab (n_chan channels from c0, th + 2 rows from h0 - 1,
    tw + 8 columns from w0 - 4) as a block stages it, piece by piece, from
    the feature maps of batch 0; checks each piece's copy width and that
    it reads inside its source row. Returns the slab and, per half, the
    pieces of one of its rows that copy 4 bytes at a time."""
    c, h, w = x.shape[1:]
    slab = np.full((n_chan, th + 2, tw + 8), np.nan)
    rows = np.arange(h0 - 1, h0 + th + 1)
    row_ok = ((rows >= 0) & (rows < h))[None, :, None]
    narrow = [0, 0]
    for half in (0, 1):
        # the chunk's channels in this half (the pieces are the same for
        # every channel and row of a half)
        lo, hi = max(c0, half * c), min(c0 + n_chan, (half + 1) * c)
        if lo >= hi:
            continue
        src = (y if half else x)[0, lo - half * c:hi - half * c]
        src = src[:, np.clip(rows, 0, h - 1)]
        out = slab[lo - c0:hi - c0]
        for q in range((tw + 8) // 4):
            j0 = w0 - 4 + 4 * q
            # a plane outside the volume: the policy's empty row
            pieces = (stage_piece(half, p, j0, w, vec) if 0 <= p < nd
                      else [(16, j0, None)] if vec
                      else [(4, j, None) for j in range(j0, j0 + 4)])
            narrow[half] += pieces[0][0] == 4
            for width, j, s in pieces:
                n = width // 4
                col = j - (w0 - 4)
                if s is None:
                    out[:, :, col:col + n] = 0
                    continue
                assert 0 <= s and s + n <= w, "a copy reads outside its row"
                if width == 16:
                    assert vec and s % 4 == 0, "an unaligned 16-byte copy"
                out[:, :, col:col + n] = np.where(row_ok, src[:, :, s:s + n],
                                                  0)
    return slab, narrow


def _ref_slab(vol, p, h0, th, w0, tw, c0, n_chan):
    """The same slab cut from the volume, zero outside it."""
    _, nd, c2, h, w = vol.shape
    out = np.zeros((n_chan, th + 2, tw + 8))
    if not 0 <= p < nd:
        return out
    for r, hh in enumerate(range(h0 - 1, h0 + th + 1)):
        if 0 <= hh < h:
            js = np.arange(w0 - 4, w0 + tw + 4)
            ok = (js >= 0) & (js < w)
            out[:, r, ok] = vol[0, p, c0:c0 + n_chan, hh][:, js[ok]]
    return out


# (b, c, h, w, nd, th, tw, chunks): the main path's tiles at the train
# width (F's and B's plans at 64 x 128), then ragged ones: D past W with
# W % 4 != 0 (4-byte copies), W % 4 == 0 with a ragged last tile, and
# C <= 8 with both halves in one channel chunk
STAGE_CASES = [
    (1, 12, 6, 128, 64, 4, 32, 2), (1, 12, 6, 128, 64, 8, 16, 2),
    (1, 12, 5, 21, 24, 4, 16, 2), (1, 12, 5, 68, 72, 4, 32, 2),
    (1, 3, 4, 13, 16, 2, 16, 1), (1, 4, 4, 36, 9, 4, 32, 1),
]


@pytest.mark.parametrize("b,c,h,w,nd,th,tw,chunks", STAGE_CASES)
def test_staged_slab_equals_padded_volume(b, c, h, w, nd, th, tw, chunks):
    rng = np.random.default_rng(w + nd + c)
    x = rng.integers(1, 8, (b, c, h, w)).astype(np.float32)
    y = rng.integers(-8, -1, (b, c, h, w)).astype(np.float32)
    vol = _volume_np(x, y, nd)
    vec = w % 4 == 0
    ci = 2 * c // chunks
    for w0 in range(0, w, tw):
        for h0 in sorted({0, max(0, h - th)}):
            for p in range(-1, nd + 1):
                for c0 in range(0, 2 * c, ci):
                    got, narrow = _stage_slab(x, y, nd, p, h0, th, w0, tw,
                                              c0, ci, vec)
                    want = _ref_slab(vol, p, h0, th, w0, tw, c0, ci)
                    np.testing.assert_array_equal(got, want)
                    if vec and 0 <= p < nd:
                        # X's rows: one 4-byte piece at most, the one that
                        # straddles the diagonal; Y's at planes p % 4 == 0:
                        # none
                        assert narrow[0] <= 1
                        if p % 4 == 0:
                            assert narrow[1] == 0
                    # the tile and its halo read slab columns 3 .. tw + 4
                    read = want[:, :, 3:tw + 5]
                    if not live_plane(p, w0, tw):
                        assert not read.any()
                    elif 0 <= p < min(nd, w) and h0 == 0 and c0 == 0:
                        assert read.any()


@pytest.mark.parametrize("d0,n,w0,tw", [(0, 64, 0, 32), (30, 8, 0, 32),
                                        (33, 8, 0, 32), (40, 8, 0, 32),
                                        (0, 64, 96, 32), (13, 5, 8, 4)])
def test_dw_live_steps_stop_at_the_first_dead_plane(d0, n, w0, tw):
    k = dw_live_steps(d0, n, w0, tw)
    for j in range(n):
        d = d0 + j
        reads_live = any(live_plane(p, w0, tw) for p in (d - 1, d, d + 1))
        assert reads_live == (j < k)


# -- (b) kernel F's plan and order of summation -------------------------------

# (b, c, h, w, nd, cout): the train shape, then chip_smoke.py's small stem
# shapes
TRAIN_STEM = (4, 12, 64, 128, 64, 12)
SMALL_STEM = [(1, 12, 8, 20, 6, 12), (1, 2, 8, 8, 8, 3), (2, 3, 6, 11, 5, 4),
              (1, 2, 5, 6, 9, 3), (1, 3, 8, 13, 13, 12),
              (2, 12, 9, 130, 11, 12), (1, 12, 7, 21, 24, 12),
              (2, 12, 10, 68, 72, 12)]


def _clip(r: range, n: int) -> range:
    return range(r.start, min(r.stop, n))


def _dw_blocks(plan):
    for bx in range(plan.n_pos):
        for by in range(plan.n_ci):
            for bz in range(plan.n_co):
                yield bx, by, bz


@pytest.mark.parametrize("b,c,h,w,nd,cout", [TRAIN_STEM] + SMALL_STEM)
def test_cvstem_dw_plan_covers_and_fills(b, c, h, w, nd, cout):
    plan = cvstem_dw_plan(b, nd, c, h, w, cout)
    cin = 2 * c
    assert plan == dw_blocking(b, nd, cin, h, w, cout, plan.th, plan.tw,
                               plan.db, plan.co_t, plan.kh_t)
    assert plan.threads <= DW_MAX_THREADS and plan.smem <= DW_MAX_SMEM
    assert 4 * plan.workspace <= 32 << 20
    if b * nd * h * w >= CONV_MIN_VOXELS:
        assert plan.blocks >= CONV_MIN_BLOCKS
    if cin == 24:
        assert (plan.ci, plan.n_ci) == (12, 2)   # one half per chunk
    seen = np.zeros((b, nd, h, w), np.int32)
    for bx in range(plan.n_pos):
        bb, planes, rows, cols, _, _ = dw_block_region(plan, bx, 0, 0)
        planes, rows, cols = _clip(planes, nd), _clip(rows, h), _clip(cols, w)
        assert len(planes) and len(rows) and len(cols), "empty block"
        seen[bb, planes.start:planes.stop, rows.start:rows.stop,
             cols.start:cols.stop] += 1
    assert (seen == 1).all()
    chans = np.zeros((cin, cout), np.int32)
    for by in range(plan.n_ci):
        for bz in range(plan.n_co):
            _, _, _, _, cis, cos = dw_block_region(plan, 0, by, bz)
            cis, cos = _clip(cis, cin), _clip(cos, cout)
            chans[cis.start:cis.stop, cos.start:cos.stop] += 1
    assert (chans == 1).all()


def emulate_cvstem_dw(x, y, dz, nd, plan):
    """Kernel F's order of summation for a plan: kernel D's (row groups
    added in group order, one partial per block, the sum pass's segments)
    over the materialized volume, each block walking only its live run of
    planes (``dw_live_steps``) and writing a partial of zeros where that
    run is empty."""
    vol = cost_volume_cf(x.permute(0, 2, 3, 1), y.permute(0, 2, 3, 1), nd)
    _, _, cin, h_, w_ = vol.shape
    cout = dz.shape[2]
    vp = F.pad(vol, (1, 1, 1, 1, 0, 0, 1, 1))
    ws = torch.full((plan.n_pos, 3, 3, 3, cin, cout), float("nan"),
                    dtype=x.dtype)
    rpg = plan.th // plan.groups
    for bx, by, bz in _dw_blocks(plan):
        b, planes, rows, cols, cis, cos = dw_block_region(plan, bx, by, bz)
        n = dw_live_steps(planes.start, len(_clip(planes, nd)), cols.start,
                          plan.tw)
        planes, cols = range(planes.start, planes.start + n), _clip(cols, w_)
        ci_s = slice(cis.start, min(cis.stop, cin))
        co_s = slice(cos.start, min(cos.stop, cout))
        acc = torch.zeros((3, 3, 3, ci_s.stop - ci_s.start,
                           co_s.stop - co_s.start), dtype=x.dtype)
        for g in range(plan.groups):
            grows = _clip(rows[g * rpg:(g + 1) * rpg], h_)
            part = torch.zeros_like(acc)
            if len(grows) and n:
                gz = dz[b, planes.start:planes.stop, co_s,
                        grows.start:grows.stop, cols.start:cols.stop]
                for kd in range(3):
                    for kh in range(3):
                        for kw in range(3):
                            xs = vp[b, planes.start + kd:planes.stop + kd,
                                    ci_s, grows.start + kh:grows.stop + kh,
                                    cols.start + kw:cols.stop + kw]
                            part[kd, kh, kw] = torch.einsum(
                                "dihw,dohw->io", xs, gz)
            acc = part if g == 0 else acc + part
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


# (b, c, h, w, nd, cout, forced (th, tw, db, co_t, kh_t) or None): C = 12
# with halves in separate chunks, D past W (blocks with no live plane, runs
# cut short), a ragged W tile; C = 3 with both halves in one chunk
F_EMU_CASES = [
    (2, 12, 8, 21, 24, 12, None), (1, 12, 4, 20, 24, 12, (4, 16, 8, 12, 1)),
    (1, 3, 8, 13, 13, 12, None), (2, 2, 5, 11, 9, 4, (4, 4, 3, 4, 3)),
]


def _f_plan(b, c, h, w, nd, cout, forced):
    if forced is None:
        return cvstem_dw_plan(b, nd, c, h, w, cout)
    return dw_blocking(b, nd, 2 * c, h, w, cout, *forced)


@pytest.mark.parametrize("b,c,h,w,nd,cout,forced", F_EMU_CASES)
def test_cvstem_dw_emulation_float64(b, c, h, w, nd, cout, forced):
    rng = np.random.default_rng(c * 100 + w + nd)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)))
    y = torch.from_numpy(rng.standard_normal((b, c, h, w)))
    dz = torch.from_numpy(rng.standard_normal((b, nd, cout, h, w)))
    plan = _f_plan(b, c, h, w, nd, cout, forced)
    got = emulate_cvstem_dw(x, y, dz, nd, plan)
    ref = cvstem_dw_plain(x, y, dz, nd)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-9 * float(ref.abs().max()))


@pytest.mark.parametrize("b,c,h,w,nd,cout,forced", F_EMU_CASES[1:])
def test_cvstem_dw_emulation_equals_pallas_on_integers(b, c, h, w, nd, cout,
                                                       forced):
    rng = np.random.default_rng(c + w * 7 + nd)
    x = rng.integers(-3, 4, (b, c, h, w)).astype(np.float32)
    y = rng.integers(-3, 4, (b, c, h, w)).astype(np.float32)
    dz = rng.integers(-2, 3, (b, nd, cout, h, w)).astype(np.float32)
    plan = _f_plan(b, c, h, w, nd, cout, forced)
    got = emulate_cvstem_dw(*(torch.from_numpy(a).double()
                              for a in (x, y, dz)), nd, plan)
    kern = np.asarray(cvstem_dw_pallas(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(dz), nd, interpret=True))
    np.testing.assert_array_equal(got.numpy(), kern)
    # the wrapper on CPU tensors is the plain version, exact here too
    np.testing.assert_array_equal(
        cvstem_dw(*(torch.from_numpy(a) for a in (x, y, dz)), nd).numpy(),
        kern)


# -- (c) kernel B's plan and arithmetic ---------------------------------------

EVAL_STEM = (1, 12, 160, 320, 64, 12)


@pytest.mark.parametrize("b,c,h,w,nd,cout", [EVAL_STEM, TRAIN_STEM]
                         + SMALL_STEM)
def test_cvstem_plan_covers_and_fills(b, c, h, w, nd, cout):
    plan = cvstem_plan(b, nd, c, h, w, cout)
    assert (plan.mt, plan.nt, plan.db) in CVSTEM_INSTANCES
    assert plan.n_cc * plan.cc >= 2 * c and plan.ksteps * 8 >= 9 * plan.cc
    if 2 * c == 24:
        assert (plan.cc, plan.n_cc) == (12, 2)   # one half per stage
    n_x, n_d = plan.n_wt * plan.n_ht, -(-nd // plan.db)
    assert plan.blocks == n_x * n_d * b * plan.n_split
    hw = np.zeros((h, w), np.int32)
    for bx in range(n_x):
        _, _, _, rows, cols = conv_block_region(plan, bx, 0, 0)
        hw[np.ix_([i for i in rows if i < h], [j for j in cols if j < w])] += 1
    assert (hw == 1).all()
    planes = np.zeros(nd, np.int32)
    for by in range(n_d):
        planes[[i for i in conv_block_region(plan, 0, by, 0)[1]
                if i < nd]] += 1
    assert (planes == 1).all()
    chans = np.zeros(cout, np.int32)
    for bz in range(plan.n_split):
        chans[[i for i in conv_block_region(plan, 0, 0, bz)[2]
               if i < cout]] += 1
    assert (chans == 1).all()
    if b * nd * h * w >= CONV_MIN_VOXELS:
        assert plan.blocks >= CONV_MIN_BLOCKS


def emulate_cvstem_tf32(x, y, w3, scale, bias, nd, relu):
    """Kernel B's arithmetic: kernel A's 3xTF32 products (test_torch_port_
    redesign.py::emulate_conv_tf32) at kernel B's plan, over the volume's
    stages (input plane kd, chunk of cc of its 2C channels)."""
    b, c, h, wd = x.shape
    cout = w3.shape[4]
    vol = cost_volume_cf(x.permute(0, 2, 3, 1), y.permute(0, 2, 3, 1), nd)
    cin = 2 * c
    plan = cvstem_plan(b, nd, c, h, wd, cout)
    bm = _fragments_to_b(pack_weights_tf32(w3, plan), plan)
    vp = F.pad(vol, (1, 1, 1, 1, 0, 0, 1, 1))
    k = torch.arange(plan.ksteps * 8)
    tap9, ci = k // plan.cc, k % plan.cc
    out = x.new_zeros(b, nd, h, wd, plan.n_split * plan.nt * 8)
    for kd in range(3):
        for chunk in range(plan.n_cc):
            cin_i = chunk * plan.cc + ci
            valid = (k < 9 * plan.cc) & (cin_i < cin)
            a = x.new_zeros(b, nd, h, wd, len(k))
            for i in valid.nonzero()[:, 0].tolist():
                kh, kw = int(tap9[i]) // 3, int(tap9[i]) % 3
                a[..., i] = vp[:, kd:kd + nd, int(cin_i[i]), kh:kh + h,
                               kw:kw + wd]
            a_hi = tf32_round(a)
            a_lo = tf32_round(a - a_hi)
            s = kd * plan.n_cc + chunk
            b_hi = torch.cat(list(bm[0, :, s]), dim=-1)
            b_lo = _tf32_trunc(torch.cat(list(bm[1, :, s]), dim=-1))
            out += a_hi @ b_hi + (a_lo @ b_hi + a_hi @ b_lo)
    out = out[..., :cout].permute(0, 1, 4, 2, 3) \
        * scale.reshape(1, 1, -1, 1, 1) + bias.reshape(1, 1, -1, 1, 1)
    return torch.relu(out) if relu else out


# (b, c, h, w, nd, cout, relu): the stem's 24 -> 12 (two stages of one half
# a plane, Cout padded to 16), D past W, and C = 3 (one stage a plane); H a
# multiple of 8, as the Pallas kernel's tilings need
B_CASES = [(1, 12, 8, 20, 6, 12, True), (1, 12, 8, 10, 12, 12, False),
           (2, 3, 8, 13, 5, 4, True)]


@pytest.mark.parametrize("b,c,h,w,nd,cout,relu", B_CASES)
def test_cvstem_tf32x3_within_conv_rtol(b, c, h, w, nd, cout, relu):
    rng = np.random.default_rng(c + w + nd)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    y = rng.standard_normal((b, c, h, w)).astype(np.float32)
    w3 = (rng.standard_normal((3, 3, 3, 2 * c, cout)) * 0.2).astype(np.float32)
    scale = (rng.standard_normal(cout) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, y, w3, scale, bias)]
    out = emulate_cvstem_tf32(*t, nd, relu).numpy()
    plain = cvstem_brc_plain(*t, nd, relu).numpy()
    kern = np.asarray(cvstem_forward_cf(
        jnp.asarray(x), jnp.asarray(y), jax_pack_weights(jnp.asarray(w3)),
        jnp.asarray(scale), jnp.asarray(bias), nd, relu=relu,
        interpret=True))
    for ref in (plain, kern):
        np.testing.assert_allclose(
            out, ref, rtol=0,
            atol=CONV_RTOL * max(1.0, float(np.abs(ref).max())))
