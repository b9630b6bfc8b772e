"""The blocking of the redesigned kernels E (``cvstem_dxy``) and A
(``conv3d_affine_cf``), emulated in torch on the CPU against the plain
versions and the JAX package's Pallas kernels in interpret mode.

The CUDA kernels run only on the card (chip_smoke.py holds each against its
plain version there). What decides their results and is plain Python is
checked here, at small shapes:

(a) kernel E's blocking: its plan (chunks of output planes, W tiles), the
    dY half's shifted staging window, the two-slot ring with the next plane
    staged before the current one is used, the tap columns and masks, and
    the chunk partials summed in chunk order. Integer data keeps every sum
    exact, so in float32 the emulation equals the Pallas kernel and the
    plain version bit for bit (the tolerance of
    test_torch_port_train_kernels.py::test_cvstem_bwd_exact_against_jax);
    in float64 it is within 1e-9 of the plain version on random data.
(b) the split of kernel A's weights (the plain version of its weight
    pass): hi + lo == w exactly, and hi has at most 10 explicit mantissa
    bits, rounded as cvt.rna.tf32.f32 rounds.
(c) kernel A's 3xTF32 arithmetic, through its packed B fragments and its
    k -> (tap, channel) order: within CONV_RTOL = 1e-5 of the largest
    output (as test_torch_port_kernels.py) of the plain conv and of the
    Pallas conv. One TF32 product alone (1xTF32) is not: its error is
    ~1e-4 of the output at these widths.
(d) kernel A's plan at every conv shape of the committed checkpoint's
    serving (1x480x960) and training (4x192x384) paths: the blocks cover
    every output voxel once, a shape with at least 264 x 128 output voxels
    gets at least 264 blocks (two waves on 132 SMs), and a smaller one no
    tile less than half full.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.ops.pallas_conv3d import _conv3d_pallas_cf
from rag_tpu.ops.pallas_conv3d import pack_weights as jax_pack_weights
from rag_tpu.ops.pallas_cvstem import cvstem_dxy_pallas
from rag_tpu_torch.ops.conv3d import (
    CONV_MIN_BLOCKS,
    CONV_MIN_VOXELS,
    conv3d_brc_cf_plain,
    conv_block_region,
    CONV_INSTANCES,
    conv_plan,
    pack_weights_tf32,
    split_tf32,
    tf32_round,
)
from rag_tpu_torch.ops.cvstem import (
    DXY_HALO,
    DXY_RING,
    DXY_TH,
    DXY_TW,
    cvstem_dxy_plain,
    dxy_plan,
    dxy_ring_slot,
    dxy_tap_column,
    dxy_window,
    pack_dxy_weights,
)

CONV_RTOL = 1e-5   # of max(1, max |ref|): float32 sums in another order
DXY_RTOL64 = 1e-9  # of max |ref|, float64


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- (a) kernel E ------------------------------------------------------------

def _stage(dz_q, h0, col0):
    """One dz plane (B, Cout, H, W) as kernel E stages it for a tile at
    row h0: rows h0-1 .. h0+TH, columns col0 .. col0+TW+3, zero outside."""
    b, cout, h, w = dz_q.shape
    out = dz_q.new_zeros(b, cout, DXY_TH + 2, DXY_TW + 2 * DXY_HALO)
    rows = torch.arange(h0 - 1, h0 + DXY_TH + 1)
    cols = torch.arange(col0, col0 + DXY_TW + 2 * DXY_HALO)
    rk = (rows >= 0) & (rows < h)
    ck = (cols >= 0) & (cols < w)
    out[:, :, rk.nonzero()[:, 0][:, None], ck.nonzero()[:, 0]] = \
        dz_q[:, :, rows[rk][:, None], cols[ck]]
    return out


def stage_window(dz_q, h0, half, w0, q):
    """Plane q's staged window for the tile at (h0, w0), as the float32
    instance stages it (one element a copy)."""
    return _stage(dz_q, h0, dxy_window(half, w0, q))


def emulate_dxy(dz, w3, plan, stage=stage_window):
    """Kernel E's two passes, block by block, as csrc/cvstem_dxy.cu runs
    them: for each (half, channel chunk, chunk of planes, tile), walk the
    dz planes q of the chunk with the next one staged into the other ring
    slot before plane q is used, add plane q's contribution to each output
    d = q + 1 - kd under d's mask, write the partial; then sum partials in
    chunk order. ``stage(dz_q, h0, half, w0, q)`` gives a plane's staged
    window as the block reads it (float32, (B, Cout, TH + 2, TW + 4))."""
    b, d, cout, h, w = dz.shape
    c = w3.shape[3] // 2
    wpk = pack_dxy_weights(w3, plan.ct, plan.n_cc)
    partial = dz.new_zeros(2, plan.n_chunks, b, plan.n_cc * plan.ct, h, w)
    for half in range(2):
        for cc in range(plan.n_cc):
            wt3 = wpk[half, cc].reshape(3, 3, 3, cout, plan.ct)
            for ck in range(plan.n_chunks):
                d0 = ck * plan.chunk
                for wt in range(plan.n_wt):
                    w0 = wt * DXY_TW
                    d_end = min(d, d0 + plan.chunk,
                                w0 + DXY_TW if half == 0 else w - w0)
                    for ht in range(plan.n_ht):
                        h0 = ht * DXY_TH
                        acc = dz.new_zeros(b, plan.ct, DXY_TH, DXY_TW)
                        ring = [None] * DXY_RING
                        q_lo, q_hi = max(d0 - 1, 0), min(d_end, d - 1)
                        if d0 < d_end and q_lo <= q_hi:
                            ring[dxy_ring_slot(q_lo)] = stage(
                                dz[:, q_lo], h0, half, w0, q_lo)
                        for q in range(q_lo, q_hi + 1) if d0 < d_end else ():
                            if q + 1 <= q_hi:
                                ring[dxy_ring_slot(q + 1)] = stage(
                                    dz[:, q + 1], h0, half, w0, q + 1)
                            slab = ring[dxy_ring_slot(q)]
                            for kd in range(3):
                                dd = q + 1 - kd
                                if dd < d0 or dd >= d_end:
                                    continue
                                coff = dxy_tap_column(half, kd)
                                j = w0 + torch.arange(DXY_TW)
                                keep = (j >= dd) if half == 0 else (j + dd < w)
                                for kh in range(3):
                                    for kw in range(3):
                                        v = slab[:, :, kh:kh + DXY_TH,
                                                 coff + kw:coff + kw + DXY_TW]
                                        acc += keep * torch.einsum(
                                            "bohx,oc->bchx", v,
                                            wt3[kd, kh, kw])
                        hh = min(DXY_TH, h - h0)
                        ww = min(DXY_TW, w - w0)
                        partial[half, ck, :, cc * plan.ct:(cc + 1) * plan.ct,
                                h0:h0 + hh, w0:w0 + ww] = acc[..., :hh, :ww]
    out = []
    for half in range(2):
        s = torch.zeros_like(partial[half, 0])
        for ck in range(plan.n_chunks):
            s = s + partial[half, ck]
        out.append(s[:, :c].contiguous())
    return tuple(out)


def _dxy_plan_with_chunk(b, d, cout, c, h, w, chunk):
    plan = dxy_plan(b, d, cout, c, h, w)
    if chunk is None:
        return plan
    n_chunks = -(-d // chunk)
    return plan._replace(chunk=chunk, n_chunks=n_chunks,
                         workspace=2 * n_chunks * b * c * h * w)


# (b, c, h, w, num_disp, cout, chunk): D not a multiple of the chunk (the
# plan's 2 planes, and 4 and 16 forced), num_disp past W, W = 13, two W
# tiles and two H tiles, batch 2, the real 12 channels
DXY_CASES = [
    (2, 3, 6, 13, 9, 4, None),
    (1, 2, 5, 6, 9, 3, None),
    (1, 12, 10, 70, 7, 12, None),
    (2, 2, 9, 13, 13, 3, 4),
    (1, 3, 8, 20, 19, 5, 16),
]


@pytest.mark.parametrize("b,c,h,w,nd,cout,chunk", DXY_CASES)
def test_dxy_blocking_exact_on_integers(b, c, h, w, nd, cout, chunk):
    rng = np.random.default_rng(b * 13 + w + nd)
    dz = rng.integers(-2, 3, (b, nd, cout, h, w)).astype(np.float32)
    w3 = rng.integers(-2, 3, (3, 3, 3, 2 * c, cout)).astype(np.float32)
    plan = _dxy_plan_with_chunk(b, nd, cout, c, h, w, chunk)
    assert plan.n_chunks * plan.chunk >= nd
    dx, dy = emulate_dxy(_t(dz), _t(w3), plan)
    px, py = cvstem_dxy_plain(_t(dz), _t(w3), nd)
    kx, ky = cvstem_dxy_pallas(jnp.asarray(dz), jnp.asarray(w3), nd,
                               interpret=True)
    for out, plain, kern in ((dx, px, kx), (dy, py, ky)):
        assert out.shape == (b, c, h, w)
        np.testing.assert_array_equal(out.numpy(), plain.numpy())
        np.testing.assert_array_equal(out.numpy(), np.asarray(kern))


@pytest.mark.parametrize("b,c,h,w,nd,cout,chunk", DXY_CASES)
def test_dxy_blocking_float64(b, c, h, w, nd, cout, chunk):
    rng = np.random.default_rng(b * 17 + w + nd)
    dz = _t(rng.standard_normal((b, nd, cout, h, w)))
    w3 = _t(rng.standard_normal((3, 3, 3, 2 * c, cout)))
    plan = _dxy_plan_with_chunk(b, nd, cout, c, h, w, chunk)
    for out, ref in zip(emulate_dxy(dz, w3, plan),
                        cvstem_dxy_plain(dz, w3, nd)):
        np.testing.assert_allclose(
            out.numpy(), ref.numpy(), rtol=0,
            atol=DXY_RTOL64 * float(ref.abs().max()))


def test_dxy_plan_train_shape():
    """At the task-0 train shape dz (4, 64, 12, 64, 128): chunks of 16
    planes, 512 blocks, a 12.6 MB workspace, two blocks per SM."""
    plan = dxy_plan(4, 64, 12, 12, 64, 128)
    assert (plan.chunk, plan.n_chunks, plan.ct, plan.n_cc, plan.kc) == \
        (16, 4, 12, 1, 12)
    assert plan.blocks == 512
    assert 4 * plan.workspace == 12_582_912
    assert 2 * plan.smem <= 227 * 1024


# -- (b) the host split of kernel A's weights --------------------------------

def test_split_tf32_exact_and_short():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(64) * 1e-30,
        rng.standard_normal(64) * 1e30, [0.0, -0.0, 1.0, -1.0]]
    ).astype(np.float32))
    n = w.numel()
    hi, lo = split_tf32(w)[:n], split_tf32(w)[n:]
    assert torch.equal(hi, tf32_round(w))
    assert torch.equal(hi + lo, w)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # lo holds what hi drops: below half a TF32 ulp of w
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


def test_tf32_round_ties_away_from_zero():
    """cvt.rna: to nearest, a tie (dropped bits exactly 0x1000) away from
    zero, for both signs."""
    base = np.array([0x3F800000, 0x3F801000, 0x3F802000, 0x3F803000,
                     0x3F800FFF, 0x3F801001, 0x40490FDB], np.uint32)
    want = np.array([0x3F800000, 0x3F802000, 0x3F802000, 0x3F804000,
                     0x3F800000, 0x3F802000, 0x40490000], np.uint32)
    for sign in (0, 0x80000000):
        v = torch.from_numpy((base | sign).view(np.float32).copy())
        got = tf32_round(v).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want | sign)


def test_split_tf32_buffer_layout():
    """[hi | lo] in one buffer, as kernel A's weight pass reads them."""
    w = torch.arange(-30, 30, dtype=torch.float32).reshape(3, 20) / 7
    buf = split_tf32(w)
    assert buf.shape == (120,)
    assert torch.equal(buf[:60], tf32_round(w).reshape(-1))
    assert torch.equal(buf[:60] + buf[60:], w.reshape(-1))


# -- (c) kernel A's 3xTF32 arithmetic ------------------------------------------

def _tf32_trunc(v):
    """The TF32 bits of a float32 operand, which the tensor cores read."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _fragments_to_b(frag, plan):
    """Undo pack_weights_tf32's lane order: (hi, lo) B matrices of shape
    (n_split, stages, ksteps*8, nt*8)."""
    ns, st, ks, nt = frag.shape[:4]
    b = frag.new_zeros(2, ns, st, ks * 8, nt * 8)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for kstep in range(ks):
        for n in range(nt):
            for part in range(2):
                for kk in range(2):
                    b[part, :, :, kstep * 8 + t + 4 * kk, n * 8 + g] = \
                        frag[:, :, kstep, n, :, 2 * part + kk]
    return b


def emulate_conv_tf32(x, w, scale, bias, relu, products=3):
    """Kernel A's arithmetic: per stage (input plane kd, chunk of cc input
    channels) the A matrix of (pixel, k = (3*kh + kw) * cc + ci), the B
    fragments of pack_weights_tf32, and per product a_lo*b_hi + a_hi*b_lo +
    a_hi*b_hi with a_hi = tf32(a), a_lo = tf32(a - a_hi) rounded as
    cvt.rna.tf32.f32, and the TF32 bits of b's exact lo; products=1 keeps
    a_hi*b_hi alone. TF32 x TF32 products are exact in float32."""
    b, d, cin, h, wd = x.shape
    cout = w.shape[4]
    plan = conv_plan(b, d, cin, h, wd, cout)
    bm = _fragments_to_b(pack_weights_tf32(w, plan), plan)
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1, 0, 0, 1, 1))
    k = torch.arange(plan.ksteps * 8)
    tap9, ci = k // plan.cc, k % plan.cc
    y = x.new_zeros(b, d, h, wd, plan.n_split * plan.nt * 8)
    for kd in range(3):
        for chunk in range(plan.n_cc):
            cin_i = chunk * plan.cc + ci
            valid = (k < 9 * plan.cc) & (cin_i < cin)
            a = x.new_zeros(b, d, h, wd, len(k))
            for i in valid.nonzero()[:, 0].tolist():
                kh, kw = int(tap9[i]) // 3, int(tap9[i]) % 3
                a[..., i] = xp[:, kd:kd + d, int(cin_i[i]), kh:kh + h,
                               kw:kw + wd]
            a_hi = tf32_round(a)
            a_lo = tf32_round(a - a_hi)
            s = kd * plan.n_cc + chunk
            b_hi = torch.cat(list(bm[0, :, s]), dim=-1)
            b_lo = _tf32_trunc(torch.cat(list(bm[1, :, s]), dim=-1))
            y += a_hi @ b_hi
            if products == 3:
                y += a_lo @ b_hi + a_hi @ b_lo
    y = y[..., :cout].permute(0, 1, 4, 2, 3) * scale.reshape(1, 1, -1, 1, 1) \
        + bias.reshape(1, 1, -1, 1, 1)
    return torch.relu(y) if relu else y


def _close(out, ref, rtol=CONV_RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(ref).max())))


def _conv_data(b, d, cin, h, w, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d, cin, h, w)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    scale = (rng.standard_normal(cout) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, scale, bias


# (b, d, cin, h, w, cout, relu): Cin and Cout of 12 and 48 (K padded per
# stage; three stages per plane at 48; N padded 12 -> 16), 2-3 planes; H a
# multiple of 8, as the Pallas kernel's tilings need
TF32_CASES = [
    (1, 3, 12, 8, 13, 12, True),
    (1, 2, 12, 8, 10, 48, False),
    (1, 2, 48, 8, 9, 12, True),
    (2, 2, 48, 8, 6, 48, False),
]


@pytest.mark.parametrize("b,d,cin,h,w,cout,relu", TF32_CASES)
def test_conv_tf32x3_within_conv_rtol(b, d, cin, h, w, cout, relu):
    x, wt, scale, bias = _conv_data(b, d, cin, h, w, cout, cin + cout + w)
    out = emulate_conv_tf32(_t(x), _t(wt), _t(scale), _t(bias), relu)
    plain = conv3d_brc_cf_plain(_t(x), _t(wt), _t(scale), _t(bias), relu)
    kern = _conv3d_pallas_cf(jnp.asarray(x), jax_pack_weights(jnp.asarray(wt)),
                             jnp.asarray(scale), jnp.asarray(bias), relu,
                             interpret=True)
    _close(out.numpy(), plain.numpy())
    _close(out.numpy(), kern)


def test_conv_tf32x1_misses_conv_rtol():
    """Why three products: one TF32 product per multiply-add is ~1e-4 of
    the output off at Cin 48, ten times CONV_RTOL."""
    x, wt, scale, bias = _conv_data(1, 2, 48, 8, 9, 12, 5)
    args = (_t(x), _t(wt), _t(scale), _t(bias), False)
    plain = conv3d_brc_cf_plain(*args)
    err = float((emulate_conv_tf32(*args, products=1) - plain).abs().max())
    assert err > CONV_RTOL * max(1.0, float(plain.abs().max()))


# -- (d) kernel A's plan -------------------------------------------------------

# ((B, D, Cin, H, W), Cout) of every kernel A call of the committed
# checkpoint's task paths: serving at 1x480x960 (features 160x320, D 64)
# and training at 4x192x384 (64x128), forward and dx
MAIN_PATH_CONVS = [
    ((1, 64, 12, 160, 320), 12), ((1, 64, 12, 160, 320), 1),
    ((1, 64, 4, 160, 320), 4), ((1, 64, 4, 160, 320), 8),
    ((1, 64, 4, 160, 320), 12), ((1, 32, 8, 80, 160), 8),
    ((1, 32, 8, 80, 160), 16), ((1, 32, 8, 80, 160), 24),
    ((1, 16, 16, 40, 80), 16), ((1, 16, 16, 40, 80), 32),
    ((1, 16, 16, 40, 80), 48),
    ((4, 64, 12, 64, 128), 12), ((4, 64, 12, 64, 128), 1),
    ((4, 64, 12, 64, 128), 4), ((4, 64, 4, 64, 128), 4),
    ((4, 64, 4, 64, 128), 8), ((4, 64, 4, 64, 128), 12),
    ((4, 32, 8, 32, 64), 8), ((4, 32, 8, 32, 64), 16),
    ((4, 32, 8, 32, 64), 24), ((4, 16, 16, 16, 32), 16),
    ((4, 16, 16, 16, 32), 32), ((4, 16, 16, 16, 32), 48),
    ((4, 64, 1, 64, 128), 12), ((4, 64, 8, 64, 128), 4),
    ((4, 32, 16, 32, 64), 8), ((4, 32, 24, 32, 64), 8),
    ((4, 16, 32, 16, 32), 16), ((4, 16, 48, 16, 32), 16),
]


@pytest.mark.parametrize("shape,cout", MAIN_PATH_CONVS)
def test_conv_plan_covers_and_fills(shape, cout):
    b, d, cin, h, w = shape
    plan = conv_plan(b, d, cin, h, w, cout)
    assert plan.th * plan.tw == 64 * plan.mt and plan.tw % 16 == 0
    assert plan.n_cc * plan.cc >= cin and plan.cc <= 16
    assert plan.ksteps * 8 >= 9 * plan.cc
    n_x, n_d = plan.n_wt * plan.n_ht, -(-d // plan.db)
    assert plan.blocks == n_x * n_d * b * plan.n_split
    assert (plan.mt, plan.nt, plan.db) in CONV_INSTANCES
    # the kernel's block index is (bx, by, bz) = (tile, run of db planes,
    # b * n_split + ns): tiles cover each (h, w) once, runs each plane
    # once, b once each, splits each channel
    hw = np.zeros((h, w), np.int32)
    fills = []
    for bx in range(n_x):
        _, _, _, rows, cols = conv_block_region(plan, bx, 0, 0)
        r = [i for i in rows if i < h]
        c = [j for j in cols if j < w]
        hw[np.ix_(r, c)] += 1
        fills.append(len(r) * len(c) / (plan.th * plan.tw))
    assert (hw == 1).all()
    planes = np.zeros(d, np.int32)
    for by in range(n_d):
        planes[[i for i in conv_block_region(plan, 0, by, 0)[1] if i < d]] += 1
    assert (planes == 1).all()
    chans = np.zeros(cout, np.int32)
    bs = set()
    for bz in range(b * plan.n_split):
        bb, _, co, _, _ = conv_block_region(plan, 0, 0, bz)
        kept = [i for i in co if i < cout]
        assert kept, "a Cout split with no channel"
        if bb == 0:
            chans[kept] += 1
        bs.add(bb)
    assert (chans == 1).all() and bs == set(range(b))
    if b * d * h * w >= CONV_MIN_VOXELS:
        assert plan.blocks >= CONV_MIN_BLOCKS
    else:
        assert min(fills) >= 0.5
    assert plan.smem <= 227 * 1024
