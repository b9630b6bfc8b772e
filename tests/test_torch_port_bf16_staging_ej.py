"""The bf16 instances of kernels E (csrc/cvstem_dxy.cu) and J (csrc/shear.cu)
as redesigned for the H100: bf16 rows copy with cp.async in pieces and
are widened as they are read, at the float32 instances' plans. No CUDA
here: the rules are checked through their Python forms.

(a) E's staging (ops/cvstem.py::dxy_piece_for, dxy_stage_base,
    dxy_row_pieces): a bf16 slot built piece by piece, read back at its
    offset and widened, equals the float32 instance's staged window of dz
    at every plane q, both halves, every tile and the H edges, with
    16-byte pieces of eight, 8-byte pieces of four and, where W is not a
    multiple of four, element by element. Every piece copy is aligned and
    reads inside its source row; a row that copies in pieces copies no
    piece element by element; no staged column is read that was not
    written.
(b) E's walk (tests/test_torch_port_redesign.py::emulate_dxy) over that
    staging equals rag_tpu's cvstem_dxy_pallas in interpret mode bit for
    bit on integer-valued bf16 dz, at the float32 plan and at other
    chunks; rounded to bf16 it is the port's plain version.
(c) Shared memory: ``DxyPlan.smem_for(2)`` and J's bf16 layout
    (ops/shear.py::fwd_smem_bytes) fit the 227 KB a block may take at
    every main-path and small shape, below the float32 instances' bytes.
(d) J's bf16 groups: its pieces and groups of four (``j_groups`` of
    tests/test_torch_port_shear_redesign.py at G = 4) write every group
    exactly once and read only what their piece staged in 8-byte pieces
    of four; its form (the float32 sums on the widened maps, each group
    rounded and packed as one 8-byte store) equals rag_tpu's shear_forward
    in interpret mode bit for bit on integer-valued bf16 maps, at W % 4 ==
    0 (G = 4) and at odd W (G = 1), ReLU on and off.
(e) Plans: the bf16 plans of E and J are the float32 plans at those
    shapes (J's but for its shared bytes and copy width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.ops import pallas_shear as jshear
from rag_tpu.ops.pallas_cvstem import cvstem_dxy_pallas
from rag_tpu_torch.ops.conv3d import widen_bits
from rag_tpu_torch.ops.cvstem import (
    DXY_HALO,
    DXY_PITCH,
    DXY_PITCH_BF16,
    DXY_RING,
    DXY_TH,
    DXY_TW,
    cvstem_dxy_plain,
    dxy_piece_for,
    dxy_plan,
    dxy_row_pieces,
    dxy_stage_base,
    dxy_window,
)
from rag_tpu_torch.ops.shear import (
    FWD_MAX_THREADS,
    FWD_PLANES,
    FWD_TILE_COLS,
    FWD_TILE_PLANES,
    fwd_plan,
    fwd_smem_bytes,
    shear_forward_plain,
)
from test_torch_port_bf16_staging import BLOCK_SMEM, STEM_SHAPES
from test_torch_port_redesign import _dxy_plan_with_chunk, _stage, emulate_dxy
from test_torch_port_shear_redesign import (
    ALL,
    CU,
    J_PIECE_CASES,
    K_T,
    class_bits,
    emulate_j,
    j_groups,
)
from test_torch_port_shear_redesign import fwd_plan as mirror_fwd_plan

SM_SMEM = 233472   # bytes of shared memory an SM holds (228 KB)
BLOCK_RESERVED = 1024   # bytes the card reserves a resident block
WINDOW = DXY_TW + 2 * DXY_HALO   # columns of a staged window


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jnp(t: torch.Tensor):
    """A torch bf16 (or float32) tensor as a jax array of the same dtype."""
    dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy(), dtype=dt)


# -- (a) kernel E's bf16 staging ----------------------------------------------

def stage_bf16(dz_q, h0, half, w0, q, n, copies=None):
    """Plane q's window (B, Cout, TH + 2, TW + 4) as E's bf16 instance
    stages it in pieces of n (0: element by element) from bf16 dz_q (B,
    Cout, H, W) and reads it: a slot of DXY_PITCH_BF16 columns, unwritten
    columns NaN, read off columns on and widened. ``copies`` collects
    (h_ok, pieces) per staged row."""
    b, cout, h, w = dz_q.shape
    base, off = dxy_stage_base(half, w0, q, n)
    slot = torch.full((b, cout, DXY_TH + 2, DXY_PITCH_BF16), float("nan"),
                      dtype=torch.bfloat16)
    for r in range(DXY_TH + 2):
        hh = h0 - 1 + r
        h_ok = 0 <= hh < h
        pieces = dxy_row_pieces(base, w, n, h_ok)
        if copies is not None:
            copies.append((base, h_ok, pieces))
        for piece in pieces:
            for nbytes, col, src in piece:
                k = nbytes // 2
                slot[..., r, col:col + k] = (
                    0.0 if src is None else dz_q[..., hh, src:src + k])
    return widen_bits(slot[..., off:off + WINDOW])


def check_copies(copies, w, n):
    """Every piece copy aligned (slot column and source column multiples
    of n, the slot row a multiple of 16 bytes) and inside its source row;
    the pieces tile the slot row from column 0 within its pitch; a row in
    pieces copies none element by element."""
    assert DXY_PITCH_BF16 * 2 % 16 == 0
    size = n or 8
    for base, h_ok, pieces in copies:
        assert base % size == 0
        cols = [c for piece in pieces for _, c, _ in piece]
        assert cols == sorted(cols) and cols[0] == 0
        end = max(c + nb // 2 for piece in pieces for nb, c, _ in piece)
        assert end <= DXY_PITCH_BF16
        for piece in pieces:
            whole = len(piece) == 1 and piece[0][0] == 2 * size
            if n:
                assert whole, "a row in pieces copied element by element"
                nb, col, src = piece[0]
                assert col % n == 0
                if src is not None:
                    assert h_ok and src % n == 0 and 0 <= src <= w - n
            else:
                assert all(nb == 2 for nb, _, _ in piece)
                for _, _, src in piece:
                    assert src is None or (h_ok and 0 <= src < w)


# (b, cout, h, nd, w, address mod 16, elements of a piece): 16-byte pieces
# (two W tiles, an H edge), 8-byte pieces (W % 8 == 4; an 8-byte aligned
# dz), element by element (odd W, W % 4 == 2), and a short W
STAGE_CASES = [(1, 2, 13, 9, 128, 0, 8), (1, 2, 9, 7, 100, 0, 4),
               (1, 2, 10, 6, 64, 8, 4), (1, 2, 7, 5, 75, 0, 0),
               (2, 2, 8, 11, 72, 0, 8), (1, 3, 5, 4, 13, 0, 0),
               (1, 2, 6, 5, 70, 0, 0)]


@pytest.mark.parametrize("b,cout,h,nd,w,addr,n", STAGE_CASES)
def test_e_bf16_stage_rebuilds_the_window(b, cout, h, nd, w, addr, n):
    assert dxy_piece_for(w, addr, 2) == n
    assert dxy_piece_for(w, addr, 4) == 1
    rng = np.random.default_rng(w + nd)
    dz = _bf16(rng.standard_normal((b, nd, cout, h, w)))
    plan = dxy_plan(b, nd, cout, 1, h, w)
    copies = []
    for q in range(nd):
        for half in (0, 1):
            for wt in range(plan.n_wt):
                w0 = wt * DXY_TW
                base, off = dxy_stage_base(half, w0, q, n)
                assert base + off == dxy_window(half, w0, q)
                assert 0 <= off < (n or 8)
                for ht in range(plan.n_ht):
                    got = stage_bf16(dz[:, q], ht * DXY_TH, half, w0, q, n,
                                     copies)
                    want = _stage(dz[:, q].float(), ht * DXY_TH,
                                  dxy_window(half, w0, q))
                    assert torch.equal(got, want), (q, half, wt, ht)
    check_copies(copies, w, n)


# -- (b) kernel E's walk over the bf16 staging --------------------------------

# (b, c, h, w, nd, cout, chunk or None for the plan's, address mod 16):
# 16-byte pieces, 8-byte pieces at chunks of 4, the element path, two W
# tiles at chunks of 2, 8-byte pieces of an 8-byte aligned dz at chunks
# of 16 (one chunk)
WALK_CASES = [(1, 3, 6, 16, 9, 4, None, 0), (2, 2, 9, 20, 13, 3, 4, 0),
              (1, 2, 5, 13, 9, 3, None, 0), (1, 3, 10, 72, 7, 5, 2, 0),
              (1, 2, 8, 24, 11, 3, 16, 8)]


@pytest.mark.parametrize("b,c,h,w,nd,cout,chunk,addr", WALK_CASES)
def test_e_bf16_walk_exact_on_integers(b, c, h, w, nd, cout, chunk, addr):
    rng = np.random.default_rng(b * 7 + w + nd)
    dz = _bf16(rng.integers(-3, 4, (b, nd, cout, h, w)))
    w3 = torch.from_numpy(rng.integers(-2, 3, (3, 3, 3, 2 * c, cout))
                          .astype(np.float32))
    plan = _dxy_plan_with_chunk(b, nd, cout, c, h, w, chunk)
    n = dxy_piece_for(w, addr, 2)

    def stage(dz_q, h0, half, w0, q):
        return stage_bf16(dz_q.to(torch.bfloat16), h0, half, w0, q, n)

    dx, dy = emulate_dxy(dz.float(), w3, plan, stage=stage)
    kx, ky = cvstem_dxy_pallas(_jnp(dz), jnp.asarray(w3.numpy()), nd,
                               interpret=True)
    px, py = cvstem_dxy_plain(dz, w3, nd)
    for out, kern, plain in ((dx, kx, px), (dy, ky, py)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(kern))
        assert plain.dtype == torch.bfloat16
        assert torch.equal(out.to(torch.bfloat16), plain)


# -- (c) shared memory --------------------------------------------------------

@pytest.mark.parametrize("b,c,h,w,nd,cout", STEM_SHAPES)
def test_e_bf16_smem_fits(b, c, h, w, nd, cout):
    plan = dxy_plan(b, nd, cout, c, h, w)
    slots = DXY_RING * plan.kc * (DXY_TH + 2)
    assert plan.smem_for(4) == plan.smem == \
        4 * (27 * plan.kc * plan.ct + slots * DXY_PITCH)
    assert plan.smem_for(2) == 4 * 27 * plan.kc * plan.ct \
        + 2 * slots * DXY_PITCH_BF16
    assert plan.smem_for(2) < plan.smem_for(4) <= BLOCK_SMEM
    if (b, c, h, w, nd, cout) == (4, 12, 64, 128, 64, 12):
        # the train shape: three bf16 blocks an SM where two float32 ones fit
        assert 3 * (plan.smem_for(2) + BLOCK_RESERVED) <= SM_SMEM
        assert 3 * (plan.smem_for(4) + BLOCK_RESERVED) > SM_SMEM


# (b, nd, co, h, w): J at the eval geometry (a request) and the train
# shape (a step), then rows of chip_smoke.py's exact cases
J_SHAPES = [(1, 64, 12, 160, 320), (4, 64, 12, 64, 128), (2, 2, 3, 5, 13),
            (1, 9, 4, 6, 21), (1, 7, 4, 5, 24), (1, 1, 3, 4, 12),
            (1, 40, 2, 2, 520), (1, 70, 1, 2, 2100), (1, 5, 1, 1, 3001),
            (1, 3, 1, 1, 60001)]


@pytest.mark.parametrize("b,nd,co,h,w", J_SHAPES)
def test_j_bf16_smem_fits(b, nd, co, h, w):
    p4, p2 = fwd_plan(b, nd, co, h, w, 4), fwd_plan(b, nd, co, h, w, 2)
    assert p4.smem == fwd_smem_bytes(w, p4.cols, p4.planes, 4)
    assert p2.smem == fwd_smem_bytes(w, p2.cols, p2.planes, 2)
    assert p2.smem < p4.smem <= BLOCK_SMEM


# -- (d) kernel J's bf16 groups -----------------------------------------------

def store_group_bf16(y: np.ndarray) -> np.ndarray:
    """store_group<4, bf16>: four float32 values rounded to bf16 and
    packed as one 8-byte store, make_uint2(b0 | b1 << 16, b2 | b3 << 16),
    read back as the four bf16 it writes (little-endian)."""
    bits = (torch.from_numpy(y).to(torch.bfloat16).view(torch.int16)
            .numpy().astype(np.uint32) & 0xFFFF)
    words = np.stack([bits[..., 0] | bits[..., 1] << 16,
                      bits[..., 2] | bits[..., 3] << 16], -1)
    return words.astype("<u4").view("<u2")


@pytest.mark.parametrize("nd,w,tiling",
                         [c for c in J_PIECE_CASES if c[1] % 4 == 0])
def test_j_bf16_groups_of_four_read_what_they_staged(nd, w, tiling):
    """At W % 4 == 0 the bf16 instance takes G = 4: every group of four is
    written once, each output reads inside its piece's staged columns,
    and the staging copies 8-byte pieces of four, aligned, into rows whose
    byte offsets keep them aligned."""
    kx, ky = class_bits(nd, w)
    tw, dp = mirror_fwd_plan(nd, w, True, *(tiling or ()))
    if tiling is None:
        p = fwd_plan(1, nd, 1, 1, w, 2)
        assert (p.vec, p.cols, p.planes, p.copy_bytes) == (1, tw, dp, 8)
    wx = (tw + 3) & ~3
    wy = min((w + 3) & ~3, (tw + dp + 9 + 3) & ~3)
    assert (9 * wx * 2) % 8 == 0 and (wx * 2) % 8 == 0 and (wy * 2) % 8 == 0
    assert (9 * (wx + wy) * 2) % 4 == 0          # P and R float32 after them
    seen = j_groups(nd, w, 4, tw, dp)
    assert sorted((d, q) for _, d, q, _ in seen) == [
        (d, q) for d in range(nd) for q in range(w // 4)]
    for phase, d, q, (j0, j1, d0, d1, y0, y1, r0, r1) in seen:
        # the staged pieces of four: px over [j0, j1), py over [y0, y1)
        assert j0 % 4 == 0 and (j1 - j0) % 4 == 0
        assert y0 % 4 == 0 and (y1 - y0) % 4 == 0
        assert j0 <= 4 * q and 4 * q + 4 <= j1 and d0 <= d < d1
        for j in range(4 * q, 4 * q + 4):
            u = j - d
            if int(ky[d, j]) == ALL:
                assert r0 <= u <= r1
            elif int(kx[d, j]):
                for t, k in enumerate(K_T):
                    if int(ky[d, j]) >> t & 1:
                        assert y0 <= u - k < y1, (d, j, t)


def emulate_j_bf16(px, py, scale, bias, nd, relu):
    """Kernel J's bf16 instance for one batch of rows: the float32
    instance's sums on the widened maps (emulate_j), stored group by group
    as shear_fwd_kernel<G, bf16> enumerates them (``j_groups`` at its
    plan), G = 4 packed as one 8-byte store. Each output written once."""
    b, _, co, h, w = px.shape
    z = emulate_j(widen_bits(px), widen_bits(py), scale, bias, nd,
                  relu).numpy()
    p = fwd_plan(b, nd, co, h, w, 2)
    g = 4 if p.vec else 1
    assert (p.copy_bytes, p.vec) == ((8, 1) if g == 4 else (2, 0))
    out = np.zeros(z.shape, np.uint16)
    writes = np.zeros((nd, w), np.int64)
    for _, d, q, _ in j_groups(nd, w, g, p.cols, p.planes):
        cols = slice(g * q, g * q + g)
        y = z[:, d, :, :, cols]
        out[:, d, :, :, cols] = (
            store_group_bf16(y) if g == 4 else
            torch.from_numpy(y).to(torch.bfloat16).view(torch.int16).numpy())
        writes[d, cols] += 1
    assert (writes == 1).all()
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


# (b, c, h, w, co, nd, relu): W % 4 == 0 (an interior, D > W), odd W, and
# D = 2 at W = 3
J_INT_CASES = [(1, 3, 5, 24, 6, 7, False), (2, 2, 4, 16, 3, 20, True),
               (1, 2, 6, 13, 4, 9, True), (1, 2, 4, 3, 3, 2, False)]


@pytest.mark.parametrize("b,c,h,w,co,nd,relu", J_INT_CASES)
def test_j_bf16_form_exact_on_integers(b, c, h, w, co, nd, relu):
    rng = np.random.default_rng(w * 3 + nd)
    px = _bf16(rng.integers(-3, 4, (b, 9, co, h, w)))
    py = _bf16(rng.integers(-3, 4, (b, 9, co, h, w)))
    scale = torch.arange(1, co + 1, dtype=torch.float32)
    bias = torch.full((co,), -3.0)
    got = emulate_j_bf16(px, py, scale, bias, nd, relu)
    ref = jax.jit(lambda *a: jshear.shear_forward(
        *a, nd, w, relu=relu, interpret=True))(
            _jnp(px), _jnp(py), scale.numpy(), bias.numpy())
    assert ref.dtype == jnp.bfloat16
    assert torch.equal(got, torch.from_numpy(
        np.array(ref.astype(jnp.float32))).to(torch.bfloat16))
    assert torch.equal(got, shear_forward_plain(px, py, scale, bias, nd,
                                                relu))


# -- (e) plans ----------------------------------------------------------------

@pytest.mark.parametrize("b,c,h,w,nd,cout", STEM_SHAPES)
def test_e_bf16_plan_is_the_float32_plan(b, c, h, w, nd, cout):
    """E's plan takes shapes only: the bf16 instance launches it as it is,
    ct, n_cc, chunk, n_chunks and kc, with its own shared bytes; its
    pieces depend on W and dz's address alone."""
    plan = dxy_plan(b, nd, cout, c, h, w)
    assert plan.smem == plan.smem_for(4)
    assert plan.chunk * plan.n_chunks >= nd and plan.n_cc * plan.ct >= c
    want = 8 if w % 8 == 0 else 4 if w % 4 == 0 else 0
    assert dxy_piece_for(w, 0, 2) == want
    assert dxy_piece_for(w, 8, 2) == (4 if w % 4 == 0 else 0)
    assert dxy_piece_for(w, 2, 2) == 0


@pytest.mark.parametrize("b,nd,co,h,w", J_SHAPES)
def test_j_bf16_plan_is_the_float32_plan(b, nd, co, h, w):
    """J's plan in Python (ops/shear.py::fwd_plan, csrc/shear.cu's
    constants) is the same launch for both dtypes but for the shared bytes
    and the copy width, and its tiling is the shear tests' mirror's."""
    assert (FWD_MAX_THREADS, FWD_PLANES, FWD_TILE_COLS, FWD_TILE_PLANES) == (
        CU["kFwdMaxThreads"], CU["kFwdPlanes"], CU["kFwdTileCols"],
        CU["kFwdTilePlanes"])
    p4, p2 = fwd_plan(b, nd, co, h, w, 4), fwd_plan(b, nd, co, h, w, 2)
    assert p2._replace(smem=0, copy_bytes=0) == p4._replace(smem=0,
                                                            copy_bytes=0)
    assert (p4.copy_bytes, p2.copy_bytes) == ((16, 8) if w % 4 == 0
                                              else (4, 2))
    assert (p4.cols, p4.planes) == mirror_fwd_plan(nd, w, w % 4 == 0)
    assert p4.blocks == b * co * h and p4.threads <= FWD_MAX_THREADS
    # unaligned maps take the element path in both
    assert fwd_plan(b, nd, co, h, w, 2, aligned=False).vec == 0
