"""The bf16 staging of the engines of kernels A and D (kernels A, H, B and
D, F): a bf16 slab copies with cp.async in pieces, 8 bytes of four
elements in A's engine and 16 bytes of eight in D's, and is widened in
shared memory (csrc/volume_src.cuh, conv3d.cuh, conv3d_dw.cuh). No CUDA
here: the rules are checked through their Python forms.

(a) The staging rules (ops/cvstem.py::stage_piece with eb = 2 and
    stage_offset): a stage of the cost volume built piece by piece from
    the two feature maps, read back at its column offset (kernel A's
    fragment loads) or widened back by ops/conv3d.py::widen_landed (kernel
    D's pass), equals the volume (the port's cost_volume_cf, held against
    rag_tpu's) at every plane, both halves, every tile and the W halo,
    where rows copy in pieces and where W is not a multiple of a piece (one
    element at a time). Every piece copy is aligned and reads inside its
    source row, and a row of a stage that is one half copies at most one
    piece element by element. Kernel D's widening walk writes every piece
    of a landed plane once.
(b) Shared memory: the bf16 instances' bytes (``smem_for(2)``) at the
    float32 plans of every main-path and small shape fit DW_MAX_SMEM (D, F)
    and the 227 KB a block may take; kernel A's bf16 channel stride keeps
    the four k-columns of a fragment load on separate banks at every
    column offset.
(c) The widening (ops/conv3d.py::widen_bits, the kernels' shift) equals
    ``.float()`` for every finite bf16, and each widened value is its own
    TF32 rounding, so its TF32 split has a zero low part: the product that
    kernel A's bf16 instance drops is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.ops.cost_volume import cost_volume_cf as jax_cost_volume_cf
from rag_tpu_torch.ops.conv3d import (
    DW_MAX_SMEM,
    _chan_stride,
    conv_plan,
    conv_plan_dblock,
    dw_piece,
    dw_plan,
    tf32_round,
    widen_bits,
    widen_landed,
)
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.cvstem import (
    cvstem_dw_plan,
    cvstem_plan,
    stage_offset,
    stage_piece,
)
from test_torch_port_dw import MAIN_PATH_DW, SMALL_DW
from test_torch_port_redesign import MAIN_PATH_CONVS
from test_torch_port_resize_plan import SMALL_CONVS

BLOCK_SMEM = 227 * 1024   # bytes of shared memory a block may take
ENGINES = {"A": 4, "D": dw_piece(2)}   # elements of a bf16 piece


# -- (a) the staging rules ----------------------------------------------------

def _volume(x, y, nd):
    """The (B, D, 2C, H, W) volume of (B, C, H, W) maps: the port's,
    checked equal to rag_tpu's."""
    vol = cost_volume_cf(torch.from_numpy(x).permute(0, 2, 3, 1),
                         torch.from_numpy(y).permute(0, 2, 3, 1), nd).numpy()
    ref = np.asarray(jax_cost_volume_cf(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                        jnp.asarray(y.transpose(0, 2, 3, 1)),
                                        nd))
    np.testing.assert_array_equal(vol, ref)
    return vol


def _stage_bf16(x, y, nd, p, h0, th, w0, tw, c0, n_chan, vec, n):
    """Plane p's bf16 stage (n_chan channels from c0, th + 2 rows from
    h0 - 1, tw + 2n columns from w0 - n + off) as a block lands it in
    pieces of n, from batch 0's maps; checks each copy. Returns the stage,
    its column offset off and, per half, the pieces of a row that copy
    element by element."""
    c, h, w = x.shape[1:]
    off = stage_offset(p, c0, c, vec, eb=2, n=n)
    j_lo = w0 - n + off
    slab = np.full((n_chan, th + 2, tw + 2 * n), np.nan)
    rows = np.arange(h0 - 1, h0 + th + 1)
    row_ok = ((rows >= 0) & (rows < h))[None, :, None]
    narrow = [0, 0]
    for half in (0, 1):
        lo, hi = max(c0, half * c), min(c0 + n_chan, (half + 1) * c)
        if lo >= hi:
            continue
        src = (y if half else x)[0, lo - half * c:hi - half * c]
        src = src[:, np.clip(rows, 0, h - 1)]
        out = slab[lo - c0:hi - c0]
        for q in range(tw // n + 2):
            j0 = j_lo + n * q
            # a plane outside the volume: the policy's empty row
            pieces = (stage_piece(half, p, j0, w, vec, eb=2, n=n)
                      if 0 <= p < nd else [(2 * n, j0, None)] if vec
                      else [(2, j, None) for j in range(j0, j0 + n)])
            narrow[half] += pieces[0][0] == 2
            for width, j, s in pieces:
                k = width // 2
                col = j - j_lo
                if s is None:
                    out[:, :, col:col + k] = 0
                    continue
                assert 0 <= s and s + k <= w, "a copy reads outside its row"
                if width == 2 * n:
                    assert vec and s % n == 0, "an unaligned piece copy"
                out[:, :, col:col + k] = np.where(row_ok, src[:, :, s:s + k],
                                                  0)
    return slab, off, narrow


def _ref_slab(vol, p, h0, th, w0, tw, c0, n_chan):
    """The float32 layout's slab (tw + 8 columns from w0 - 4) cut from the
    volume, zero outside it."""
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


# (c, h, w, nd, th, tw, chunks): B's plan's 4 x 32 and F's 8 x 16 tiles
# at the train width (20 of its 64 planes: the diagonal crosses the first
# tiles); D past W with a ragged last tile (the W halo past the volume);
# W % 8 == 4 (pieces of four only) and W % 4 == 2 (none); W a multiple of
# the tile (the halo right of W); a 64-wide tile; C = 3 with both halves
# in one chunk
STAGE_CASES = [
    (12, 6, 128, 20, 4, 32, 2), (12, 6, 128, 20, 8, 16, 2),
    (12, 5, 40, 44, 4, 32, 2), (12, 5, 36, 24, 4, 16, 2),
    (12, 5, 22, 24, 4, 16, 2), (12, 4, 64, 40, 2, 32, 2),
    (12, 4, 96, 70, 2, 64, 2), (3, 4, 40, 9, 4, 32, 1),
]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("c,h,w,nd,th,tw,chunks", STAGE_CASES)
def test_bf16_stage_reads_back_the_volume(engine, c, h, w, nd, th, tw,
                                          chunks):
    n = ENGINES[engine]
    rng = np.random.default_rng(w + nd + c)
    # integers: exact in bf16, and X's positive against Y's negative
    x = rng.integers(1, 8, (1, c, h, w)).astype(np.float32)
    y = rng.integers(-8, -1, (1, c, h, w)).astype(np.float32)
    vol = _volume(x, y, nd)
    vec = w % n == 0
    ci = 2 * c // chunks
    offsets = set()
    for w0 in range(0, w, tw):
        for h0 in sorted({0, max(0, h - th)}):
            for p in range(-1, nd + 1):
                for c0 in range(0, 2 * c, ci):
                    got, off, narrow = _stage_bf16(x, y, nd, p, h0, th, w0,
                                                   tw, c0, ci, vec, n)
                    want = _ref_slab(vol, p, h0, th, w0, tw, c0, ci)
                    assert off == (p % n if vec and c0 >= c else 0)
                    offsets.add(off)
                    if engine == "A":
                        # the fragment loads read the columns the tile and
                        # its halo need, 3 .. tw + 4 of the float32 layout,
                        # off further on
                        np.testing.assert_array_equal(
                            got[:, :, 3 - off:tw + 5 - off],
                            want[:, :, 3:tw + 5])
                    else:
                        # the pass widens the landed stage into the float32
                        # layout: float column c is landed column
                        # c + 4 - off (columns before the landed row, never
                        # read, zero)
                        wide = widen_landed(torch.from_numpy(got).to(
                            torch.bfloat16), 4 - off, tw + 8).numpy()
                        np.testing.assert_array_equal(wide[:, :, 3:],
                                                      want[:, :, 3:])
                        assert not wide[:, :, :max(0, off - 4)].any()
                    if vec and 0 <= p < nd and ci == c:
                        # one half: X's rows copy at most the diagonal's
                        # piece element by element, Y's at most the piece
                        # at W, and none at p % n == 0
                        assert narrow[0] <= 1 and narrow[1] <= 1
                        if p % n == 0:
                            assert narrow[1] == 0
                    if not vec:
                        assert narrow[0] + narrow[1] == (tw // n + 2) * (
                            (c0 < c) + (c0 + ci > c))
    if vec and chunks == 2 and nd > n:
        assert offsets == set(range(n))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("p", range(10))
@pytest.mark.parametrize("half", (0, 1))
def test_bf16_diagonal_piece_at_every_column_offset(engine, p, half):
    """Every piece of a row of plane p at W = 16 (a stage all of one half):
    X's piece that holds the diagonal, wherever it falls in the piece, and
    Y's piece at W copy element by element with zeros left of p and from
    W; every other piece copies whole or is a zero fill."""
    n, w = ENGINES[engine], 16
    off = stage_offset(p, 12 * half, 12, True, eb=2, n=n)
    src = np.arange(1, w + 1)
    row = np.zeros(w + 3 * n)     # volume columns -n .. w + 2n - 1
    for q in range(w // n + 2):
        j0 = -n + off + n * q
        pieces = stage_piece(half, p, j0, w, True, eb=2, n=n)
        straddles = any(j0 < e < j0 + n for e in (p, w))
        assert (len(pieces) == n) == straddles
        for width, j, s in pieces:
            for e in range(width // 2):
                row[j + e + n] = 0 if s is None else src[s + e]
    want = np.zeros(w + 3 * n)
    for j in range(p, w):
        want[j + n] = src[j - (p if half else 0)]
    # the columns a 16-wide tile at 0 reads: -1 .. 16
    np.testing.assert_array_equal(row[n - 1:w + n + 1],
                                  want[n - 1:w + n + 1])


def _magic_div(num, d):
    """csrc/conv3d_dw.cuh::magic_div with div_magic(d)."""
    return (num * (((1 << 32) + d - 1) // d)) >> 32


@pytest.mark.parametrize("shape,cout", MAIN_PATH_DW + SMALL_DW)
def test_dw_widen_walk_writes_every_piece_once(shape, cout):
    """Kernel D's widening walk (csrc/conv3d_dw.cuh::widen_walk and
    widen_rows) over a landed x plane and dz plane of a plan: its magic
    divisions equal integer division, and the block's threads write every
    (row, piece) once."""
    plan = dw_plan(*shape, cout)
    for ppr, rpc, n_rows in (((plan.tw + 8) // 4, plan.th + 2,
                              plan.ci * (plan.th + 2)),
                             (plan.tw // 4, plan.th, plan.co_t * plan.th)):
        wide = plan.threads >= ppr
        rstep, qstep = (plan.threads // ppr, ppr) if wide else (
            1, plan.threads)
        seen = np.zeros((n_rows, ppr), int)
        for t in range(plan.threads):
            row0 = _magic_div(t, ppr) if wide else 0
            assert row0 == (t // ppr if wide else 0)
            if row0 >= rstep:
                continue
            for q in range(t - row0 * ppr, ppr, qstep):
                for row in range(row0, n_rows, rstep):
                    assert _magic_div(row, rpc) == row // rpc
                    seen[row, q] += 1
        assert (seen == 1).all()


# -- (b) shared memory --------------------------------------------------------

@pytest.mark.parametrize("shape,cout", MAIN_PATH_DW + SMALL_DW)
def test_dw_bf16_smem_fits(shape, cout):
    plan = dw_plan(*shape, cout)
    assert plan.smem_for(4) == plan.smem
    assert plan.smem_for(2) <= DW_MAX_SMEM and plan.smem_for(2) <= BLOCK_SMEM


# (b, c, h, w, nd, cout): the train and eval geometries, then chip_smoke.py's
# small shapes of kernels B and F
STEM_SHAPES = [(4, 12, 64, 128, 64, 12), (1, 12, 160, 320, 64, 12),
               (1, 12, 8, 20, 6, 12), (1, 2, 8, 8, 8, 3), (2, 3, 6, 11, 5, 4),
               (1, 2, 5, 6, 9, 3), (1, 3, 8, 13, 13, 12),
               (2, 12, 9, 130, 11, 12), (1, 12, 7, 21, 24, 12),
               (2, 12, 10, 68, 72, 12)]


@pytest.mark.parametrize("b,c,h,w,nd,cout", STEM_SHAPES)
def test_stem_bf16_smem_fits(b, c, h, w, nd, cout):
    f = cvstem_dw_plan(b, nd, c, h, w, cout)
    assert f.smem_for(2) <= DW_MAX_SMEM and f.smem_for(4) == f.smem
    bp = cvstem_plan(b, nd, c, h, w, cout)
    assert bp.smem_for(2) < bp.smem_for(4) == bp.smem <= BLOCK_SMEM


@pytest.mark.parametrize("shape,cout", MAIN_PATH_CONVS + SMALL_CONVS)
def test_conv_bf16_smem_halves(shape, cout):
    for plan in (conv_plan(*shape, cout), conv_plan_dblock(*shape, cout)):
        assert plan.smem_for(4) == plan.smem <= BLOCK_SMEM
        # two staging buffers of 2-byte elements and the k table
        cs = _chan_stride(plan.th, plan.tw, 2)
        assert plan.smem_for(2) == 2 * 2 * plan.cc * cs + 32 * plan.ksteps
        assert plan.smem_for(2) < plan.smem


@pytest.mark.parametrize("th,tw", [(4, 32), (2, 64), (8, 16), (16, 16),
                                   (4, 64), (4, 16)])
def test_conv_bf16_fragment_loads_on_separate_banks(th, tw):
    """Kernel A's fragment load at k-step ks: lane (g, t) reads the bf16 at
    s_off[8 ks + t] + pix + g (and + 8) less the stage's column offset. For
    the four t of a k-step within one tap (consecutive channels), the
    words the four groups of eight lanes read lie on separate banks at
    every column offset, every m-tile and every tap."""
    cc, sw = 12, tw + 8
    cs = _chan_stride(th, tw, 2)
    assert cs % 64 == 16 and cs >= (th + 2) * sw and cs % 4 == 0
    s_off = [ci * cs + (tap // 3) * sw + tap % 3 + 3
             for tap in range(9) for ci in range(cc)]
    per_row = tw // 16
    for off in range(4):
        for i in range(th * tw // 16):               # m-tiles of the tile
            pix = (i // per_row) * sw + (i % per_row) * 16
            for k0 in range(0, 9 * cc - 3):
                if k0 // cc != (k0 + 3) // cc:
                    continue
                banks = {}
                for t in range(4):
                    for g in range(8):
                        word = (s_off[k0 + t] + pix + g - off) // 2
                        banks.setdefault(word % 32, set()).add(word)
                assert all(len(words) == 1 for words in banks.values())


# -- (c) the widening ---------------------------------------------------------

def test_widen_bits_is_exact_and_its_own_tf32():
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    h = bits.view(torch.bfloat16)
    ref = h.float()
    finite = torch.isfinite(ref)
    assert int(finite.sum()) == 65536 - 2 * 128   # NaNs and infinities
    wide = widen_bits(h)[finite]
    assert torch.equal(wide.view(torch.int32), ref[finite].view(torch.int32))
    hi = tf32_round(wide)
    assert torch.equal(hi.view(torch.int32), wide.view(torch.int32))
    assert not (wide - hi).any()
