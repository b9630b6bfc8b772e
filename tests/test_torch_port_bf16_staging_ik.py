"""The bf16 instances of kernels I (csrc/resize_taps.cu) and K (csrc/
shear.cu) as redesigned for the H100: bf16 rows copy with cp.async in
pieces and are widened as they are read, at the float32 instances' plans.
No CUDA here: the rules are checked through their Python forms.

(a) I's staging (ops/resize.py::resize_piece, resize_stage,
    ResizePlan.pitch_for / smem_for): at every kernel I call of a request
    and a task-0 step, forward and adjoint, and at chip_smoke.py's small
    shapes, every W tile's staged span in pieces of eight, four or one
    element covers the tile's columns, starts at a piece boundary, ends
    within W and fits the row pitch, whose rows stay aligned to a piece;
    a main-path span that starts four columns into its piece exists (the
    offset read is exercised); the bf16 ring fits in the float32 one's
    bytes.
(b) I's form: kernel I's blocks and order of sums
    (tests/test_torch_port_resize_plan.py::emulate_resize) reading each
    plane from a slab built piece by piece (unstaged columns NaN) at its
    offset equal the float32 instance's on the upcast input bit for bit;
    rounded to bf16 they equal the port's bf16 plain version on
    integer-valued input with dyadic weights.
(c) K's staging (ops/shear.py::adj_piece, adj_plan, adj_window): at the
    task-0 training shape, chip_smoke.py's small and exact shapes and at
    small caps (column and diagonal blocks, several runs), every column
    and diagonal has one walker, every step of a walk lies in one run and
    reads inside its block's staged columns, every piece is aligned to its
    size in the source and in the slab, and the slab fits its cap; the
    bf16 plan's walkers are the float32 plan's, and so are its runs but
    where a diagonal block's pitch widens for pieces of eight.
(d) K's form: the walkers over the slabs staged in pieces, widened as
    read, running sums from d = 0 and d = 1 written where each output's
    range ends, equal shear_adjoint_plain on the upcast dz bit for bit on
    integer-valued bf16 dz, and the sequential ascending-d sum
    (tests/test_torch_port_shear_redesign.py::sequential_k) on random bf16
    dz, each output written once.
"""

import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu_torch.ops.resize import (
    RESIZE_MAX_SMEM,
    resize_piece,
    resize_plan,
    resize_stage,
    resize_tables,
    resize_taps_plain,
)
from rag_tpu_torch.ops.shear import (
    ADJ_MAX_THREADS,
    ADJ_SLAB,
    T9,
    adj_piece,
    adj_plan,
    adj_window,
    shear_adjoint_plain,
)
from test_torch_port_bf16_staging import BLOCK_SMEM
from test_torch_port_resize_plan import (
    DYADIC,
    MAIN_PATH_RESIZES,
    SMALL,
    emulate_resize,
    unpack_tables,
)
from test_torch_port_shear_redesign import CU, sequential_k
from test_torch_port_shear_redesign import adj_plan as mirror_adj_plan

K_T = tuple(dd - dw for dd, dw in T9)


def _pieces(w: int):
    """The pieces kernel I's or K's bf16 instance can take at W: eight
    (16 bytes) where W % 8 == 0, four (8 bytes) where W % 4 == 0, one."""
    return [n for n in (8, 4, 1) if w % n == 0]


# -- (a) kernel I's staging ----------------------------------------------------

# chip_smoke.py's bf16-only resize case: a 2x upsample of W = 40 whose W
# tiles' spans start four columns into their 16-byte pieces
OFFSET_CASE = ((1, 8, 3, 20, 40), (16, 40, 80), False)


def _tiles(shape, target, transposed):
    b, d, c, h, w = shape
    plan = resize_plan(b, d, c, h, w, *target, True, transposed)
    tab = unpack_tables(plan, *resize_tables(plan, d, h, w, *target, True,
                                             transposed), *target)
    return plan, list(zip(tab["wt_lo"].tolist(), tab["wt_n"].tolist()))


@pytest.mark.parametrize("shape,target,transposed",
                         MAIN_PATH_RESIZES + SMALL + [OFFSET_CASE])
def test_i_bf16_spans_cover_in_pieces(shape, target, transposed):
    w = shape[4]
    plan, tiles = _tiles(shape, target, transposed)
    for piece in _pieces(w):
        pitch = plan.pitch_for(piece)
        assert pitch % max(piece, 4) == 0     # rows aligned to a piece
        assert plan.smem_for(2, piece) <= plan.smem <= RESIZE_MAX_SMEM
        assert plan.smem_for(2, piece) <= BLOCK_SMEM
        for lo, n_col in tiles:
            base, off, width = resize_stage(lo, n_col, piece)
            assert base % piece == 0 and width % piece == 0
            assert base + off == lo and off + n_col <= width <= pitch
            assert base + width <= w
    # the float32 instance's staging is the plan's span as it is
    for lo, n_col in tiles:
        p4 = resize_piece(w, 0, 4)
        assert resize_stage(lo, n_col, p4) == (lo, 0, n_col)


def test_i_bf16_offset_span_on_the_main_path():
    """wt_lo is a multiple of four only: some main-path tiles start four
    columns into a 16-byte piece of eight bf16, and so does the small
    case chip_smoke.py adds for it."""
    offs = [resize_stage(lo, n, 8)[1]
            for shape, target, tr in MAIN_PATH_RESIZES + [OFFSET_CASE]
            for lo, n in _tiles(shape, target, tr)[1]]
    assert set(offs) == {0, 4}
    assert 4 in [resize_stage(lo, n, 8)[1]
                 for lo, n in _tiles(*OFFSET_CASE)[1]]


def test_i_piece_rule():
    """resize_piece (csrc/resize_taps.cu::piece_of): the widest piece W and
    the address allow, per element size."""
    assert [resize_piece(w, a, 4) for w, a in
            [(320, 0), (320, 8), (322, 0), (12, 16)]] == [4, 1, 1, 4]
    assert [resize_piece(w, a, 2) for w, a in
            [(320, 0), (320, 8), (12, 0), (12, 8), (12, 4), (10, 0),
             (13, 0)]] == [8, 4, 4, 4, 1, 1, 1]


# -- (b) kernel I's form -------------------------------------------------------

def stage_bf16(piece, plan):
    """emulate_resize's ``stage`` for the bf16 instance: the plane's rows
    copied piece by piece into a slab of pitch_for(piece) columns (NaN
    where nothing was copied), read ``off`` columns on."""
    pitch = plan.pitch_for(piece)

    def stage(x, bb, plane, c, src_rows, lo, n_col):
        base, off, width = resize_stage(lo, n_col, piece)
        slab = np.full((len(src_rows), pitch), np.nan, x.dtype)
        for q in range(base, base + width, piece):
            assert q % piece == 0 and q + piece <= x.shape[-1]
            slab[:, q - base:q - base + piece] = \
                x[bb, plane, c][src_rows][:, q:q + piece]
        staged = slab[:, off:off + n_col]
        assert not np.isnan(staged).any()
        return staged
    return stage


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, as float32 (the widened values)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
        .float().numpy()


@pytest.mark.parametrize("shape,target,transposed",
                         SMALL + [OFFSET_CASE])
def test_i_bf16_form_is_the_float32_form(shape, target, transposed):
    b, d, c, h, w = shape
    plan = resize_plan(b, d, c, h, w, *target, True, transposed)
    x = _bf16_values(np.random.default_rng(sum(shape)).standard_normal(shape))
    want = emulate_resize(x, *target, transposed, plan)
    for piece in _pieces(w):
        got = emulate_resize(x, *target, transposed, plan,
                             stage_bf16(piece, plan))
        np.testing.assert_array_equal(got, want)


# the dyadic cases with rows in pieces of eight and four: a 2x - 1
# upsample of W = 8, and an adjoint whose W axis is the identity at 16
DYADIC_PIECES = DYADIC + [((1, 5, 2, 9, 8), (9, 17, 15), False),
                          ((1, 9, 2, 17, 16), (5, 9, 16), True)]


@pytest.mark.parametrize("shape,target,transposed", DYADIC_PIECES)
def test_i_bf16_form_exact_on_integers(shape, target, transposed):
    """On integers with dyadic weights every sum is exact: the bf16 form
    rounded to bf16 is the port's bf16 plain version (the float32 plain
    version on the upcast input, rounded)."""
    b, d, c, h, w = shape
    plan = resize_plan(b, d, c, h, w, *target, True, transposed)
    x = np.random.default_rng(3 + sum(shape)).integers(
        -8, 9, shape).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = resize_taps_plain(xb, *target, True, transposed)
    assert want.dtype == torch.bfloat16
    for piece in _pieces(w):
        got = emulate_resize(x, *target, transposed, plan,
                             stage_bf16(piece, plan))
        assert torch.equal(torch.from_numpy(got).to(torch.bfloat16), want)


# -- (c) kernel K's staging ----------------------------------------------------

# (nd, w, (max_threads, slab) or None for shear.cu's): the train shape (one
# block a row, one run); chip_smoke.py's small and exact shapes; small
# caps with W % 8 == 0: one column and one diagonal block in nine runs of
# one plane, three of each in runs of several planes
K_SHAPES = ([(64, 128, None)]
            + [(nd, w, None) for nd, w in
               [(6, 20), (8, 8), (5, 11), (9, 6), (13, 13), (11, 130),
                (24, 21), (72, 68), (9, 64), (2, 13), (9, 21), (7, 24),
                (1, 12), (40, 520), (70, 2100), (5, 3001), (3, 60001)]]
            + [(9, 16, (32, 96)), (12, 72, (32, 512)), (10, 40, (32, 256)),
               (9, 13, (32, 64))])


def _k_plan(nd, w, eb, addr, caps):
    return adj_plan(1, nd, 1, 1, w, eb, addr, *(caps or ()))


def _walkers(plan, w, split):
    """A block's walkers as shear_adj_kernel assigns them: (j, u, col,
    diag) over its threads."""
    bd, ncs = plan.threads, plan.col_splits
    tid = np.arange(bd)
    if ncs == 0:
        j, u = tid, tid - w - 2
    elif split < ncs:
        j, u = split * bd + tid, np.full(bd, w + 2)
    else:
        j, u = np.full(bd, w), (split - ncs) * bd - 2 + tid
    col = j < w
    diag = ~col & (u >= -2) & (u <= w + 1)
    return j, u, col, diag


def _walk_range(j, u, col, diag, nd, w):
    start = np.where(diag & (u < 0), -u, 0)
    last = np.where(col, np.minimum(nd - 1, j + 2),
                    np.where(diag, np.minimum(nd - 1, w - 1 - u), -1))
    return start, last


@pytest.mark.parametrize("nd,w,caps", K_SHAPES)
def test_k_bf16_pieces_cover_every_read(nd, w, caps):
    slab = caps[1] if caps else ADJ_SLAB
    for addr in (0, 8):
        p2 = _k_plan(nd, w, 2, addr, caps)
        piece = adj_piece(w, addr, 2)
        assert p2.copy_bytes == 2 * piece and p2.vec == int(piece > 1)
        assert p2.planes * p2.cols <= slab
        assert p2.smem == 2 * p2.planes * p2.cols
        if piece > 1:
            # every slab row and every source row start on a piece
            assert w % piece == 0 and (p2.cols * 2) % (2 * piece) == 0
        cols, diags = [], []
        for split in range(p2.splits):
            j, u, col, diag = _walkers(p2, w, split)
            cols += list(j[col])
            diags += list(u[diag])
            start, last = _walk_range(j, u, col, diag, nd, w)
            steps = np.zeros(p2.threads, np.int64)
            for c0 in range(0, nd, p2.planes):
                c1 = min(nd, c0 + p2.planes)
                x0, x1 = adj_window(p2, w, split, c0, c1, piece)
                assert x0 % piece == 0 and (x1 - x0) % piece == 0
                assert 0 <= x0 <= x1 <= w and x1 - x0 <= p2.cols
                for d in range(c0, c1):
                    walk = (col | diag) & (d >= start) & (d <= last)
                    at = np.where(col, j, u + d)[walk]
                    assert bool(((at >= x0) & (at < x1)).all()), (split, d)
                    steps += walk
            walks = np.maximum(0, last - start + 1)
            assert bool((steps[col | diag] == walks[col | diag]).all())
        assert sorted(cols) == list(range(w))
        assert sorted(diags) == list(range(-2, w + 2))


@pytest.mark.parametrize("nd,w,caps", K_SHAPES)
def test_k_bf16_plan_is_the_float32_plan(nd, w, caps):
    """The walkers take shapes only, and so do the runs but where a
    diagonal block's pitch widens for pieces of eight: the bf16 plan is
    the float32 plan but for its bytes and its copy width (one block a
    row, every main-path shape), the float32 plan the shear tests'
    mirror."""
    assert (ADJ_SLAB, ADJ_MAX_THREADS) == (CU["kAdjSlabFloats"],
                                           CU["kAdjMaxThreads"])
    p4, p2 = _k_plan(nd, w, 4, 0, caps), _k_plan(nd, w, 2, 0, caps)
    assert (p4.threads, p4.col_splits, p4.splits, p4.planes, p4.cols) == \
        mirror_adj_plan(nd, w, w % 4 == 0, *(caps or ()))
    same = ("blocks", "threads", "splits", "col_splits")
    assert [getattr(p2, f) for f in same] == [getattr(p4, f) for f in same]
    if p2.col_splits == 0 or adj_piece(w, 0, 2) < 8:
        assert (p2.planes, p2.cols, p2.runs) == (p4.planes, p4.cols, p4.runs)
        assert p2.smem * 2 == p4.smem
    assert p2.smem < p4.smem


# -- (d) kernel K's form -------------------------------------------------------

def walk_k_bf16(dz: torch.Tensor, caps=None, addr=0):
    """Kernel K's bf16 instance on dz (B, D, co, H, W) bf16 in its own
    order: per block and run the slab staged piece by piece (NaN where
    nothing was copied), the walkers' reads widened, running sums from d =
    0 and d = 1 in float32, each output written at the step where its
    range ends (only in the walk's tail steps, as the kernel writes them)
    and exactly once (asserted)."""
    b, nd, co, h, w = dz.shape
    rows = dz.permute(0, 2, 3, 1, 4).reshape(-1, nd, w)   # (R, D, W) bf16
    r = rows.shape[0]
    plan = _k_plan(nd, w, 2, addr, caps)
    piece = adj_piece(w, addr, 2)
    nan = float("nan")
    dpx = torch.full((r, 9, w), nan)
    dpy = torch.full((r, 9, w), nan)
    wx = np.zeros((9, w), np.int64)
    wy = np.zeros((9, w), np.int64)
    his = [nd - 2 if dd == 2 else nd - 1 for dd, _ in T9]
    for split in range(plan.splits):
        j, u, col, diag = _walkers(plan, w, split)
        start, last = _walk_range(j, u, col, diag, nd, w)
        ts = last - np.where(col, 4, 1)
        for t, (dd, dw) in enumerate(T9):      # outputs whose range is empty
            k, hi = K_T[t], his[t]
            m = col & (np.minimum(hi, j - k) < 0)
            dpx[:, t, j[m]] = 0.0
            wx[t, j[m]] += 1
            i = u - k
            m = diag & (i >= 0) & (i < w) & (
                np.minimum(hi, w - 1 - u - int(dw == 2)) < start)
            dpy[:, t, i[m]] = 0.0
            wy[t, i[m]] += 1
        s0 = torch.zeros(r, plan.threads)
        s1 = torch.zeros(r, plan.threads)
        for c0 in range(0, nd, plan.planes):
            c1 = min(nd, c0 + plan.planes)
            x0, x1 = adj_window(plan, w, split, c0, c1, piece)
            slab = torch.full((r, plan.planes, plan.cols), nan,
                              dtype=torch.bfloat16)
            for q in range(x0, x1, piece):
                slab[:, :c1 - c0, q - x0:q - x0 + piece] = \
                    rows[:, c0:c1, q:q + piece]
            for d in range(c0, c1):
                walk = (col | diag) & (d >= start) & (d <= last)
                at = np.clip(np.where(col, j, u + d) - x0, 0, plan.cols - 1)
                v = slab[:, d - c0, torch.from_numpy(at)].float()
                wk = torch.from_numpy(walk)
                assert not bool(v[:, wk].isnan().any()), (split, d)
                s0 = torch.where(wk, s0 + v, s0)
                if d >= 1:
                    s1 = torch.where(wk, s1 + v, s1)
                snap = walk & (d >= ts)
                for t, (dd, dw) in enumerate(T9):
                    k, hi = K_T[t], his[t]
                    s = s1 if dd == 0 else s0
                    m = snap & col & (d == np.minimum(hi, j - k))
                    dpx[:, t, j[m]] = s[:, torch.from_numpy(m)]
                    wx[t, j[m]] += 1
                    i = u - k
                    m = snap & diag & (i >= 0) & (i < w) & (
                        d == np.minimum(hi, w - 1 - u - int(dw == 2)))
                    dpy[:, t, i[m]] = s[:, torch.from_numpy(m)]
                    wy[t, i[m]] += 1
    assert (wx == 1).all(), "a dpx output not written exactly once"
    assert (wy == 1).all(), "a dpy output not written exactly once"

    def back(a):
        return a.reshape(b, co, h, 9, w).permute(0, 3, 1, 2, 4)
    return back(dpx), back(dpy)


# (b, nd, co, h, w, caps, addr): the train shape's rows (pieces of eight,
# one block, one run), pieces of four (W % 8 == 4, and dz 8 bytes past a
# 16-byte boundary), the element path (odd W), and column and diagonal
# blocks with pieces of eight at small caps
K_FORM_CASES = [(1, 64, 2, 2, 128, None, 0), (2, 9, 3, 2, 20, None, 0),
                (1, 9, 2, 2, 64, None, 8), (2, 7, 2, 3, 13, None, 0),
                (1, 12, 2, 2, 72, (32, 512), 0),
                (1, 9, 1, 2, 16, (32, 96), 0),
                (1, 10, 2, 1, 40, (32, 256), 8)]


@pytest.mark.parametrize("b,nd,co,h,w,caps,addr", K_FORM_CASES)
def test_k_bf16_form_exact_on_integers(b, nd, co, h, w, caps, addr):
    rng = np.random.default_rng(5 * w + nd)
    dz = torch.from_numpy(rng.integers(-3, 4, (b, nd, co, h, w))
                          .astype(np.float32)).to(torch.bfloat16)
    got = walk_k_bf16(dz, caps, addr)
    want = shear_adjoint_plain(dz, nd)
    for a, r in zip(got, want):
        assert a.dtype == r.dtype == torch.float32
        assert torch.equal(a, r)


@pytest.mark.parametrize("b,nd,co,h,w,caps,addr", K_FORM_CASES)
def test_k_bf16_form_is_the_sequential_sum(b, nd, co, h, w, caps, addr):
    rng = np.random.default_rng(7 * w + nd)
    dz = torch.from_numpy(rng.standard_normal((b, nd, co, h, w))
                          .astype(np.float32)).to(torch.bfloat16)
    got = walk_k_bf16(dz, caps, addr)
    want = sequential_k(dz.float())
    for a, r in zip(got, want):
        assert torch.equal(a, r)
