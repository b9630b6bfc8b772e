"""Kernels J and K (csrc/shear.cu) as redesigned for the H100, on the CPU:
torch forms of the two CUDA kernels in their own order of arithmetic.

(a) The class table: the kernel's gate, diagonal and edge bits (read from
the CUDA source) give exactly the plain version's masks at every (d, j).
J's pieces and groups (``j_groups``, its enumeration mirrored with the
source's constants: pieces of columns x planes, then in each the
term-by-term groups and the stream of tasks) write every group of a row
once, each in the phase its class calls for, every read inside what its
piece staged. K's blocks (``adj_plan`` and the walker and window rules of
shear_adj_kernel mirrored) give every column and diagonal one walker, and
every step of a walk lies in one run and reads inside that run's staged
columns.
(b) ``emulate_j``: P[j] and R[u] summed t ascending, the interior P + R,
the band, the first and last planes and the last column term by term in
the TPU kernel's order, then fmaf(z, a, c) (+ReLU). ``emulate_k``: the
column and diagonal walks, running sums from d = 0 and d = 1 written at
the step where each output's range ends, each output written exactly once.
On integer-valued inputs, where every order of summation is exact, both
equal, bit for bit, the plain versions, the TPU kernels in interpret mode
and the materialized cost volume + conv (kernel B's plain version; for K,
dX, dY and dW through the tap-map convs against autograd through it), at
the shapes of tests/test_torch_port_variants_ops.py::SHEAR_CASES and at
D = 1, D = 2 and W <= 4.
(c) In float32 J's form is within CONV_RTOL of the plain version (the
interior sums its 18 terms in another order) and K's form equals a
sequential ascending-d loop over the plain version's masks bit for bit.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.ops import pallas_shear as jshear
from rag_tpu_torch.ops.cvstem import cvstem_brc_plain
from rag_tpu_torch.ops.shear import (
    T9,
    _masks,
    shear_adjoint_plain,
    shear_forward_plain,
    tap_maps,
)
from test_torch_port_variants_ops import SHEAR_CASES

CONV_RTOL = 1e-5   # of max(1, |plain|), as chip_smoke.py holds kernel J
SHEAR_CU = Path(__file__).resolve().parent.parent / "rag_tpu_torch" / "csrc" \
    / "shear.cu"
K_T = tuple(dd - dw for dd, dw in T9)
ALL = 0x1FF


def _cu_consts():
    """The plain constants of shear.cu (tilings, caps), by name."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", SHEAR_CU.read_text())}


CU = _cu_consts()


def _cu_tables():
    """diag(u) for u = -2 .. 1 and edge(W - 1), as shear.cu writes them."""
    src = SHEAR_CU.read_text()
    m = re.search(r"kDiagTable =\s*0x([0-9A-F]+)ull \| 0x([0-9A-F]+)ull << 9"
                  r" \| 0x([0-9A-F]+)ull << 18 \| 0x([0-9A-F]+)ull << 27;",
                  src)
    e = re.search(r"kEdgeLast = 0x([0-9A-F]+)u;", src)
    assert m and e, "shear.cu: class table not found"
    return tuple(int(v, 16) for v in m.groups()), int(e.group(1), 16)


DIAG, EDGE_LAST = _cu_tables()


def gate_bits(d: torch.Tensor, nd: int) -> torch.Tensor:
    return (torch.where(d >= 1, 0x007, 0) | 0x038
            | torch.where(d <= nd - 2, 0x1C0, 0))


def diag_bits(u: torch.Tensor) -> torch.Tensor:
    tab = torch.tensor(DIAG)
    return torch.where(u < -2, 0, torch.where(u > 1, ALL,
                                              tab[(u + 2).clamp(0, 3)]))


def class_bits(nd: int, w: int):
    """(kx, ky), (D, W) int: the terms each output keeps."""
    d = torch.arange(nd)[:, None]
    j = torch.arange(w)[None, :]
    kx = gate_bits(d, nd) & diag_bits(j - d)
    return kx, kx & torch.where(j == w - 1, EDGE_LAST, ALL)


def _bit(k: torch.Tensor, t: int) -> torch.Tensor:
    return (k >> t) & 1 == 1


# -- the torch forms of the kernels ------------------------------------------

def emulate_j(px, py, scale, bias, nd, relu=False):
    """Kernel J in its own order: (B, 9, co, H, W) -> (B, nd, co, H, W)."""
    b, _, co, h, w = px.shape
    p = px.new_zeros((b, co, h, w))
    for t in range(9):
        p = p + px[:, t]
    r = px.new_zeros((b, co, h, w))
    if w >= 5:                       # R[u] for u in [2, W-3], t ascending
        mid = px.new_zeros((b, co, h, w - 4))
        for t, k in enumerate(K_T):
            mid = mid + py[:, t, ..., 2 - k:w - 2 - k]
        r[..., 2:w - 2] = mid
    kx, ky = class_bits(nd, w)
    j = torch.arange(w)
    zero = px.new_zeros(())
    planes = []
    for d in range(nd):
        u = j - d
        acc = px.new_zeros((b, co, h, w))
        for t, k in enumerate(K_T):
            acc = acc + torch.where(_bit(kx[d], t), px[:, t], zero)
            acc = acc + torch.where(_bit(ky[d], t),
                                    py[:, t][..., (u - k).clamp(0, w - 1)],
                                    zero)
        inner = p + r[..., u.clamp(0, w - 1)]
        planes.append(torch.where(ky[d] == ALL, inner, acc))
    z = torch.stack(planes, 1)
    # fmaf: the exact product plus c, rounded once (float64 holds the
    # product of two float32 values exactly)
    y = (z.double() * scale.double().reshape(1, 1, -1, 1, 1)
         + bias.double().reshape(1, 1, -1, 1, 1)).to(z.dtype)
    return torch.relu(y) if relu else y


def _gate_ranges(nd):
    """Per term: the planes [lo, hi] its D-pad gate keeps."""
    return [(1 if dd == 0 else 0, nd - 2 if dd == 2 else nd - 1)
            for dd, _ in T9]


def emulate_k(dz):
    """Kernel K in its own order: dz (B, D, co, H, W) -> (dpx, dpy). Every
    output is written exactly once (asserted)."""
    b, nd, co, h, w = dz.shape
    gate = _gate_ranges(nd)
    zero = dz.new_zeros(())
    # columns j: walk d = 0 .. last, ranges end in the last five steps
    j = torch.arange(w)
    last = torch.clamp(j + 2, max=nd - 1)
    ts = last - 4
    ends = [torch.clamp(j - k, max=hi) for k, (_, hi) in zip(K_T, gate)]
    dpx = [dz.new_full((b, co, h, w), float("nan")) for _ in range(9)]
    writes = torch.zeros(9, w, dtype=torch.int64)
    for t in range(9):
        empty = ends[t] < 0
        dpx[t] = torch.where(empty, zero, dpx[t])
        writes[t] += empty
    s0 = dz.new_zeros((b, co, h, w))
    s1 = dz.new_zeros((b, co, h, w))
    for d in range(nd):
        walk = d <= last
        v = dz[:, d]
        s0 = torch.where(walk, s0 + v, s0)
        if d >= 1:
            s1 = torch.where(walk, s1 + v, s1)
        tail = walk & (d >= ts)
        for t, (lo, _) in enumerate(gate):
            take = tail & (ends[t] == d)
            dpx[t] = torch.where(take, s1 if lo else s0, dpx[t])
            writes[t] += take
    # diagonals u = -2 .. W+1: walk d = max(0, -u) .. last, ranges end in
    # the last two steps; dpy[t][i] comes from u = i + k_t
    u = torch.arange(-2, w + 2)
    start = torch.clamp(-u, min=0)
    last = torch.clamp(w - 1 - u, max=nd - 1)
    ts = last - 1
    ends = [torch.clamp(w - 1 - u - int(dw == 2), max=hi)
            for (_, dw), (_, hi) in zip(T9, gate)]
    snap = [dz.new_full((b, co, h, w + 4), float("nan")) for _ in range(9)]
    wsnap = torch.zeros(9, w + 4, dtype=torch.int64)
    for t in range(9):
        empty = ends[t] < start
        snap[t] = torch.where(empty, zero, snap[t])
        wsnap[t] += empty
    s0 = dz.new_zeros((b, co, h, w + 4))
    s1 = dz.new_zeros((b, co, h, w + 4))
    for d in range(nd):
        walk = (d >= start) & (d <= last)
        v = dz[:, d][..., (u + d).clamp(0, w - 1)]
        s0 = torch.where(walk, s0 + v, s0)
        if d >= 1:
            s1 = torch.where(walk, s1 + v, s1)
        tail = walk & (d >= ts)
        for t, (lo, _) in enumerate(gate):
            take = tail & (ends[t] == d)
            snap[t] = torch.where(take, s1 if lo else s0, snap[t])
            wsnap[t] += take
    i = torch.arange(w)
    dpy = [snap[t][..., i + k + 2] for t, k in enumerate(K_T)]
    ywrites = torch.stack([wsnap[t][i + k + 2] for t, k in enumerate(K_T)])
    assert bool((writes == 1).all()), "a dpx output not written exactly once"
    assert bool((ywrites == 1).all()), "a dpy output not written exactly once"
    return torch.stack(dpx, 1), torch.stack(dpy, 1)


def sequential_k(dz):
    """dz -> (dpx, dpy) by a loop over d in ascending order, adding the
    plain version's masked terms one plane at a time."""
    b, nd, co, h, w = dz.shape
    i = torch.arange(w)
    zero = dz.new_zeros(())
    dpx, dpy = [], []
    for dd, dw in T9:
        s, xm, ym = _masks(nd, w, dd, dw, dz.device)
        ax = dz.new_zeros((b, co, h, w))
        ay = dz.new_zeros((b, co, h, w))
        for d in range(nd):
            ax = ax + torch.where(xm[d], dz[:, d], zero)
            jj = i + s[d]
            keep = (jj >= 0) & (jj < w) & ym[d][jj.clamp(0, w - 1)]
            ay = ay + torch.where(keep, dz[:, d][..., jj.clamp(0, w - 1)],
                                  zero)
        dpx.append(ax)
        dpy.append(ay)
    return torch.stack(dpx, 1), torch.stack(dpy, 1)


# -- (a) the class table, J's pieces and groups, K's splits and windows --------

@pytest.mark.parametrize("nd,w", [(1, 6), (2, 3), (24, 24), (5, 1)])
def test_class_table_is_the_plain_masks(nd, w):
    kx, ky = class_bits(nd, w)
    for t, (dd, dw) in enumerate(T9):
        _, xm, ym = _masks(nd, w, dd, dw, torch.device("cpu"))
        assert torch.equal(_bit(kx, t), xm), (t, "px")
        assert torch.equal(_bit(ky, t), ym), (t, "py")
    # the interior's R[u] reads stay in [0, W)
    d, j = torch.nonzero(ky == ALL, as_tuple=True)
    u = j - d
    assert bool(((u >= 2) & (u <= w - 3)).all())


def _cdiv(a, b):
    return -(-a // b)


def _round4(n):
    return (n + 3) & ~3


def fwd_plan(nd, w, vec, tile_cols=CU["kFwdTileCols"],
             tile_planes=CU["kFwdTilePlanes"]):
    """(tw, dp): J's pieces of columns x planes, as shear.cu::fwd_plan
    chooses them."""
    tw = _cdiv(w, _cdiv(w, tile_cols))
    tw = _round4(tw) if vec else tw
    return tw, _cdiv(nd, _cdiv(nd, tile_planes))


def j_groups(nd, w, g, tw, dp, pb=CU["kFwdPlanes"]):
    """(phase, d, q, piece) of every group kernel J writes for one row, as
    shear_fwd_kernel<G> enumerates them, piece by piece: phase 1 the
    planes 0 and D-1 from their first non-zero group, and S slots a plane
    between (the band groups and the last group); phase 2 the tasks (run of
    pb planes, group) storing the wholly zero or wholly interior groups. A
    piece is its columns [j0, j1), planes [d0, d1), staged py columns
    [y0, y1) and R's first and last u."""
    ng_all, slots = w // g, (3 if g == 4 else 5)
    tiles = _cdiv(w, tw)
    out = []
    for piece in range(tiles * _cdiv(nd, dp)):
        j0, d0 = piece % tiles * tw, piece // tiles * dp
        j1, d1 = min(w, j0 + tw), min(nd, d0 + dp)
        y0, y1 = max(0, j0 - d1 - 1), min(w, j1 - d0 + 2)
        if g == 4:
            y0, y1 = y0 & ~3, min(w, _round4(y1))
        pc = (j0, j1, d0, d1, y0, max(y1, y0), max(2, j0 - d1 + 1),
              min(w - 3, j1 - 1 - d0))
        g0, g1 = j0 // g, j1 // g
        ng = g1 - g0
        b0, b1 = max(d0, 1), min(d1, nd - 1)
        n_edge = 2 * ng
        for i in range(n_edge + max(0, b1 - b0) * slots):
            if i < n_edge:
                d = 0 if i < ng else nd - 1
                q = g0 + (i if i < ng else i - ng)
                if d < d0 or d >= d1 or (i >= ng and nd == 1):
                    continue
                if q < max(0, d - 2) // g:
                    continue
            else:
                s, d = (i - n_edge) % slots, b0 + (i - n_edge) // slots
                if s < slots - 1:
                    q = max(0, d - 2) // g + s
                    if q >= (d + 2 + g - 1) // g or q >= ng_all - 1:
                        continue
                else:
                    q = ng_all - 1
                    if d > w + 1:
                        continue
                if q < g0 or q >= g1:
                    continue
            out.append((1, d, q, pc))
        for task in range(_cdiv(d1 - d0, pb) * ng):
            run, q = divmod(task, ng)
            j = j0 + q * g
            for d in range(d0 + run * pb, min(d1, d0 + run * pb + pb)):
                if (j + g - 1 - d <= -3 or (1 <= d <= nd - 2 and j - d >= 2
                                            and j + g - 1 <= w - 2)):
                    out.append((2, d, g0 + q, pc))
    return out


# (nd, w, (tile_cols, tile_planes) or None for shear.cu's): the main-path
# rows (one piece), then small tilings: several column tiles and plane
# chunks, D = 1, D = 2, D > W, odd W
J_PIECE_CASES = [(64, 320, None), (64, 128, None), (1, 13, (4, 2)),
                 (2, 12, (8, 1)), (14, 8, (4, 4)), (40, 36, (16, 16)),
                 (70, 300, (128, 32))]


@pytest.mark.parametrize("nd,w,tiling", J_PIECE_CASES)
def test_j_writes_every_group_once_reading_what_it_staged(nd, w, tiling):
    """Every output group is written exactly once; phase 2's groups keep no
    term or all eighteen, phase 1's are the others; each output reads only
    what its piece staged (px and P at its column, R at its u, py at every
    term's column, clamped into the staged ones) within the shared
    memory's rows (shear.cu::FwdLayout)."""
    kx, ky = class_bits(nd, w)
    for g in (1, 4) if w % 4 == 0 else (1,):
        tw, dp = fwd_plan(nd, w, g == 4, *(tiling or ()))
        wx, wr = _round4(tw), min(w, tw + dp)
        wy = min(_round4(w), _round4(tw + dp + 9))
        seen = j_groups(nd, w, g, tw, dp)
        assert sorted((d, q) for _, d, q, _ in seen) == [
            (d, q) for d in range(nd) for q in range(w // g)], g
        for phase, d, q, (j0, j1, d0, d1, y0, y1, r0, r1) in seen:
            cols = slice(q * g, q * g + g)
            uniform = (int(kx[d, cols].max()) == 0
                       or bool((ky[d, cols] == ALL).all()))
            assert uniform == (phase == 2), (g, d, q)
            assert d0 <= d < d1 and j0 <= q * g and q * g + g <= j1
            assert j1 - j0 <= wx and y1 - y0 <= wy and r1 - r0 + 1 <= wr
            for j in range(q * g, q * g + g):
                u = j - d
                if int(ky[d, j]) == ALL:
                    assert r0 <= u <= r1, (g, d, j)
                elif int(kx[d, j]):
                    assert y0 < y1, (g, d, j)
                    for t, k in enumerate(K_T):
                        if int(ky[d, j]) >> t & 1:
                            assert y0 <= u - k < y1, (g, d, j, t)


def adj_plan(nd, w, vec, max_threads=CU["kAdjMaxThreads"],
             slab=CU["kAdjSlabFloats"]):
    """(threads, ncs, splits, planes, pitch) of kernel K, as
    shear.cu::adj_plan chooses them."""
    if 2 * w + 4 <= max_threads:
        threads, ncs, splits, most = -(-(2 * w + 4) // 32) * 32, 0, 1, \
            slab // w
    else:
        ncs, nds = _cdiv(w, max_threads), _cdiv(w + 4, max_threads)
        threads = _cdiv(max(_cdiv(w, ncs), _cdiv(w + 4, nds)), 32) * 32
        splits, most = ncs + nds, 1
        while (most + 1) * _round4(threads + most + 9) <= slab:
            most += 1
    runs = _cdiv(nd, max(most, 1))
    planes = _cdiv(nd, runs)
    pitch = w if ncs == 0 else _round4(threads + planes + 8)
    return threads, ncs, splits, planes, pitch


# (nd, w, (max_threads, slab floats) or None for shear.cu's): the train
# shape (one block a row, one run); 520 (a column and a diagonal block, two
# runs), 2100 (six blocks, four runs); small caps: one block in three
# runs, and three column and three diagonal blocks in three runs
K_SPLIT_CASES = [(64, 128, None), (40, 520, None), (70, 2100, None),
                 (9, 13, (32, 64)), (12, 70, (32, 256))]


@pytest.mark.parametrize("nd,w,caps", K_SPLIT_CASES)
def test_k_walkers_read_inside_their_window(nd, w, caps):
    """Kernel K's blocks, as shear_adj_kernel assigns walkers and stages
    dz: every column j in [0, W) and diagonal u in [-2, W+1] has exactly
    one walker, each walker's step d (its walk, start .. last) lies in
    exactly one run, and there reads a column inside the run's staged
    window, whose width fits the slab's row pitch."""
    slab = caps[1] if caps else CU["kAdjSlabFloats"]
    for vec in (True, False) if w % 4 == 0 else (False,):
        bd, ncs, splits, planes, pitch = adj_plan(nd, w, vec, *(caps or ()))
        assert planes * pitch <= slab
        tid = np.arange(bd)
        cols, diags = [], []
        for split in range(splits):
            if ncs == 0:
                j, u, xa, ua = tid, tid - w - 2, 0, -2
            elif split < ncs:
                j, u, xa, ua = split * bd + tid, np.full(bd, w + 2), \
                    split * bd, w + 2
            else:
                ua = (split - ncs) * bd - 2
                j, u, xa = np.full(bd, w), ua + tid, -1
            col = j < w
            diag = ~col & (u >= -2) & (u <= w + 1)
            cols += list(j[col])
            diags += list(u[diag])
            start = np.where(diag & (u < 0), -u, 0)
            last = np.where(col, np.minimum(nd - 1, j + 2),
                            np.where(diag, np.minimum(nd - 1, w - 1 - u), -1))
            steps = np.zeros(bd, np.int64)
            for c0 in range(0, nd, planes):
                c1 = min(nd, c0 + planes)
                if ncs == 0:
                    x0, x1 = 0, w
                elif xa >= 0:
                    x0, x1 = xa, min(w, xa + bd)
                else:
                    x0, x1 = max(0, ua + c0), min(w, ua + bd + c1 - 1)
                    if vec:
                        x0, x1 = x0 & ~3, min(w, _round4(x1))
                    x1 = max(x1, x0)
                assert x1 - x0 <= pitch
                for d in range(c0, c1):
                    walk = (col | diag) & (d >= start) & (d <= last)
                    at = np.where(col, j, u + d)[walk]
                    assert bool(((at >= x0) & (at < x1)).all()), (split, d)
                    steps += walk
            walks = np.maximum(0, last - start + 1)
            assert bool((steps[col | diag] == walks[col | diag]).all())
        assert sorted(cols) == list(range(w))
        assert sorted(diags) == list(range(-2, w + 2))


# -- (b) bit-exact on integers -----------------------------------------------

# (b, c, h, w, cout, nd): D < W, D == W, batch 2, W past 128 and W % 4 ==
# 2, D > W, W = 13; then D = 1, and D = 2 at W = 3
INT_CASES = SHEAR_CASES + [(1, 2, 4, 12, 2, 1), (2, 2, 4, 3, 3, 2)]


def _pallas(px, py, scale, bias, g, nd, relu):
    """The TPU kernels J and K in interpret mode, traced and compiled as one
    function (their compile is most of this file's time)."""
    w = px.shape[-1]
    both = jax.jit(lambda *a: (
        jshear.shear_forward(*a[:4], nd, w, relu=relu, interpret=True),
        jshear.shear_adjoint(a[4], nd, w, interpret=True)))
    z, (dpx, dpy) = both(px.numpy(), py.numpy(), scale.numpy(),
                         bias.numpy(), g.numpy())
    return tuple(torch.from_numpy(np.array(a)) for a in (z, dpx, dpy))


def _ints(seed, *shape, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


@pytest.mark.parametrize("case", range(len(INT_CASES)))
def test_emulations_bit_exact_on_integers(case):
    b, c, h, w, co, nd = INT_CASES[case]
    x, y = _ints(case, b, c, h, w), _ints(case + 50, b, c, h, w)
    w3 = _ints(case + 99, 3, 3, 3, 2 * c, co)
    g = _ints(case + 7, b, nd, co, h, w, lo=-2, hi=3)
    scale = torch.arange(1, co + 1, dtype=torch.float32)
    bias = torch.full((co,), -3.0)
    relu = case % 2 == 1
    px, py = tap_maps(x, y, w3)
    px, py = px.contiguous(), py.contiguous()

    jz, jdpx, jdpy = _pallas(px, py, scale, bias, g, nd, relu)
    z = emulate_j(px, py, scale, bias, nd, relu)
    refs = {
        "plain": shear_forward_plain(px, py, scale, bias, nd, relu),
        "pallas": jz,
        "volume": cvstem_brc_plain(x, y, w3, scale, bias, nd, relu),
    }
    for name, ref in refs.items():
        assert torch.equal(z, ref), f"J vs {name}"

    dpx, dpy = emulate_k(g)
    for name, (rx, ry) in {"plain": shear_adjoint_plain(g, nd),
                           "pallas": (jdpx, jdpy)}.items():
        assert torch.equal(dpx, rx), f"K's dpx vs {name}"
        assert torch.equal(dpy, ry), f"K's dpy vs {name}"
    # through the tap-map convs: dX, dY, dW against the volume's autograd
    leaves = [a.clone().requires_grad_(True) for a in (x, y, w3)]
    got = torch.autograd.grad(tap_maps(*leaves), leaves, (dpx, dpy))
    one, none = torch.ones(co), torch.zeros(co)
    want = torch.autograd.grad(
        cvstem_brc_plain(*leaves, one, none, nd, False), leaves, g)
    for name, a, r in zip("XYW", got, want):
        assert torch.equal(a, r), f"K's d{name} vs the volume"


# -- (c) float32 -------------------------------------------------------------

# (b, co, h, nd, w): W % 4 == 0 with an interior, odd W, D > W, D = 2
F32_CASES = [(1, 4, 6, 16, 128), (2, 3, 5, 7, 21), (1, 2, 3, 14, 10),
             (1, 2, 2, 2, 4)]


@pytest.mark.parametrize("b,co,h,nd,w", F32_CASES)
def test_j_form_float32_within_conv_rtol(b, co, h, nd, w):
    rng = np.random.default_rng(w + nd)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    px, py = f(b, 9, co, h, w), f(b, 9, co, h, w)
    scale, bias = f(co) * 0.3 + 1.0, f(co) * 0.1
    for relu in (False, True):
        got = emulate_j(px, py, scale, bias, nd, relu)
        ref = shear_forward_plain(px, py, scale, bias, nd, relu)
        tol = CONV_RTOL * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("b,co,h,nd,w", F32_CASES)
def test_k_form_float32_is_the_sequential_sum(b, co, h, nd, w):
    rng = np.random.default_rng(3 * w + nd)
    dz = torch.from_numpy(rng.standard_normal((b, nd, co, h, w))
                          .astype(np.float32))
    got = emulate_k(dz)
    want = sequential_k(dz)
    for a, r in zip(got, want):
        assert torch.equal(a, r)
