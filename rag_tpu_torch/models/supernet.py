"""The MdeNAS search supernet (stereo): every cell edge carries both
candidate ops, and the sampled op vector picks one per edge.

Counterpart of the stereo half of rag_tpu/models/supernet.py. rag_tpu
chooses each edge's op with ``jax.lax.cond`` on a traced index; the ops are
host numpy ints, so the port branches in Python: op 1 runs the edge's
ConvBR, op 0 returns the input and the edge's statistics unchanged, and
only the sampled op's weights and BatchNorm see the batch. A cell step sums
every live in-edge (the supernet's cells are not a genotype's two-edge
cells), and a cell without an s0 input has no edges 0, 2 and 5.

Macro wiring (fixed): the feature half is 3 stems, 4 cells
[down, up, down, up] and a 1x1 conv, run on left and right stacked as one
batch with per-half train-mode BatchNorm (``halves=2``); the matching half
is a stem, 8 cells [same, same, same, down, down, up, down, same] and the
three output convs with two trilinear resizes.

Layout. The matching half always runs channel-first (B, D, C, H, W)
through ``ops.convbr_cf``: every 3x3x3 conv is kernel A forward and dx and
kernel D for dW on the card (their plain versions on the CPU). rag_tpu
takes this layout only on the TPU and where H % 8 == 0, and runs the
channels-last one elsewhere; both layouts compute the same function. The
cost volume (``ops.cost_volume.cost_volume_cf``) and the soft-argmin head
(``ops.disparity.soft_argmin_disparity``) are plain PyTorch, as they are
plain XLA in rag_tpu: the supernet runs no kernel B, C, E, F or G.

The depth supernet (``init_depth_supernet``, ``depth_supernet_forward``)
is the monocular variant's: the feature half on the image alone, the
matching half rewired to 2D at the same wiring and channels (``DMAT_*``)
on the features, and the depth head, whose leaves are 'w' and 'b' (the
depth net's head calls its bias 'bias1'). It is all 2D: it runs no
hand-written kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import math

import torch

from rag_tpu_torch.models.depth import DEPTH_HEAD_SPEC, depth_head
from rag_tpu_torch.models.stereo import MAXDISP, full_fp32
from rag_tpu_torch.ops.convbr import ConvBRSpec, apply_convbr, init_convbr
from rag_tpu_torch.ops.convbr_cf import apply_convbr_cf
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.disparity import soft_argmin_disparity
from rag_tpu_torch.ops.precision import FP32, Precision, wide
from rag_tpu_torch.ops.resize import resize_cf, resize_linear, scale_dimension
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants

NUM_EDGES = 9  # sum(2 + i for i in range(3))
STEPS = 3
BLOCK = 3
FM = 4
INITIAL_FM = FM * BLOCK  # 12
HALF_FM = INITIAL_FM // 2

# edges whose input is state0 (dead when the cell has no s0 input)
_S0_EDGES = (0, 2, 5)


@dataclasses.dataclass(frozen=True)
class SuperCellSpec:
    ndim: int
    c_pp: Optional[int]  # None when the cell has no prev_prev input
    c_p: int
    c_out: int
    mode: str  # 'down' | 'same' | 'up'

    @property
    def has_s0(self) -> bool:
        return self.c_pp is not None

    @property
    def live_edges(self):
        return tuple(
            e for e in range(NUM_EDGES) if self.has_s0 or e not in _S0_EDGES
        )


def init_supercell(generator: torch.Generator, spec: SuperCellSpec,
                   device="cuda"):
    """Fresh (params, stats): 'pre' (where the cell has s0 and c_pp !=
    c_out), 'prep' and one 'edges' entry per live edge."""
    params: Dict[str, Any] = {"edges": {}}
    stats: Dict[str, Any] = {"edges": {}}
    if spec.has_s0 and spec.c_pp != spec.c_out:
        params["pre"], stats["pre"] = init_convbr(
            generator, ConvBRSpec(spec.ndim, spec.c_pp, spec.c_out, 1), device)
    params["prep"], stats["prep"] = init_convbr(
        generator, ConvBRSpec(spec.ndim, spec.c_p, spec.c_out, 1), device)
    conv = ConvBRSpec(spec.ndim, spec.c_out, spec.c_out, 3)
    for e in spec.live_edges:
        params["edges"][str(e)], stats["edges"][str(e)] = init_convbr(
            generator, conv, device)
    return params, stats


def _apply(spec: ConvBRSpec, params, stats, x, train, halves, variants):
    if spec.ndim == 3:
        return apply_convbr_cf(spec, params, stats, x, train, variants)
    return apply_convbr(spec, params, stats, x, train, halves)


def _mixed_op(conv_spec, p, st, x, op: int, train, halves, variants):
    """Op 1: the edge's ConvBR; op 0: the input and stats unchanged."""
    if int(op) == 1:
        return _apply(conv_spec, p, st, x, train, halves, variants)
    return x, st


def apply_supercell(spec: SuperCellSpec, params, stats, s0, s1, ops, train,
                    halves: int = 1, variants: KernelVariants = DEFAULT):
    """ops: 9 sampled op indices. 2D cells take NHWC maps, 3D cells
    channel-first volumes. Returns (out, new_stats)."""
    if spec.ndim == 3:
        axes, cat_axis = (1, 3, 4), 2
    else:
        axes, cat_axis = (1, 2), -1

    def resize(x, target):
        if spec.ndim == 3:
            return resize_cf(x, *target, True, variants)
        return resize_linear(x, target, axes, align_corners=True)

    new_stats: Dict[str, Any] = {"edges": {}}
    if spec.mode != "same":
        scale = 0.5 if spec.mode == "down" else 2.0
        s1 = resize(s1, tuple(scale_dimension(s1.shape[a], scale)
                              for a in axes))
    prep = ConvBRSpec(spec.ndim, spec.c_p, spec.c_out, 1)
    s1p, new_stats["prep"] = _apply(prep, params["prep"], stats["prep"], s1,
                                    train, halves, variants)
    if spec.has_s0:
        s1_spatial = tuple(s1p.shape[a] for a in axes)
        if tuple(s0.shape[a] for a in axes) != s1_spatial:
            s0 = resize(s0, s1_spatial)
        if spec.c_pp != spec.c_out:
            pre = ConvBRSpec(spec.ndim, spec.c_pp, spec.c_out, 1)
            s0, new_stats["pre"] = _apply(pre, params["pre"], stats["pre"],
                                          s0, train, halves, variants)
    else:
        s0 = None

    conv = ConvBRSpec(spec.ndim, spec.c_out, spec.c_out, 3)
    states = [s0, s1p]
    offset = 0
    for _ in range(STEPS):
        acc = None
        for j, h in enumerate(states):
            e = offset + j
            if h is None or e not in spec.live_edges:
                continue
            k = str(e)
            out, new_stats["edges"][k] = _mixed_op(
                conv, params["edges"][k], stats["edges"][k], h, ops[e],
                train, halves, variants)
            acc = out if acc is None else acc + out
        offset += len(states)
        states.append(acc)
    return torch.cat(states[-BLOCK:], dim=cat_axis), new_stats


# Feature supernet (AutoFeature)
FEA_STEMS = {
    "stem0": ConvBRSpec(2, 3, HALF_FM, 3, 1),
    "stem1": ConvBRSpec(2, HALF_FM, HALF_FM, 3, 3),
    "stem2": ConvBRSpec(2, HALF_FM, INITIAL_FM, 3, 1),
}
FEA_CELLS = (
    SuperCellSpec(2, None, 12, 8, "down"),
    SuperCellSpec(2, 12, 24, 4, "up"),
    SuperCellSpec(2, 24, 12, 8, "down"),
    SuperCellSpec(2, 12, 24, 4, "up"),
)
FEA_LAST = {"last_3": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 1, 1, bn=False,
                                 relu=False)}

# Matching supernet (AutoMatching)
MAT_STEMS = {"stem0": ConvBRSpec(3, INITIAL_FM * 2, INITIAL_FM, 3, 1)}
MAT_CELLS = (
    SuperCellSpec(3, None, 12, 4, "same"),
    SuperCellSpec(3, 12, 12, 4, "same"),
    SuperCellSpec(3, 12, 12, 4, "same"),
    SuperCellSpec(3, 12, 12, 8, "down"),
    SuperCellSpec(3, 12, 24, 16, "down"),
    SuperCellSpec(3, 24, 48, 8, "up"),
    SuperCellSpec(3, 48, 24, 16, "down"),
    SuperCellSpec(3, 24, 48, 16, "same"),
)
MAT_LAST = {
    "last_3": ConvBRSpec(3, INITIAL_FM, 1, 3, 1, bn=False, relu=False),
    "last_6": ConvBRSpec(3, INITIAL_FM * 2, INITIAL_FM, 1, 1),
    "last_12": ConvBRSpec(3, INITIAL_FM * 4, INITIAL_FM * 2, 1, 1),
}


def init_supernet(generator: torch.Generator, device="cuda"):
    """Fresh (params, stats) of the whole supernet, keyed as rag_tpu's
    ``init_supernet``: {'fea': ..., 'mat': ...}."""
    params: Dict[str, Any] = {"fea": {}, "mat": {}}
    stats: Dict[str, Any] = {"fea": {}, "mat": {}}
    for half, convs, cells in (("fea", {**FEA_STEMS, **FEA_LAST}, FEA_CELLS),
                               ("mat", {**MAT_STEMS, **MAT_LAST}, MAT_CELLS)):
        for name, spec in convs.items():
            params[half][name], stats[half][name] = init_convbr(
                generator, spec, device)
        for i, spec in enumerate(cells):
            params[half][f"cell{i}"], stats[half][f"cell{i}"] = \
                init_supercell(generator, spec, device)
    return params, stats


def _fea_forward(params, stats, x, ops, train, new_stats, halves=1):
    ns = new_stats["fea"]

    def conv(name, h):
        out, ns[name] = apply_convbr(FEA_STEMS.get(name) or FEA_LAST[name],
                                     params["fea"][name], stats["fea"][name],
                                     h, train, halves)
        return out

    def cell(i, s0, s1):
        out, ns[f"cell{i}"] = apply_supercell(
            FEA_CELLS[i], params["fea"][f"cell{i}"], stats["fea"][f"cell{i}"],
            s0, s1, ops, train, halves)
        return out

    stem0 = conv("stem0", x)
    stem1 = conv("stem1", stem0)
    stem2 = conv("stem2", stem1)
    l6 = cell(0, None, stem2)        # 1/6
    l3_1 = cell(1, stem2, l6)        # 1/3
    l6_1 = cell(2, l6, l3_1)         # 1/6
    l3_2 = cell(3, l3_1, l6_1)       # 1/3
    return conv("last_3", l3_2)


def _mat_forward(params, stats, cost, ops, train, new_stats,
                 variants: KernelVariants = DEFAULT):
    """cost: (B, D, 2C, h, w) -> matching output (B, D, 1, h, w)."""
    ns = new_stats["mat"]
    d, h, w = cost.shape[1], cost.shape[3], cost.shape[4]

    def conv(name, v):
        out, ns[name] = apply_convbr_cf(MAT_STEMS.get(name) or MAT_LAST[name],
                                        params["mat"][name],
                                        stats["mat"][name], v, train, variants)
        return out

    def cell(i, s0, s1):
        out, ns[f"cell{i}"] = apply_supercell(
            MAT_CELLS[i], params["mat"][f"cell{i}"], stats["mat"][f"cell{i}"],
            s0, s1, ops, train, variants=variants)
        return out

    stem = conv("stem0", cost)
    l3 = cell(0, None, stem)
    l3_1 = cell(1, stem, l3)
    l3_2 = cell(2, l3, l3_1)
    l6 = cell(3, l3_1, l3_2)         # 1/2
    l12 = cell(4, l3_2, l6)          # 1/4
    l6b = cell(5, l6, l12)           # 1/2
    l12_1 = cell(6, l12, l6b)        # 1/4
    l12_2 = cell(7, l6b, l12_1)      # 1/4

    x = conv("last_12", l12_2)
    x = resize_cf(x, d // 2, h // 2, w // 2, True, variants)
    x = conv("last_6", x)
    x = resize_cf(x, d, h, w, True, variants)
    return conv("last_3", x)


def supernet_forward(params, stats, left: torch.Tensor, right: torch.Tensor,
                     fea_ops, mat_ops, train: bool, maxdisp: int = MAXDISP,
                     variants: KernelVariants = DEFAULT,
                     precision: Precision = FP32):
    """The whole search supernet. left/right (B,H,W,3); fea_ops, mat_ops: 9
    op indices each (host ints). Returns (disp (B,H,W), new_stats): train
    mode runs every BatchNorm on batch statistics and returns the running
    statistics after their update; eval mode returns them unchanged.
    ``precision``: the feature and matching halves store their activations
    in its dtypes, as rag_tpu/models/supernet.py casts them; the head runs
    in float32."""
    variants.check(precision)
    new_stats: Dict[str, Any] = {"fea": {}, "mat": {}}
    with full_fp32():
        both = precision.cast_in(torch.cat([left, right], dim=0))
        f = _fea_forward(params, stats, both, fea_ops, train, new_stats,
                         halves=2)
        bsz = left.shape[0]
        x, y = precision.cast_in(f[:bsz]), precision.cast_in(f[bsz:])
        cost = cost_volume_cf(x, y, maxdisp // 3)
        mat = _mat_forward(params, stats, cost.contiguous(), mat_ops, train,
                           new_stats, variants)
        disp = soft_argmin_disparity(wide(mat[:, :, 0]),
                                     maxdisp, 3)
    return disp, new_stats


# The depth supernet's matching half: 2D at the stereo wiring and channels
DMAT_STEMS = {"stem0": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 3, 1)}
DMAT_CELLS = tuple(SuperCellSpec(2, s.c_pp, s.c_p, s.c_out, s.mode)
                   for s in MAT_CELLS)
DMAT_LAST = {
    "last_3": ConvBRSpec(2, INITIAL_FM, 1, 3, 1, bn=False, relu=False),
    "last_6": ConvBRSpec(2, INITIAL_FM * 2, INITIAL_FM, 1, 1),
    "last_12": ConvBRSpec(2, INITIAL_FM * 4, INITIAL_FM * 2, 1, 1),
}


def init_depth_supernet(generator: torch.Generator, device="cuda"):
    """Fresh (params, stats) of the depth supernet, keyed as rag_tpu's
    ``init_depth_supernet``: {'fea', 'mat', 'depth_head': {'w', 'b'}}
    (the head has no statistics). The head's 'w' is normal * sqrt(2/9),
    'b' zero."""
    params: Dict[str, Any] = {"fea": {}, "mat": {}}
    stats: Dict[str, Any] = {"fea": {}, "mat": {}}
    for half, convs, cells in (("fea", {**FEA_STEMS, **FEA_LAST}, FEA_CELLS),
                               ("mat", {**DMAT_STEMS, **DMAT_LAST},
                                DMAT_CELLS)):
        for name, spec in convs.items():
            params[half][name], stats[half][name] = init_convbr(
                generator, spec, device)
        for i, spec in enumerate(cells):
            params[half][f"cell{i}"], stats[half][f"cell{i}"] = \
                init_supercell(generator, spec, device)
    w = torch.randn((3, 3, 1, 1), generator=generator, dtype=torch.float32)
    params["depth_head"] = {"w": (w * math.sqrt(2.0 / 9)).to(device),
                            "b": torch.zeros(1, device=device)}
    return params, stats


def _dmat_forward(params, stats, fea, ops, train, new_stats):
    """features (B,h,w,12) -> the matching output (B,h,w,1)."""
    ns = new_stats["mat"]

    def conv(name, v):
        out, ns[name] = apply_convbr(DMAT_STEMS.get(name) or DMAT_LAST[name],
                                     params["mat"][name], stats["mat"][name],
                                     v, train)
        return out

    def cell(i, s0, s1):
        out, ns[f"cell{i}"] = apply_supercell(
            DMAT_CELLS[i], params["mat"][f"cell{i}"],
            stats["mat"][f"cell{i}"], s0, s1, ops, train)
        return out

    stem = conv("stem0", fea)
    l3 = cell(0, None, stem)
    l3_1 = cell(1, stem, l3)
    l3_2 = cell(2, l3, l3_1)
    l6 = cell(3, l3_1, l3_2)
    l12 = cell(4, l3_2, l6)
    l6b = cell(5, l6, l12)
    l12_1 = cell(6, l12, l6b)
    l12_2 = cell(7, l6b, l12_1)

    h, w = fea.shape[1], fea.shape[2]
    x = conv("last_12", l12_2)
    x = resize_linear(x, (h // 2, w // 2), (1, 2), align_corners=True)
    x = conv("last_6", x)
    x = resize_linear(x, (h, w), (1, 2), align_corners=True)
    return conv("last_3", x)


def depth_supernet_forward(params, stats, image: torch.Tensor, fea_ops,
                           mat_ops, train: bool):
    """The depth search supernet: image (B,H,W,3) -> (depth (B,H,W) in
    [0, MAX_DEPTH], new_stats)."""
    new_stats: Dict[str, Any] = {"fea": {}, "mat": {}}
    with full_fp32():
        fea = _fea_forward(params, stats, image, fea_ops, train, new_stats)
        mat = _dmat_forward(params, stats, fea, mat_ops, train, new_stats)
        depth = depth_head(params["depth_head"], mat, fea.shape[1],
                           fea.shape[2], DEPTH_HEAD_SPEC, "b")
    return depth, new_stats
