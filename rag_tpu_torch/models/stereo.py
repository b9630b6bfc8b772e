"""The stereo pipeline: Feature Net -> fused cost volume + matching stem
-> channel-first Matching Net -> fused soft-argmin disparity head.

Counterpart of rag_tpu/models/stereo.py::stereo_forward with
``cf_matching=True, fused_head=True``. A *path* is a dict site -> (spec,
params, stats) over the 18 searchable sites plus the 3 per-task heads;
``stereo_forward`` is a function of (specs, params, stats, inputs,
train_sites) and returns the disparity and the new BatchNorm statistics:
sites in ``train_sites`` run BatchNorm in train mode, every other site
normalizes with its frozen running statistics.

The hand-written kernels run here and in the backward: kernel B
(ops.cvstem, with E and F behind it) for ``stem_3d0``, kernel A
(ops.conv3d, with D) for every 3x3x3 conv after it, and kernel C
(ops.disparity, with G) for the head.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Union

import torch

from rag_tpu_torch.ops.cell import CellSpec, apply_cell, apply_cell_cf
from rag_tpu_torch.ops.convbr import ConvBRSpec, apply_convbr, bn_fold
from rag_tpu_torch.ops.convbr_cf import apply_convbr_cf, batch_norm_cf
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.cvstem import cvstem_brc, cvstem_conv
from rag_tpu_torch.ops.disparity import fused_soft_argmin
from rag_tpu_torch.ops.resize import resize_cf

MAXDISP = 192
FILTER_MULTIPLIER = 4
BLOCK_MULTIPLIER = 3
INITIAL_FM = FILTER_MULTIPLIER * BLOCK_MULTIPLIER  # 12
HALF_FM = INITIAL_FM // 2                          # 6

SITE_NAMES = (
    "stem_2d0", "stem_2d1", "stem_2d2",
    "cell_2d0", "cell_2d1", "cell_2d2", "cell_2d3",
    "last_3_2d",
    "stem_3d0", "stem_3d1",
    "cell_3d0", "cell_3d1", "cell_3d2", "cell_3d3",
    "cell_3d4", "cell_3d5", "cell_3d6", "cell_3d7",
)

HEAD_NAMES = ("last_3_3d", "last_6_3d", "last_12_3d")

# (c_pp, c_p, c_out, downup) per cell site
_CELL2D_PLAN = (
    (12, 12, 8, -1),
    (12, 24, 4, +1),
    (24, 12, 8, -1),
    (12, 24, 4, +1),
)
_CELL3D_PLAN = (
    (12, 12, 4, 0),
    (12, 12, 4, 0),
    (12, 12, 4, 0),
    (12, 12, 8, -1),
    (12, 24, 16, -1),
    (24, 48, 8, +1),
    (48, 24, 16, -1),
    (24, 48, 16, 0),
)

Spec = Union[ConvBRSpec, CellSpec]


def build_site_specs(genotype) -> Dict[str, Spec]:
    """Specs for one candidate unit per searchable site, from a genotype."""
    specs: Dict[str, Spec] = {
        "stem_2d0": ConvBRSpec(2, 3, HALF_FM, 3, 1),
        "stem_2d1": ConvBRSpec(2, HALF_FM, INITIAL_FM, 3, 3),
        "stem_2d2": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 3, 1),
        "last_3_2d": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 1, 1, bn=False, relu=False),
        "stem_3d0": ConvBRSpec(3, INITIAL_FM * 2, INITIAL_FM, 3, 1),
        "stem_3d1": ConvBRSpec(3, INITIAL_FM, INITIAL_FM, 3, 1),
    }
    for i, (cpp, cp, cout, downup) in enumerate(_CELL2D_PLAN):
        specs[f"cell_2d{i}"] = CellSpec(2, cpp, cp, cout, downup, genotype.normal)
    for i, (cpp, cp, cout, downup) in enumerate(_CELL3D_PLAN):
        specs[f"cell_3d{i}"] = CellSpec(3, cpp, cp, cout, downup, genotype.reduce)
    return specs


def build_head_specs() -> Dict[str, ConvBRSpec]:
    """Per-task matching-output heads."""
    return {
        "last_3_3d": ConvBRSpec(3, INITIAL_FM, 1, 3, 1, bn=False, relu=False),
        "last_6_3d": ConvBRSpec(3, INITIAL_FM * 2, INITIAL_FM, 1, 1),
        "last_12_3d": ConvBRSpec(3, INITIAL_FM * 4, INITIAL_FM * 2, 1, 1),
    }


def _apply2d(specs, params, stats, name, x, train_sites, new_stats, *extra,
             halves=1):
    spec = specs[name]
    train = name in train_sites
    if isinstance(spec, CellSpec):
        out, st = apply_cell(spec, params[name], stats[name], extra[0], x,
                             train, halves)
    else:
        out, st = apply_convbr(spec, params[name], stats[name], x, train,
                               halves)
    new_stats[name] = st
    return out


def extract_feature(specs, params, stats, image: torch.Tensor, train_sites,
                    new_stats, halves: int = 1) -> torch.Tensor:
    """2D feature net: image (B,H,W,3) -> features (B,H/3,W/3,12). New
    BatchNorm statistics land in ``new_stats`` (a dict, filled per site).

    halves=2: image is left+right stacked along the batch; train-mode
    BatchNorm takes per-half statistics and two EMA updates."""

    def appl(name, x, *extra):
        return _apply2d(specs, params, stats, name, x, train_sites, new_stats,
                        *extra, halves=halves)

    s = appl("stem_2d0", image)
    stem1 = appl("stem_2d1", s)
    stem2 = appl("stem_2d2", stem1)
    s_pp, s_p = stem1, stem2
    for i in range(4):
        out = appl(f"cell_2d{i}", s_p, s_pp)
        s_pp, s_p = s_p, out
    return appl("last_3_2d", s_p)


def _std_stem(spec) -> bool:
    return (not isinstance(spec, CellSpec) and spec.kernel == 3
            and spec.stride == 1 and spec.bn and spec.relu)


def run_matching_cf(specs, params, stats, x: torch.Tensor, y: torch.Tensor,
                    num_disp: int, train_sites, new_stats) -> torch.Tensor:
    """Channel-first matching: NHWC features x, y (B,h,w,C) -> matching
    cost (B, num_disp, h, w). New BatchNorm statistics land in
    ``new_stats``."""

    def appl(name, v, *extra):
        spec = specs[name]
        train = name in train_sites
        if isinstance(spec, CellSpec):
            out, st = apply_cell_cf(spec, params[name], stats[name], extra[0],
                                    v, train)
        else:
            out, st = apply_convbr_cf(spec, params[name], stats[name], v,
                                      train)
        new_stats[name] = st
        return out

    spec0 = specs["stem_3d0"]
    if _std_stem(spec0):
        x_cf = x.permute(0, 3, 1, 2).contiguous()
        y_cf = y.permute(0, 3, 1, 2).contiguous()
        p0, st0 = params["stem_3d0"], stats["stem_3d0"]
        if "stem_3d0" in train_sites:
            # kernel B at identity affine, then train-mode BatchNorm
            z = cvstem_conv(x_cf, y_cf, p0["w"], num_disp)
            stem0, new_stats["stem_3d0"] = batch_norm_cf(z, p0, st0, True)
            stem0 = torch.relu(stem0)
        else:
            # cost volume + stem conv + folded frozen BN + ReLU in one kernel
            a, b = bn_fold(p0, st0)
            stem0 = cvstem_brc(x_cf, y_cf, p0["w"], a, b, num_disp, True)
            new_stats["stem_3d0"] = st0
    else:
        stem0 = appl("stem_3d0", cost_volume_cf(x, y, num_disp))
    stem1 = appl("stem_3d1", stem0)
    s_pp, s_p = stem0, stem1
    for i in range(8):
        out = appl(f"cell_3d{i}", s_p, s_pp)
        s_pp, s_p = s_p, out

    d, h, w = stem0.shape[1], stem0.shape[3], stem0.shape[4]
    v = appl("last_12_3d", s_p)
    v = resize_cf(v, d // 2, h // 2, w // 2, True)
    v = appl("last_6_3d", v)
    v = resize_cf(v, d, h, w, True)
    mat = appl("last_3_3d", v)          # (B, D, 1, h, w)
    return mat[:, :, 0]


@contextlib.contextmanager
def full_fp32():
    """Keep cuDNN convs and matmuls in full fp32 (no TF32) for the scope:
    the port's numerics are the reference's fp32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def stereo_forward(specs: Mapping[str, Spec], params, stats,
                   left: torch.Tensor, right: torch.Tensor,
                   train_sites=frozenset(), maxdisp: int = MAXDISP):
    """Full pipeline. left/right: (B,H,W,3) NHWC float32 on one device.
    Returns (disp, new_stats): disparity (B,H,W) in pixels, and the stats
    tree after the train-mode BatchNorms of ``train_sites`` (every other
    site's stats carried through)."""
    new_stats: Dict = {}
    with full_fp32():
        both = torch.cat([left, right], dim=0)
        f = extract_feature(specs, params, stats, both, train_sites,
                            new_stats, halves=2)
        bsz = left.shape[0]
        mat = run_matching_cf(specs, params, stats, f[:bsz], f[bsz:],
                              maxdisp // 3, train_sites, new_stats)
        disp = fused_soft_argmin(mat.contiguous(), maxdisp, 3)
    for name in stats:
        new_stats.setdefault(name, stats[name])
    return disp, new_stats
