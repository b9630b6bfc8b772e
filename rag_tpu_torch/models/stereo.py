"""The deployed stereo pipeline, serving form: Feature Net -> fused cost
volume + matching stem -> channel-first Matching Net -> fused soft-argmin
disparity head, every BatchNorm frozen.

Counterpart of rag_tpu/models/stereo.py::stereo_forward with
``cf_matching=True, fused_head=True`` and no BN-train sites. A *path* is a
dict site -> (spec, params, stats) over the 18 searchable sites plus the 3
per-task heads; ``stereo_forward`` is a function of (specs, params, stats,
inputs).

The three hand-written kernels run here: kernel B (ops.cvstem) for
``stem_3d0``, kernel A (ops.conv3d) for every 3x3x3 conv after it, and
kernel C (ops.disparity) for the head.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Union

import torch

from rag_tpu_torch.ops.cell import CellSpec, apply_cell, apply_cell_cf
from rag_tpu_torch.ops.convbr import ConvBRSpec, apply_convbr, bn_fold
from rag_tpu_torch.ops.convbr_cf import apply_convbr_cf
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.cvstem import cvstem_brc
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


def _apply2d(specs, params, stats, name, x, *extra):
    spec = specs[name]
    if isinstance(spec, CellSpec):
        return apply_cell(spec, params[name], stats[name], extra[0], x)
    return apply_convbr(spec, params[name], stats[name], x)


def extract_feature(specs, params, stats, image: torch.Tensor) -> torch.Tensor:
    """2D feature net: image (B,H,W,3) -> features (B,H/3,W/3,12)."""
    s = _apply2d(specs, params, stats, "stem_2d0", image)
    stem1 = _apply2d(specs, params, stats, "stem_2d1", s)
    stem2 = _apply2d(specs, params, stats, "stem_2d2", stem1)
    s_pp, s_p = stem1, stem2
    for i in range(4):
        out = _apply2d(specs, params, stats, f"cell_2d{i}", s_p, s_pp)
        s_pp, s_p = s_p, out
    return _apply2d(specs, params, stats, "last_3_2d", s_p)


def _std_stem(spec) -> bool:
    return (not isinstance(spec, CellSpec) and spec.kernel == 3
            and spec.stride == 1 and spec.bn and spec.relu)


def run_matching_cf(specs, params, stats, x: torch.Tensor, y: torch.Tensor,
                    num_disp: int) -> torch.Tensor:
    """Channel-first matching: NHWC features x, y (B,h,w,C) -> matching
    cost (B, num_disp, h, w)."""

    def appl(name, v, *extra):
        spec = specs[name]
        if isinstance(spec, CellSpec):
            return apply_cell_cf(spec, params[name], stats[name], extra[0], v)
        return apply_convbr_cf(spec, params[name], stats[name], v)

    spec0 = specs["stem_3d0"]
    if _std_stem(spec0):
        # cost volume + stem conv + folded frozen BN + ReLU in one kernel
        a, b = bn_fold(params["stem_3d0"], stats["stem_3d0"])
        stem0 = cvstem_brc(x.permute(0, 3, 1, 2).contiguous(),
                           y.permute(0, 3, 1, 2).contiguous(),
                           params["stem_3d0"]["w"], a, b, num_disp, True)
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
                   maxdisp: int = MAXDISP) -> torch.Tensor:
    """Serving forward. left/right: (B,H,W,3) NHWC float32 on one device.
    Returns disparity (B,H,W) in pixels."""
    with full_fp32():
        both = torch.cat([left, right], dim=0)
        f = extract_feature(specs, params, stats, both)
        bsz = left.shape[0]
        mat = run_matching_cf(specs, params, stats, f[:bsz], f[bsz:],
                              maxdisp // 3)
        return fused_soft_argmin(mat.contiguous(), maxdisp, 3)
