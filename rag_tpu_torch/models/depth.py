"""The monocular-depth variant: the stereo pipeline without the right
image and the cost volume, its matching half rewired to 2D convs at the
same channel plan, and a depth head.

Counterpart of rag_tpu/models/depth.py. The 18 searchable sites and the 3
per-task heads are the stereo variant's, so growth and search are shared;
only the spec builders and the forward differ: ``stem_3d0`` and
``stem_3d1`` are 2D 12 -> 12 ConvBRs, the matching cells 2D cells driven
by the genotype's ``reduce`` gene, and the heads 2D. The depth head is
one unit shared by every task: a 3x3 conv 1 -> 1 plus a bias leaf
``bias1``, a sigmoid, a x3 bilinear upsample (align_corners=False) and
x MAX_DEPTH.

Every op here is a cuDNN 2D conv, a BatchNorm or a matrix resize, as the
reference's are XLA: the depth path runs no hand-written kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from rag_tpu_torch.models.stereo import (
    _CELL2D_PLAN,
    _CELL3D_PLAN,
    HALF_FM,
    INITIAL_FM,
    _apply2d,
    extract_feature,
    full_fp32,
)
from rag_tpu_torch.ops.cell import CellSpec
from rag_tpu_torch.ops.convbr import ConvBRSpec, conv2d_nhwc, init_convbr
from rag_tpu_torch.ops.precision import FP32, Precision
from rag_tpu_torch.ops.resize import resize_linear

MAX_DEPTH = 80.0


def build_depth_site_specs(genotype) -> Dict[str, Any]:
    """Per-site specs; the matching half is 2D at the stereo channel plan."""
    specs: Dict[str, Any] = {
        "stem_2d0": ConvBRSpec(2, 3, HALF_FM, 3, 1),
        "stem_2d1": ConvBRSpec(2, HALF_FM, INITIAL_FM, 3, 3),
        "stem_2d2": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 3, 1),
        "last_3_2d": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 1, 1, bn=False,
                                relu=False),
        "stem_3d0": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 3, 1),
        "stem_3d1": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 3, 1),
    }
    for i, (cpp, cp, cout, downup) in enumerate(_CELL2D_PLAN):
        specs[f"cell_2d{i}"] = CellSpec(2, cpp, cp, cout, downup,
                                        genotype.normal)
    for i, (cpp, cp, cout, downup) in enumerate(_CELL3D_PLAN):
        specs[f"cell_3d{i}"] = CellSpec(2, cpp, cp, cout, downup,
                                        genotype.reduce)
    return specs


def build_depth_head_specs() -> Dict[str, ConvBRSpec]:
    return {
        "last_3_3d": ConvBRSpec(2, INITIAL_FM, 1, 3, 1, bn=False, relu=False),
        "last_6_3d": ConvBRSpec(2, INITIAL_FM * 2, INITIAL_FM, 1, 1),
        "last_12_3d": ConvBRSpec(2, INITIAL_FM * 4, INITIAL_FM * 2, 1, 1),
    }


DEPTH_HEAD_SPEC = ConvBRSpec(2, 1, 1, 3, 1, bn=False, relu=False)


def init_depth_head(generator: torch.Generator, device="cuda"):
    """Fresh (params, stats) of the depth head: the conv's 'w' and a zero
    'bias1'; no statistics."""
    params, stats = init_convbr(generator, DEPTH_HEAD_SPEC, device)
    params["bias1"] = torch.zeros(1, device=device)
    return params, stats


def depth_head(hp, mat: torch.Tensor, h: int, w: int, conv_spec,
               bias: str) -> torch.Tensor:
    """conv 3x3 + bias -> sigmoid -> x3 bilinear -> x MAX_DEPTH: mat
    (B,h,w,1) -> depth (B,3h,3w). In float32 (float64 where mat is)."""
    mat = mat.to(torch.promote_types(mat.dtype, torch.float32))
    y = conv2d_nhwc(mat, hp["w"], conv_spec) + hp[bias]
    y = torch.sigmoid(y)
    y = resize_linear(y, (h * 3, w * 3), (1, 2), align_corners=False)
    return y[..., 0] * MAX_DEPTH


def depth_forward(specs: Mapping, params, stats, image: torch.Tensor,
                  train_sites=frozenset(), precision: Precision = FP32):
    """image (B,H,W,3) -> (depth (B,H,W) in [0, MAX_DEPTH], new_stats):
    sites in ``train_sites`` run BatchNorm in train mode, every other site
    normalizes with its running statistics. ``precision``: the net's
    activations ride its feature dtype from the feature net on, as in
    rag_tpu; the head upcasts to float32."""
    new_stats: Dict[str, Any] = {}

    def appl(name, x, *extra):
        return _apply2d(specs, params, stats, name, x, train_sites,
                        new_stats, *extra)

    with full_fp32():
        fea = extract_feature(specs, params, stats, image, train_sites,
                              new_stats, precision=precision)
        stem0 = appl("stem_3d0", fea)
        stem1 = appl("stem_3d1", stem0)
        s_pp, s_p = stem0, stem1
        for i in range(8):
            out = appl(f"cell_3d{i}", s_p, s_pp)
            s_pp, s_p = s_p, out

        h, w = fea.shape[1], fea.shape[2]
        x = appl("last_12_3d", s_p)
        x = resize_linear(x, (h // 2, w // 2), (1, 2), align_corners=True)
        x = appl("last_6_3d", x)
        x = resize_linear(x, (h, w), (1, 2), align_corners=True)
        mat = appl("last_3_3d", x)  # (B, h, w, 1)
        depth = depth_head(params["depth_head"], mat, h, w, DEPTH_HEAD_SPEC,
                           "bias1")
    new_stats.setdefault("depth_head", stats.get("depth_head", {}))
    for name in stats:
        new_stats.setdefault(name, stats[name])
    return depth, new_stats
