"""Analytic FLOPs and bytes of the stereo pipeline's stages.

Counterpart of rag_tpu/utils/flops.py, with the same arithmetic: every
stage priced from the channel plans, so that a measured time can be set
against the card's peaks.

Conventions: 1 MAC = 2 FLOPs; BN+ReLU and elementwise ops are costed as
bytes (they are bandwidth-, not FLOPs-bound); f32 = 4 bytes unless a dtype
size is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

# NVIDIA H100 80GB HBM3 (SXM, 700 W power limit), NVIDIA's data sheet:
# dense float32 outside the tensor cores, and HBM3 bandwidth
H100_PEAK_FP32_FLOPS = 67e12
H100_PEAK_HBM_BPS = 3.35e12


@dataclasses.dataclass
class StageCost:
    name: str
    flops: float          # matmul/conv FLOPs (2*MACs)
    bytes_moved: float    # minimal activation+weight traffic, bytes

    def mfu(self, seconds: float, peak=H100_PEAK_FP32_FLOPS) -> float:
        return self.flops / max(seconds, 1e-12) / peak

    def bw_util(self, seconds: float, peak=H100_PEAK_HBM_BPS) -> float:
        return self.bytes_moved / max(seconds, 1e-12) / peak


def _conv2d(b, h, w, cin, cout, k, stride=1, dsize=4):
    ho, wo = h // stride, w // stride
    flops = 2.0 * b * ho * wo * cout * cin * k * k
    bytes_moved = dsize * (b * h * w * cin + b * ho * wo * cout
                           + cin * cout * k * k)
    return flops, bytes_moved, ho, wo


def _conv3d(b, d, h, w, cin, cout, k, dsize=4):
    flops = 2.0 * b * d * h * w * cout * cin * k ** 3
    bytes_moved = dsize * (b * d * h * w * (cin + cout)
                           + cin * cout * k ** 3)
    return flops, bytes_moved


def _cell2d(b, h, w, cpp, cp, cout, downup, num_conv_edges=6, dsize=4):
    """Genotype cell: 2 preprocess 1x1 convs + up to 6 3x3 conv edges at
    the cell's working scale + concat (3*cout channels out). downup
    -1 = stride-2 down, +1 = 2x up."""
    scale = 0.5 if downup < 0 else (2.0 if downup > 0 else 1.0)
    hh, ww = int(h * scale), int(w * scale)
    flops = bytes_moved = 0.0
    for cin in (cpp, cp):  # preprocess to cout at the new scale
        f, m, _, _ = _conv2d(b, hh, ww, cin, cout, 1, 1, dsize)
        flops += f
        bytes_moved += m
    for _ in range(num_conv_edges):
        f, m, _, _ = _conv2d(b, hh, ww, cout, cout, 3, 1, dsize)
        flops += f
        bytes_moved += m
    return flops, bytes_moved, hh, ww


def _cell3d(b, d, h, w, cpp, cp, cout, downup, num_conv_edges=6, dsize=4):
    scale = 0.5 if downup < 0 else (2.0 if downup > 0 else 1.0)
    dd, hh, ww = int(d * scale), int(h * scale), int(w * scale)
    flops = bytes_moved = 0.0
    for cin in (cpp, cp):
        f, m = _conv3d(b, dd, hh, ww, cin, cout, 1, dsize)
        flops += f
        bytes_moved += m
    for _ in range(num_conv_edges):
        f, m = _conv3d(b, dd, hh, ww, cout, cout, 3, dsize)
        flops += f
        bytes_moved += m
    return flops, bytes_moved, dd, hh, ww


def pipeline_costs(b: int, h: int, w: int, maxdisp: int = 192,
                   dsize: int = 4) -> List[StageCost]:
    """Forward-pass cost per stage at input (b, h, w, 3)."""
    from rag_tpu_torch.models.stereo import (
        _CELL2D_PLAN,
        _CELL3D_PLAN,
        HALF_FM,
        INITIAL_FM,
    )

    stages: List[StageCost] = []

    # -- feature net x2 (left + right), stems at strides 1,3,1 ------------
    f = m = 0.0
    ff, mm, _, _ = _conv2d(b, h, w, 3, HALF_FM, 3, 1, dsize)
    f, m = f + ff, m + mm
    ff, mm, h3, w3 = _conv2d(b, h, w, HALF_FM, INITIAL_FM, 3, 3, dsize)
    f, m = f + ff, m + mm
    ff, mm, _, _ = _conv2d(b, h3, w3, INITIAL_FM, INITIAL_FM, 3, 1, dsize)
    f, m = f + ff, m + mm
    hh, ww = h3, w3
    for (cpp, cp, cout, downup) in _CELL2D_PLAN:
        ff, mm, hh, ww = _cell2d(b, hh, ww, cpp, cp, cout, downup,
                                 dsize=dsize)
        f, m = f + ff, m + mm
    ff, mm, _, _ = _conv2d(b, h3, w3, INITIAL_FM, INITIAL_FM, 1, 1, dsize)
    f, m = f + ff, m + mm
    stages.append(StageCost("feature_net_x2", 2 * f, 2 * m))

    # -- cost volume (pure data movement) ---------------------------------
    d = maxdisp // 3
    vol_bytes = dsize * b * d * h3 * w3 * 2 * INITIAL_FM
    stages.append(StageCost("cost_volume", 0.0,
                            2 * dsize * b * h3 * w3 * INITIAL_FM + vol_bytes))

    # -- matching net ------------------------------------------------------
    f = m = 0.0
    ff, mm = _conv3d(b, d, h3, w3, 2 * INITIAL_FM, INITIAL_FM, 3, dsize)
    f, m = f + ff, m + mm
    ff, mm = _conv3d(b, d, h3, w3, INITIAL_FM, INITIAL_FM, 3, dsize)
    f, m = f + ff, m + mm
    dd, hh, ww = d, h3, w3
    for (cpp, cp, cout, downup) in _CELL3D_PLAN:
        ff, mm, dd, hh, ww = _cell3d(b, dd, hh, ww, cpp, cp, cout, downup,
                                     dsize=dsize)
        f, m = f + ff, m + mm
    # head cascade: last_12 (1x1, 48->24 at 1/4), upx2, last_6 (1x1,
    # 24->12 at 1/2), up, last_3 (3x3, 12->1 at full volume res)
    ff, mm = _conv3d(b, d // 4, h3 // 4, w3 // 4, 4 * INITIAL_FM,
                     2 * INITIAL_FM, 1, dsize)
    f, m = f + ff, m + mm
    ff, mm = _conv3d(b, d // 2, h3 // 2, w3 // 2, 2 * INITIAL_FM,
                     INITIAL_FM, 1, dsize)
    f, m = f + ff, m + mm
    ff, mm = _conv3d(b, d, h3, w3, INITIAL_FM, 1, 3, dsize)
    f, m = f + ff, m + mm
    stages.append(StageCost("matching_net", f, m))

    # -- disparity head: trilinear upsample to (maxdisp, h, w) + softmin +
    #    expectation — bandwidth-dominated
    up_bytes = dsize * b * maxdisp * h * w
    stages.append(StageCost(
        "disparity_head",
        2.0 * b * h * w * maxdisp * 3,  # interp matmuls + expectation
        dsize * b * d * h3 * w3 + 2 * up_bytes))

    return stages


def total(stages: List[StageCost]) -> StageCost:
    return StageCost("total_forward",
                     sum(s.flops for s in stages),
                     sum(s.bytes_moved for s in stages))


def summarize(stages: List[StageCost], seconds_per_stage: Dict[str, float],
              peak_flops=H100_PEAK_FP32_FLOPS,
              peak_bw=H100_PEAK_HBM_BPS) -> List[Dict]:
    rows = []
    for s in stages:
        sec = seconds_per_stage.get(s.name)
        row = {"stage": s.name, "gflops": s.flops / 1e9,
               "mbytes": s.bytes_moved / 1e6}
        if sec is not None:
            row.update({
                "ms": 1e3 * sec,
                "mfu_pct": 100 * s.mfu(sec, peak_flops),
                "hbm_pct": 100 * s.bw_util(sec, peak_bw),
            })
        rows.append(row)
    return rows
