"""Channel-first (B, D, C, H, W) ConvBR and frozen BatchNorm for the 3D
matching net.

Counterpart of rag_tpu/ops/convbr_cf.py. Parameter and stat trees are the
same as the channels-last blocks'. The 3x3x3 convs run through kernel A
(ops.conv3d) with frozen BN folded into its affine; the 1x1x1 convs are
channel contractions.
"""

from __future__ import annotations

import torch

from rag_tpu_torch.ops.conv3d import conv3d_brc_cf
from rag_tpu_torch.ops.convbr import BN_EPS, ConvBRSpec, bn_fold


def batch_norm_cf(x: torch.Tensor, params, stats) -> torch.Tensor:
    """Frozen BatchNorm on channel axis 2."""
    shape = (1, 1, -1, 1, 1)
    inv = torch.rsqrt(stats["var"] + BN_EPS)
    return ((x - stats["mean"].reshape(shape))
            * (inv * params["scale"]).reshape(shape)
            + params["bias"].reshape(shape))


def apply_convbr_cf(spec: ConvBRSpec, params, stats,
                    x: torch.Tensor) -> torch.Tensor:
    """conv -> frozen BN -> ReLU on a (B, D, C, H, W) volume."""
    assert spec.ndim == 3
    if spec.kernel == 3 and spec.stride == 1:
        if spec.bn:
            a, b = bn_fold(params, stats)
        else:
            a = torch.ones(spec.cout, device=x.device)
            b = torch.zeros(spec.cout, device=x.device)
        return conv3d_brc_cf(x.contiguous(), params["w"], a, b, spec.relu)
    if spec.kernel != 1 or spec.stride != 1:
        raise ValueError(f"no channel-first conv for {spec}")
    y = torch.einsum("bdihw,io->bdohw", x, params["w"][0, 0, 0])
    if spec.bn:
        y = batch_norm_cf(y, params, stats)
    return torch.relu(y) if spec.relu else y
