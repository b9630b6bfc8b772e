"""Channel-first (B, D, C, H, W) ConvBR and BatchNorm for the 3D matching
net.

Counterpart of rag_tpu/ops/convbr_cf.py. Parameter and stat trees are the
same as the channels-last blocks'. The 3x3x3 convs run through kernel A
(ops.conv3d): frozen BN folds into its affine; with BN in train mode the
kernel runs at identity affine and BatchNorm follows. The 1x1x1 convs are
channel contractions. Every block returns ``(y, new_stats)``.
"""

from __future__ import annotations

import torch

from rag_tpu_torch.ops.conv3d import conv3d_brc_cf
from rag_tpu_torch.ops.convbr import (
    BN_EPS,
    BN_MOMENTUM,
    ConvBRSpec,
    batch_stats,
    bn_fold,
    ema,
)


def batch_norm_cf(x: torch.Tensor, params, stats, train: bool = False,
                  momentum: float = BN_MOMENTUM):
    """BatchNorm on channel axis 2. Returns (y, new_stats)."""
    shape = (1, 1, -1, 1, 1)
    if train:
        mean, var, unbiased = batch_stats(x, (0, 1, 3, 4),
                                          x.numel() // x.shape[2])
        new_stats = ema(stats, mean, unbiased, momentum)
    else:
        mean, var, new_stats = stats["mean"], stats["var"], stats
    inv = torch.rsqrt(var + BN_EPS)
    y = ((x - mean.reshape(shape)) * (inv * params["scale"]).reshape(shape)
         + params["bias"].reshape(shape))
    return y, new_stats


def apply_convbr_cf(spec: ConvBRSpec, params, stats, x: torch.Tensor,
                    train: bool = False):
    """conv -> BN -> ReLU on a (B, D, C, H, W) volume. Returns
    (y, new_stats)."""
    assert spec.ndim == 3
    if spec.kernel == 3 and spec.stride == 1:
        if spec.bn and not train:
            a, b = bn_fold(params, stats)
            return conv3d_brc_cf(x.contiguous(), params["w"], a, b,
                                 spec.relu), stats
        ones = torch.ones(spec.cout, device=x.device)
        zeros = torch.zeros(spec.cout, device=x.device)
        if not spec.bn:
            return conv3d_brc_cf(x.contiguous(), params["w"], ones, zeros,
                                 spec.relu), stats
        y = conv3d_brc_cf(x.contiguous(), params["w"], ones, zeros, False)
    elif spec.kernel == 1 and spec.stride == 1:
        y = torch.einsum("bdihw,io->bdohw", x, params["w"][0, 0, 0])
    else:
        raise ValueError(f"no channel-first conv for {spec}")
    if spec.bn:
        y, stats = batch_norm_cf(y, params, stats, train)
    return (torch.relu(y) if spec.relu else y), stats
