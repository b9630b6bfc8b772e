"""Channel-first (B, D, C, H, W) ConvBR and BatchNorm for the 3D matching
net.

Counterpart of rag_tpu/ops/convbr_cf.py. Parameter and stat trees are the
same as the channels-last blocks'. The 3x3x3 convs run through kernel A
(ops.conv3d): frozen BN folds into its affine; with BN in train mode the
kernel runs at identity affine and BatchNorm follows. The 1x1x1 convs are
channel contractions. Every block returns ``(y, new_stats)``.

The 3x3x3 conv runs through ``vol`` (``ops.volume``): ``WHOLE`` by
default, or the spatial path's slab of the volume; the 1x1x1 convs and
BatchNorm read their own rows only (train-mode statistics reduce over
the caller's ``bn_collective`` group).
"""

from __future__ import annotations

import torch

from rag_tpu_torch.ops.convbr import (
    BN_EPS,
    BN_MOMENTUM,
    ConvBRSpec,
    batch_stats,
    bn_fold,
    ema,
)
from rag_tpu_torch.ops.precision import wide
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.ops.volume import WHOLE


def batch_norm_cf(x: torch.Tensor, params, stats, train: bool = False,
                  momentum: float = BN_MOMENTUM):
    """BatchNorm on channel axis 2. Returns (y, new_stats). Statistics and
    the normalization in float32; y in x's dtype."""
    out_dtype, x = x.dtype, wide(x)
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
    return y.to(out_dtype), new_stats


def apply_convbr_cf(spec: ConvBRSpec, params, stats, x: torch.Tensor,
                    train: bool = False, variants: KernelVariants = DEFAULT,
                    vol=WHOLE):
    """conv -> BN -> ReLU on a (B, D, C, H, W) volume (``vol``'s rows of
    it). Returns (y, new_stats). ``variants`` picks the 3x3x3 conv's
    kernel."""
    assert spec.ndim == 3
    if spec.kernel == 3 and spec.stride == 1:
        def conv(a, b, relu):
            return vol.conv(x, params["w"], a, b, relu, variants)

        if spec.bn and not train:
            return conv(*bn_fold(params, stats), spec.relu), stats
        ones = torch.ones(spec.cout, device=x.device,
                          dtype=params["w"].dtype)
        zeros = torch.zeros(spec.cout, device=x.device,
                            dtype=params["w"].dtype)
        if not spec.bn:
            return conv(ones, zeros, spec.relu), stats
        y = conv(ones, zeros, False)
    elif spec.kernel == 1 and spec.stride == 1:
        y = torch.einsum("bdihw,io->bdohw", x,
                         params["w"][0, 0, 0].to(x.dtype))
    else:
        raise ValueError(f"no channel-first conv for {spec}")
    if spec.bn:
        y, stats = batch_norm_cf(y, params, stats, train)
    return (torch.relu(y) if spec.relu else y), stats
