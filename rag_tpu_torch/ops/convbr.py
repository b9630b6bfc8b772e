"""Conv + BatchNorm + ReLU blocks (2D, channels-last), frozen BatchNorm.

Counterpart of rag_tpu/ops/convbr.py. Parameter trees are the reference's:

  * params: {'w': (*k, cin, cout), 'scale': (cout,), 'bias': (cout,)}
  * stats:  {'mean': (cout,), 'var': (cout,)}

Images and feature maps are NHWC, as in the reference. BatchNorm normalizes
with its running statistics (the serving path freezes every BN); train-mode
BatchNorm, with per-half batch statistics for the stacked left+right batch,
arrives with the training path.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ConvBRSpec:
    """Static description of a ConvBR block."""

    ndim: int  # 2 or 3 spatial dims
    cin: int
    cout: int
    kernel: int
    stride: int = 1
    bn: bool = True
    relu: bool = True

    @property
    def padding(self) -> int:
        # kernel//2: 1 for the 3x3 convs (the stride-3 stem included), 0 for 1x1
        return self.kernel // 2


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, spec: ConvBRSpec) -> torch.Tensor:
    """Zero-padded 2D conv: x (B,H,W,Cin), w (kh,kw,Cin,Cout) -> (B,H',W',Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=spec.stride, padding=spec.padding)
    return y.permute(0, 2, 3, 1)


def bn_fold(params, stats):
    """Frozen BatchNorm as a per-channel affine: (scale*rsqrt(var+eps),
    bias - mean*scale*rsqrt(var+eps))."""
    a = params["scale"] * torch.rsqrt(stats["var"] + BN_EPS)
    return a, params["bias"] - stats["mean"] * a


def batch_norm(x: torch.Tensor, params, stats) -> torch.Tensor:
    """Channels-last frozen BatchNorm (running statistics)."""
    inv = torch.rsqrt(stats["var"] + BN_EPS)
    return (x - stats["mean"]) * (inv * params["scale"]) + params["bias"]


def apply_convbr(spec: ConvBRSpec, params, stats, x: torch.Tensor) -> torch.Tensor:
    """conv -> frozen BN -> ReLU on an NHWC map."""
    assert spec.ndim == 2, "3D blocks run channel-first: ops.convbr_cf"
    y = conv2d_nhwc(x, params["w"], spec)
    if spec.bn:
        y = batch_norm(y, params, stats)
    if spec.relu:
        y = torch.relu(y)
    return y
