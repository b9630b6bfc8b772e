"""Conv + BatchNorm + ReLU blocks (2D, channels-last).

Counterpart of rag_tpu/ops/convbr.py. Parameter trees are the reference's:

  * params: {'w': (*k, cin, cout), 'scale': (cout,), 'bias': (cout,)}
  * stats:  {'mean': (cout,), 'var': (cout,)}

Images and feature maps are NHWC, as in the reference. Every block returns
``(y, new_stats)``. Frozen BatchNorm normalizes with the running statistics
and returns them unchanged; train-mode BatchNorm normalizes with the batch
statistics and returns the running statistics after the EMA update
(torch BatchNorm semantics, momentum 0.1, written out because the
reference's variance, ``E[x^2] - mean^2``, and its per-half statistics of
the stacked left+right batch are not what ``torch.nn.BatchNorm`` does).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


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


def batch_stats(x: torch.Tensor, dims, n: int):
    """Biased batch mean and variance over ``dims`` as the reference takes
    them (``E[x^2] - mean^2`` in float32), and the unbiased variance
    ``var * n/(n-1)`` for the running update."""
    mean = x.mean(dim=dims)
    var = (x * x).mean(dim=dims) - mean * mean
    return mean, var, var.detach() * (n / max(n - 1, 1))


def ema(stats, mean, unbiased, momentum: float):
    """One running-statistics update (no gradient flows into stats)."""
    return {"mean": (1 - momentum) * stats["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * stats["var"] + momentum * unbiased}


def batch_norm(x: torch.Tensor, params, stats, train: bool = False,
               momentum: float = BN_MOMENTUM, halves: int = 1):
    """Channels-last BatchNorm. Returns (y, new_stats).

    halves > 1 (train mode only): the batch axis stacks ``halves``
    independent passes (left and right feature extraction as one batch);
    each half normalizes by its own batch statistics and the running stats
    take ``halves`` EMA updates in stacking order."""
    c = x.shape[-1]
    if train and halves > 1:
        xh = x.reshape((halves, x.shape[0] // halves) + tuple(x.shape[1:]))
        dims = tuple(range(1, xh.ndim - 1))
        mean, var, unbiased = batch_stats(xh, dims, x.numel() // (halves * c))
        new_stats = stats
        for i in range(halves):
            new_stats = ema(new_stats, mean[i], unbiased[i], momentum)
        bshape = (halves,) + (1,) * (xh.ndim - 2) + (c,)
        inv = torch.rsqrt(var + BN_EPS).reshape(bshape)
        y = (xh - mean.reshape(bshape)) * (inv * params["scale"]) + params["bias"]
        return y.reshape(x.shape), new_stats
    if train:
        mean, var, unbiased = batch_stats(x, tuple(range(x.ndim - 1)),
                                          x.numel() // c)
        new_stats = ema(stats, mean, unbiased, momentum)
    else:
        mean, var, new_stats = stats["mean"], stats["var"], stats
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean) * (inv * params["scale"]) + params["bias"], new_stats


def apply_convbr(spec: ConvBRSpec, params, stats, x: torch.Tensor,
                 train: bool = False, halves: int = 1):
    """conv -> BN -> ReLU on an NHWC map. Returns (y, new_stats)."""
    assert spec.ndim == 2, "3D blocks run channel-first: ops.convbr_cf"
    y = conv2d_nhwc(x, params["w"], spec)
    if spec.bn:
        y, stats = batch_norm(y, params, stats, train, halves=halves)
    if spec.relu:
        y = torch.relu(y)
    return y, stats
