"""The metric arithmetic: a rate is all the work of the window over all
its time, and a tail is the percentile of every request in it."""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch


def rate(work: float, seconds: float) -> float:
    return work / seconds


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of all values, linear between the two nearest
    ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = 0.95 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def sixths(times: Sequence[float], start: float, seconds: float):
    """Items done (or issued) in each sixth of a window: how steady the
    rate was inside one run."""
    counts = [0] * 6
    for t in times:
        counts[min(int(6 * (t - start) / seconds), 5)] += 1
    return counts


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """cuDNN convs and matmuls in TF32 (``tf32``) or in full float32 for
    the scope."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
