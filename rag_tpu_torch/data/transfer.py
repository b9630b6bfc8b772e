"""Colour-statistics transfer for the self-supervised op search's proxy
data (counterpart of rag_tpu/data/transfer.py).

Synthetic proxy pairs are colour-matched to real left frames of the
current scene before the op search trains and scores on them: each
channel's mean and standard deviation over H, W of the synthetic image
are mapped onto the real image's. The transfer is on raw [0, 1] images:
the datasets yield ImageNet-normalized batches, so ``ColorTransferDataset``
de-normalizes, transfers and clips to [0, 1], and normalizes again.

The arithmetic is rag_tpu's, in numpy on the host: the population
standard deviation, 1e-8 added to the target's alone, so that a batch
equals rag_tpu's bit for bit. Batches arrive as tensors on the proxy
dataset's device and leave as tensors there.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from rag_tpu_torch.data.readers import denormalize_imagenet, normalize_imagenet


def transfer_color(target: np.ndarray, source: np.ndarray) -> np.ndarray:
    """Match the per-channel mean and std of ``target`` to ``source``:
    [0, 1] float HWC (or NHWC, statistics per image over H, W). Subtract
    the target mean, divide by target_std / source_std, add the source
    mean, clip to [0, 1]."""
    axes = tuple(range(target.ndim - 1))[-2:]  # (H, W) axes
    t_mean = target.mean(axis=axes, keepdims=True)
    t_std = target.std(axis=axes, keepdims=True) + 1e-8
    s_mean = source.mean(axis=axes, keepdims=True)
    s_std = source.std(axis=axes, keepdims=True)
    out = (target - t_mean) / (t_std / np.maximum(s_std, 1e-8)) + s_mean
    return np.clip(out, 0.0, 1.0)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class ColorTransferDataset:
    """A proxy dataset whose every batch is colour-matched to a pool of
    real frames (the current task's left images), cycled in order:
    sample i of the stream takes pool frame i % len(pool).

    normalized=True: proxy batches and the pool hold ImageNet-normalized
    values (the datasets' output); else raw [0, 1]."""

    def __init__(self, proxy_dataset, real_images, normalized: bool = True):
        """real_images: (N,H,W,3), numpy or a tensor on any device."""
        self.proxy = proxy_dataset
        self.normalized = normalized
        real = _host(real_images)
        self.real = denormalize_imagenet(real) if normalized else real

    def __len__(self):
        return len(self.proxy)

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                indices=None, drop_last: bool = True
                ) -> Iterator[Dict[str, torch.Tensor]]:
        cursor = 0
        for b in self.proxy.batches(batch_size, shuffle, seed, indices,
                                    drop_last):
            n = b["left"].shape[0]
            pick = (cursor + np.arange(n)) % len(self.real)
            cursor += n
            ref = self.real[pick]
            out = dict(b)
            for k in ("left", "right"):
                host = _host(b[k])
                img = denormalize_imagenet(host) if self.normalized else host
                moved = np.stack([transfer_color(img[i], ref[i])
                                  for i in range(n)])
                moved = (normalize_imagenet(moved) if self.normalized
                         else moved).astype(np.float32)
                out[k] = torch.from_numpy(moved).to(b[k].device)
            yield out
