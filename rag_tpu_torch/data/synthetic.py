"""Synthetic random-dot stereograms with exact ground-truth disparity.

Counterpart of rag_tpu/data/synthetic.py. The samples are made with numpy
by the same draws in the same order (texture, box filter, tiles, warp,
then the style's noise), so a seed and a style give the reference's bytes.
The right view is the left view warped by a known piecewise-constant
disparity field; ``WEATHER_STYLES`` shift the appearance of both views
(the synthetic analogue of the reference's four weather domains) without
changing the geometry.

A dataset uploads its samples to its device once and yields batches
gathered there. ``DeviceCache`` bounds the bytes that all sets hold on
their devices together: the least recently used sets are evicted (and
uploaded again when next touched), and a set that alone exceeds the budget
stays on the host and copies each batch to the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


# cloudy (clean), foggy, rainy, sunny: fog blends toward a gray veil,
# noise is per-view sensor speckle, brightness/contrast are shared affine
# shifts
WEATHER_STYLES = (
    {},
    {"fog": 0.45, "contrast": 0.75},
    {"noise": 0.25, "contrast": 0.9, "brightness": -0.1},
    {"brightness": 0.35, "contrast": 1.3},
)


def _apply_style(rng, left, right, style):
    c = float(style.get("contrast", 1.0))
    b = float(style.get("brightness", 0.0))
    fog = float(style.get("fog", 0.0))
    noise = float(style.get("noise", 0.0))
    out = []
    for img in (left, right):
        img = img * c + b
        if fog:
            img = img * (1.0 - fog) + fog * 0.5
        if noise:
            img = img + noise * rng.standard_normal(img.shape).astype(
                np.float32)
        out.append(img.astype(np.float32))
    return out


def synthetic_stereo_batch(rng: np.random.Generator, batch: int, h: int,
                           w: int, max_disp: float = 48.0,
                           style: Optional[Dict] = None
                           ) -> Dict[str, np.ndarray]:
    """NHWC left/right and (B,H,W) disparity, float32 numpy arrays.

    left[j] == right[j - d]: a smooth random texture, a blocky disparity
    field in [4, max_disp] (0 where the match falls outside the image),
    and ``style`` applied to both views after the warp."""
    # "same" box filter of width 7 along H then W, through cumsums
    tex = rng.standard_normal((batch, h, w, 3)).astype(np.float32)
    k = 7
    for ax in (1, 2):
        lo, hi = k // 2, k - k // 2
        pad = [(0, 0)] * 4
        pad[ax] = (lo + 1, hi)
        n = tex.shape[ax]
        c = np.cumsum(np.pad(tex, pad), axis=ax, dtype=np.float32)
        top = c.take(range(k, k + n), axis=ax)
        bot = c.take(range(0, n), axis=ax)
        tex = (top - bot) / k
    tex /= tex.std() + 1e-6

    th, tw = max(h // 4, 1), max(w // 4, 1)
    tiles = rng.uniform(4.0, max_disp,
                        (batch, (h + th - 1) // th, (w + tw - 1) // tw))
    disp = np.repeat(np.repeat(tiles, th, 1), tw, 2)[:, :h, :w].astype(
        np.float32)

    # right[j] = left[j + d], linearly interpolated
    j = np.arange(w, dtype=np.float32)[None, None, :]
    src = j + disp
    j0 = np.clip(np.floor(src).astype(np.int64), 0, w - 1)
    j1 = np.clip(j0 + 1, 0, w - 1)
    frac = (src - np.floor(src)).astype(np.float32)[..., None]
    bi = np.arange(batch)[:, None, None]
    hi = np.arange(h)[None, :, None]
    right = tex[bi, hi, j0] * (1 - frac) + tex[bi, hi, j1] * frac
    valid = (src <= w - 1)
    disp = np.where(valid, disp, 0.0).astype(np.float32)
    right = right.astype(np.float32)
    if style:
        tex, right = _apply_style(rng, tex, right, style)
    return {"left": tex, "right": right, "disparity": disp}


class DeviceCache:
    """Device-resident sample sets under one byte budget, least recently
    used first out. Sets of every device count against the budget."""

    def __init__(self, budget_bytes: int = 6144 * 2**20):
        self.budget_bytes = budget_bytes
        self.nbytes = 0
        self.lru: List["SyntheticStereoDataset"] = []

    def _evict(self, ds) -> None:
        self.nbytes -= ds._dev_bytes
        ds._dev = None
        ds._dev_bytes = 0

    def fetch(self, ds) -> Optional[Dict[str, torch.Tensor]]:
        """ds's samples on ds.device, uploaded on first use; None when the
        set alone exceeds the budget (its batches then go from the host)."""
        if ds._dev is not None:
            self.lru.remove(ds)
            self.lru.append(ds)
            return ds._dev
        samples = ds._samples()
        nbytes = sum(v.nbytes for v in samples.values())
        while (self.nbytes + nbytes > self.budget_bytes and self.lru):
            victim = self.lru.pop(0)
            print(f"[data] device cache budget: evicting a "
                  f"{victim._dev_bytes / 2**20:.0f} MB sample set (LRU) to "
                  f"fit {nbytes / 2**20:.0f} MB")
            self._evict(victim)
        if nbytes > self.budget_bytes:
            print(f"[data] dataset ({nbytes / 2**20:.0f} MB) exceeds the "
                  f"device cache budget ({self.budget_bytes / 2**20:.0f} "
                  f"MB); its batches are copied to {ds.device} one by one")
            return None
        ds._dev = {k: torch.from_numpy(v).to(ds.device)
                   for k, v in samples.items()}
        ds._dev_bytes = nbytes
        self.nbytes += nbytes
        self.lru.append(ds)
        return ds._dev


DEVICE_CACHE = DeviceCache()


class SyntheticStereoDataset:
    """A fixed, seeded set of ``num_samples`` synthetic pairs with the
    ``batches`` interface of the reference's datasets, yielding tensors on
    ``device``.

    The samples are made once (lazily, from ``seed``) and every epoch
    revisits them in shuffled order: the reference protocol trains
    repeatedly on a fixed image set per scene. ``cache`` holds the set on
    its device (default: the process-wide ``DEVICE_CACHE``)."""

    def __init__(self, num_samples: int, h: int, w: int, seed: int = 0,
                 max_disp: float = 48.0, style: Optional[Dict] = None,
                 device="cuda", cache: Optional[DeviceCache] = None):
        self.num_samples = num_samples
        self.h, self.w = h, w
        self.seed = seed
        self.max_disp = max_disp
        self.style = style
        self.device = torch.device(device)
        self.cache = DEVICE_CACHE if cache is None else cache
        self._cache = None
        self._dev = None
        self._dev_bytes = 0

    def __len__(self):
        return self.num_samples

    def _samples(self) -> Dict[str, np.ndarray]:
        """The host samples as numpy arrays, made on first use."""
        if self._cache is None:
            rng = np.random.default_rng(self.seed)
            # chunks of 16 bound the warp's working set
            chunks = []
            left, n = 0, self.num_samples
            while left < n:
                m = min(16, n - left)
                chunks.append(synthetic_stereo_batch(
                    rng, m, self.h, self.w, self.max_disp, style=self.style))
                left += m
            self._cache = {k: np.concatenate([c[k] for c in chunks])
                           for k in chunks[0]}
        return self._cache

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                indices=None, drop_last: bool = True
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Dicts of left/right (B,H,W,3) and disparity (B,H,W) tensors on
        the dataset's device, in the reference's order: ``indices`` (default
        all), permuted by ``default_rng(self.seed + seed)`` if shuffle."""
        data = self.cache.fetch(self)
        idx = np.asarray(indices if indices is not None
                         else np.arange(self.num_samples))
        if shuffle:
            idx = np.random.default_rng(self.seed + seed).permutation(idx)
        n = len(idx)
        stop = n - (n % batch_size) if drop_last else n
        if data is None:
            host = self._samples()
            for i in range(0, stop, batch_size):
                sel = idx[i:i + batch_size]
                yield {k: torch.from_numpy(v[sel]).to(self.device)
                       for k, v in host.items()}
            return
        idx_dev = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        for i in range(0, stop, batch_size):
            sel = idx_dev[i:i + batch_size]
            yield {k: v[sel] for k, v in data.items()}
