"""Filename-list monocular-depth dataset (counterpart of
rag_tpu/data/depth_dataset.py).

A list holds the stereo layout ("left right depth", the depth map a PNG
/256 or a PFM) or "image depth" lines; the model reads the first image
and the last column's depth. Training takes random 768x384 (w, h) crops,
``x1`` then ``y1`` drawn from the batch's generator; evaluation zero-pads
top and right to 960x480. Samples are read on the host exactly as
rag_tpu reads them; ``batches`` yields dicts of float32 tensors on the
dataset's ``device``: image (B,H,W,3) and depth (B,H,W).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from rag_tpu_torch.data.readers import (
    normalize_imagenet,
    read_image,
    read_pfm,
    read_png_disparity,
)
from rag_tpu_torch.data.stereo_dataset import EVAL_PAD, load_file_list

DEPTH_TRAIN_CROP = (768, 384)  # (w, h)


class DepthDataset:
    """One scene split of (image, depth) pairs. training=True: random
    crops; else padded full frames (batch 1, as the reference evaluates)."""

    def __init__(self, list_file: str, training: bool,
                 crop=DEPTH_TRAIN_CROP, pad=EVAL_PAD, root: str = "",
                 device="cuda"):
        self.entries = load_file_list(list_file)
        if not all(len(e) >= 2 for e in self.entries):
            raise ValueError(f"depth lists need 'image [right] depth' "
                             f"columns: {list_file}")
        self.training = training
        self.crop = crop
        self.pad = pad
        self.root = root
        self.device = torch.device(device)

    def __len__(self):
        return len(self.entries)

    def _path(self, p: str) -> str:
        return os.path.join(self.root, p) if self.root else p

    @staticmethod
    def _load_depth(path: str) -> np.ndarray:
        if path.endswith(".pfm"):
            return read_pfm(path)[0]
        return read_png_disparity(path)  # PNG / 256, as disparity is

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        """One sample as host numpy arrays (HWC image, HW depth)."""
        entry = self.entries[index]
        image = normalize_imagenet(read_image(self._path(entry[0])))
        depth = self._load_depth(self._path(entry[-1]))
        h, w = depth.shape

        if self.training:
            cw, ch = self.crop
            rng = rng or np.random.default_rng()
            x1 = int(rng.integers(0, max(w - cw, 0) + 1))
            y1 = int(rng.integers(0, max(h - ch, 0) + 1))
            return {"image": image[y1:y1 + ch, x1:x1 + cw],
                    "depth": depth[y1:y1 + ch, x1:x1 + cw]}

        pw, ph = self.pad
        top, rightp = ph - h, pw - w
        if top < 0 or rightp < 0:
            raise ValueError(f"frame {h}x{w} is larger than the pad "
                             f"{ph}x{pw}")
        padhw = ((top, 0), (0, rightp))
        return {"image": np.pad(image, padhw + ((0, 0),)),
                "depth": np.pad(depth, padhw),
                "top_pad": top, "right_pad": rightp}

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                indices: Optional[Sequence[int]] = None,
                drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        """Stacked batches as tensors on the device, in rag_tpu's order:
        ``indices`` (default all), permuted by default_rng(seed) if
        shuffle; the same generator then draws the crops."""
        idx = np.asarray(indices if indices is not None else range(len(self)))
        rng = np.random.default_rng(seed)
        if shuffle:
            idx = rng.permutation(idx)
        stop = len(idx) - (len(idx) % batch_size if drop_last else 0)
        for start in range(0, stop, batch_size):
            chunk = [self.get(int(i), rng) for i in idx[start:start + batch_size]]
            if not chunk:
                return
            yield {k: torch.from_numpy(
                       np.stack([c[k] for c in chunk]).astype(np.float32)
                   ).to(self.device) for k in ("image", "depth")}
