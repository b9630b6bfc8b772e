"""Filename-list stereo datasets with the reference's crop/pad protocol,
and the search split.

Counterpart of rag_tpu/data/stereo_dataset.py. A list holds lines of
"left right disp [disp_R]" paths; training takes random 384x192 crops,
evaluation zero-pads top and right to 960x480 (batch 1); PNG disparity is
/256; images are ImageNet-normalized. Samples are read on the host
(numpy, PIL) exactly as rag_tpu reads them; ``batches`` yields dicts of
tensors on the dataset's ``device``: left/right (B,H,W,3) and disparity
(B,H,W), float32, holding rag_tpu's numpy batches' values.

Which reader a dataset takes is explicit. A training dataset whose files
are all PNG (disparity PNG or PFM), without ``resize_wide``, streams its
``batches`` through the native loader (runtime.native) when ``native`` is
True, as rag_tpu's does, whenever no ``indices`` subset is asked for: the
loader is built once with the first call's seed, streams without epochs
and ignores ``shuffle`` and ``seed`` (rag_tpu's semantics). Where the
native library cannot build or load, that raises; ``native=False`` is the
only way onto the Python path for such a dataset.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from rag_tpu_torch.data.readers import (
    normalize_imagenet,
    read_all_lines,
    read_image,
    read_pfm,
    read_png_disparity,
    resize_bilinear,
)

TRAIN_CROP = (384, 192)  # (w, h)
EVAL_PAD = (960, 480)    # (w, h)
# the self-supervised variant's cross-domain eval pad (fits KITTI and
# wide-resized Cityscapes frames)
SELFSUP_EVAL_PAD = (1248, 576)
# SceneFlow-geometry eval pad of the proxy dataset
SCENEFLOW_EVAL_PAD = (960, 540)

# the Cityscapes rule: frames wider than 1800 px are resized to 1024x512
# and their disparity halved
WIDE_THRESHOLD = 1800
WIDE_RESIZE = (1024, 512)  # (w, h)


def load_file_list(path: str) -> List[List[str]]:
    return [ln.split() for ln in read_all_lines(path)]


class StereoDataset:
    """One weather-scene split. training=True -> random crops; else padded
    full images (batch size 1 recommended, matching the reference)."""

    def __init__(self, list_file: str, training: bool,
                 crop=TRAIN_CROP, pad=EVAL_PAD, root: str = "",
                 resize_wide: bool = False, native: bool = True,
                 device="cuda"):
        """resize_wide enables the Cityscapes rule: frames wider than
        1800 px resize to 1024x512 with disparity halved. native: stream
        eligible training batches through the native loader."""
        self.entries = load_file_list(list_file)
        self.training = training
        self.crop = crop
        self.pad = pad
        self.root = root
        self.resize_wide = resize_wide
        self.native = native
        self.device = torch.device(device)
        self._native = None       # the NativeStereoLoader once built
        self.used_native = False  # did batches() stream natively?

    def __len__(self):
        return len(self.entries)

    def _path(self, p: str) -> str:
        return os.path.join(self.root, p) if self.root else p

    def _load_disp(self, path: str) -> np.ndarray:
        if path.endswith(".pfm"):
            return read_pfm(path)[0]
        return read_png_disparity(path)

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        """One sample as host numpy arrays (HWC images, HW disparity)."""
        entry = self.entries[index]
        left = read_image(self._path(entry[0]))
        right = read_image(self._path(entry[1]))
        disp = self._load_disp(self._path(entry[2]))
        if self.resize_wide and left.shape[1] > WIDE_THRESHOLD:
            rw, rh = WIDE_RESIZE
            left = resize_bilinear(left, rh, rw)
            right = resize_bilinear(right, rh, rw)
            # disparity is resized like an image, then halved: the pixel
            # shift scales with the width
            disp = resize_bilinear(disp, rh, rw) / 2.0
        left = normalize_imagenet(left)
        right = normalize_imagenet(right)
        h, w = disp.shape

        if self.training:
            cw, ch = self.crop
            rng = rng or np.random.default_rng()
            x1 = int(rng.integers(0, max(w - cw, 0) + 1))
            y1 = int(rng.integers(0, max(h - ch, 0) + 1))
            return {
                "left": left[y1:y1 + ch, x1:x1 + cw],
                "right": right[y1:y1 + ch, x1:x1 + cw],
                "disparity": disp[y1:y1 + ch, x1:x1 + cw],
            }

        pw, ph = self.pad
        top, rightp = ph - h, pw - w
        if top < 0 or rightp < 0:
            raise ValueError(f"frame {h}x{w} is larger than the pad "
                             f"{ph}x{pw}")
        padhw = ((top, 0), (0, rightp))
        return {
            "left": np.pad(left, padhw + ((0, 0),)),
            "right": np.pad(right, padhw + ((0, 0),)),
            "disparity": np.pad(disp, padhw),
            "top_pad": top,
            "right_pad": rightp,
        }

    # -- the native path ---------------------------------------------------

    def native_eligible(self) -> bool:
        """Training, every file PNG (disparity PNG or PFM), no resize_wide,
        and ``native`` asked for."""
        if not self.native or not self.training or self.resize_wide:
            return False
        if not self.entries or any(len(e) < 3 for e in self.entries):
            return False
        return all(e[0].endswith(".png") and e[1].endswith(".png")
                   and (e[2].endswith(".png") or e[2].endswith(".pfm"))
                   for e in self.entries)

    def _native_loader(self, seed: int):
        if self._native is None:
            from rag_tpu_torch.runtime.native import NativeStereoLoader

            entries = [[self._path(p) for p in e[:3]] for e in self.entries]
            self._native = NativeStereoLoader(
                entries, True, crop=self.crop, pad=self.pad, seed=seed)
        return self._native

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(batch[k]).to(self.device)
                for k in ("left", "right", "disparity")}

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                indices: Optional[Sequence[int]] = None,
                drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield stacked NHWC batches as tensors on the device."""
        if indices is None and self.native_eligible():
            loader = self._native_loader(seed)
            self.used_native = True
            stop = len(self) - (len(self) % batch_size if drop_last else 0)
            for start in range(0, stop, batch_size):
                yield self._tensors(
                    loader.next_batch(min(batch_size, stop - start)))
            return
        idx = np.asarray(indices if indices is not None else range(len(self)))
        rng = np.random.default_rng(seed)
        if shuffle:
            idx = rng.permutation(idx)
        stop = len(idx) - (len(idx) % batch_size if drop_last else 0)
        for start in range(0, stop, batch_size):
            chunk = [self.get(int(i), rng) for i in idx[start:start + batch_size]]
            if not chunk:
                return
            yield self._tensors({
                k: np.stack([c[k] for c in chunk]).astype(np.float32)
                for k in ("left", "right", "disparity")})


def split_half(n: int, seed: Optional[int] = None, frac: float = 0.5):
    """The reference's search split: a random permutation of range(n),
    whose first ``frac`` trains weights and the rest scores architectures.
    seed=None keeps the prefix split. Returns (train, valid) index lists."""
    split = int(np.floor(frac * n))
    if seed is None:
        return list(range(split)), list(range(split, n))
    perm = np.random.default_rng(seed).permutation(n)
    return perm[:split].tolist(), perm[split:].tolist()
