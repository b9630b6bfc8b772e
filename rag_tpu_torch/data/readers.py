"""Image and disparity readers.

Counterpart of rag_tpu/data/readers.py, copied: the PFM parser, PNG
disparity / 256, RGB images in [0, 1], ImageNet normalization and its
inverse, a host bilinear resize and the filename-list reader. numpy and
PIL only (PIL decodes PNG and JPG); the arrays are float32 HWC.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """Parse a PFM file (SceneFlow disparity format): (top-down array,
    scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"Malformed PFM header: {path}")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.frombuffer(f.read(), endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.reshape(data, shape)
    return np.ascontiguousarray(np.flipud(data), np.float32), scale


def read_png_disparity(path: str) -> np.ndarray:
    """KITTI/DrivingStereo uint16 PNG disparity / 256."""
    from PIL import Image

    return np.array(Image.open(path), np.float32) / 256.0


def read_image(path: str) -> np.ndarray:
    """RGB image -> float32 HWC in [0,1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """HWC [0,1] -> ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_imagenet(img: np.ndarray) -> np.ndarray:
    """Inverse of normalize_imagenet: back to [0,1] HWC (unclipped)."""
    return img * IMAGENET_STD + IMAGENET_MEAN


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Host bilinear resize of an HW or HWC float array (half-pixel
    centres, edges clamped)."""
    h, w = img.shape[:2]
    ys = (np.arange(height) + 0.5) * h / height - 0.5
    xs = (np.arange(width) + 0.5) * w / width - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    if img.ndim == 3:
        wy = wy[:, None, None]
        wx = wx[None, :, None]
    else:
        wy = wy[:, None]
        wx = wx[None, :]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def read_all_lines(path: str):
    """The non-blank lines of a text file, stripped."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]
