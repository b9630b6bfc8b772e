"""Seeded inputs: random-dot stereograms in four weather styles, made on
the device in a few large calls.

A texture of unit variance (Gaussian noise under a 7-wide box filter
along H, then W), a piecewise-constant disparity field of tiles a quarter
of the frame wide and high, uniform in [4, max_disp], the right view the
texture sampled at j + d (linear), and the ground truth 0 where that
falls outside the frame. The styles shift both views' appearance after
the warp and leave the geometry alone; they are a frozen copy of
rag_tpu_torch/data/synthetic.py's ``WEATHER_STYLES``: cloudy (clean),
foggy, rainy (per-view speckle), sunny.

Every seed draws the same number of frames of each style; only their
order and their pixels change with the seed, so every seed asks the same
work of the system.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

WEATHER_STYLES = (
    {},
    {"fog": 0.45, "contrast": 0.75},
    {"noise": 0.25, "contrast": 0.9, "brightness": -0.1},
    {"brightness": 0.35, "contrast": 1.3},
)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def stereograms(gen: torch.Generator, n: int, h: int, w: int,
                max_disp: float, style: int, device) -> Dict[str, torch.Tensor]:
    """n pairs of (H, W): left, right (n, H, W, 3) and disparity (n, H, W),
    float32 on ``device``."""
    tex = torch.randn((n, 3, h, w), generator=gen, device=device)
    tex = F.avg_pool2d(tex, (7, 1), stride=1, padding=(3, 0),
                       count_include_pad=True)
    tex = F.avg_pool2d(tex, (1, 7), stride=1, padding=(0, 3),
                       count_include_pad=True)
    tex = (tex / (tex.std() + 1e-6)).permute(0, 2, 3, 1).contiguous()
    th, tw = max(h // 4, 1), max(w // 4, 1)
    tiles = 4.0 + (max_disp - 4.0) * torch.rand(
        (n, -(-h // th), -(-w // tw)), generator=gen, device=device)
    disp = tiles.repeat_interleave(th, 1).repeat_interleave(tw, 2)[:, :h, :w]
    src = torch.arange(w, device=device, dtype=torch.float32) + disp
    j0f = torch.floor(src)
    frac = (src - j0f).unsqueeze(-1)
    j0 = j0f.long().clamp(0, w - 1)
    j1 = (j0 + 1).clamp(0, w - 1)
    idx0 = j0.unsqueeze(-1).expand(n, h, w, 3)
    idx1 = j1.unsqueeze(-1).expand(n, h, w, 3)
    right = (torch.gather(tex, 2, idx0) * (1 - frac)
             + torch.gather(tex, 2, idx1) * frac)
    disp = torch.where(src <= w - 1, disp, torch.zeros_like(disp))
    left = tex
    st = WEATHER_STYLES[style]
    views = []
    for img in (left, right):
        img = img * float(st.get("contrast", 1.0)) + float(st.get("brightness", 0.0))
        fog = float(st.get("fog", 0.0))
        if fog:
            img = img * (1.0 - fog) + fog * 0.5
        noise = float(st.get("noise", 0.0))
        if noise:
            img = img + noise * torch.randn(img.shape, generator=gen,
                                            device=device)
        views.append(img)
    return {"left": views[0], "right": views[1], "disparity": disp}


def style_order(seed: int, count: int, styles: int) -> List[int]:
    """``count`` style indices, each of the ``styles`` equally often (as
    near as count allows), in an order drawn from the seed."""
    base = [i % styles for i in range(count)]
    return [base[i] for i in np.random.default_rng(seed).permutation(count)]


def pad_top_right(x: torch.Tensor, hw) -> torch.Tensor:
    """Zero-pad (n, h, w, c) frames at the top and the right to hw, as
    the reference evaluates DrivingStereo's frames."""
    return F.pad(x, (0, 0, 0, hw[1] - x.shape[2], hw[0] - x.shape[1], 0))


def serve_pool(seed: int, traffic: dict, device) -> List[Dict[str, np.ndarray]]:
    """The frame sets a camera rig sends: ``pool_sets`` requests of
    ``pairs_per_request`` pairs, one weather each, padded to ``pad_to``,
    as host numpy arrays (the frames arrive from the cameras)."""
    gen = generator(seed, device)
    h, w = traffic["frame_hw"]
    n = traffic["pairs_per_request"]
    pool = []
    for style in style_order(seed, traffic["pool_sets"], len(WEATHER_STYLES)):
        s = stereograms(gen, n, h, w, traffic["max_disp_px"], style, device)
        pool.append({k: pad_top_right(s[k], traffic["pad_to"]).cpu().numpy()
                     for k in ("left", "right")})
    return pool


def train_pool(seed: int, traffic: dict, device) -> List[Dict[str, torch.Tensor]]:
    """``pool_batches`` distinct batches of ``batch`` random crops of
    ``crop_hw`` from frames of ``frame_hw``, the styles mixed within each
    batch, held on the device."""
    gen = generator(seed, device)
    h, w = traffic["frame_hw"]
    ch, cw = traffic["crop_hw"]
    b, nb = traffic["batch"], traffic["pool_batches"]
    total = b * nb
    styles = style_order(seed, total, len(WEATHER_STYLES))
    frames = {k: [] for k in ("left", "right", "disparity")}
    for style in range(len(WEATHER_STYLES)):
        count = styles.count(style)
        if count:
            s = stereograms(gen, count, h, w, traffic["max_disp_px"], style,
                            device)
            for k in frames:
                frames[k].append(s[k])
    frames = {k: torch.cat(v) for k, v in frames.items()}
    # crop origins, then the frames' order, from the seed
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, h - ch + 1, total)
    xs = rng.integers(0, w - cw + 1, total)
    order = rng.permutation(total)
    crops = {k: torch.stack([frames[k][i, ys[i]:ys[i] + ch, xs[i]:xs[i] + cw]
                             for i in order])
             for k in frames}
    return [{k: v[i * b:(i + 1) * b].contiguous() for k, v in crops.items()}
            for i in range(nb)]
