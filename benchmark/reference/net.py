"""Plain PyTorch reference of the RAG stereo network, rebuilt from a
checkpoint's arrays and genotypes and the configuration's sizes.

Nothing here comes from the program under test: the checkpoint is read
from its files (``manifest_task{T}.json``, ``arrays_task{T}.npz``,
``router.npz``), every block is written out in the textbook layout
(NCHW, NCDHW) with ``torch.nn.functional``, and nothing is fused.

The network (RAG, CVPR 2022 / TPAMI 2024): a 2D feature net (three
ConvBR stems, the middle one at stride 3, four genotype cells, a 1x1
conv) on each view; a concatenation cost volume of D = maxdisp / 3
planes; a 3D matching net (two 3x3x3 ConvBR stems, eight genotype cells,
three heads with two trilinear resizes between them); and a soft-argmin
head that upsamples the cost trilinearly to (maxdisp, 3h, 3w) and takes
the expectation of the disparity under softmax(-cost).

A ConvBR is conv (no bias), BatchNorm (eps 1e-5, momentum 0.1; running
variance updated with the unbiased batch variance) and ReLU. Sites in
``train_sites`` run BatchNorm on batch statistics and update the running
ones; every other site normalizes with its running statistics. The
feature net runs on the left view, then on the right, so a training
site's running statistics take two updates, left first.

A cell is a DAG of ``steps`` nodes over its two inputs: each node sums
two in-edges, an edge is the identity (op 0) or a 3x3 ConvBR (op 1), and
the output concatenates the last ``block_multiplier`` states. A cell
with ``downup`` -1 (+1) first resizes its previous input by 1/2 (2) along
every spatial axis (align_corners=True), and its input before that is
resized to match; inputs whose channels differ from the cell's pass
through 1x1 ConvBRs ("pre", "prep").

Parameters and statistics are flat dicts keyed ``site/block/leaf`` (for
example ``cell_3d1/ops/3/w``), the checkpoint's own naming.

``rec``: an optional callable that receives every 3x3x3 conv, the stem
and the head with their shapes; the benchmark's work counting walks the
net with it on the meta device.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
OP_CONV = 1


def scale_dimension(dim: int, scale: float) -> int:
    """A cell's resized length: odd lengths keep both ends."""
    if dim % 2 == 1:
        return int((float(dim) - 1.0) * scale + 1.0)
    return int(float(dim) * scale)


class Checkpoint:
    """A committed checkpoint: the manifest of ``task`` and its arrays on
    the host."""

    def __init__(self, directory: str, task: int):
        self.directory = directory
        with open(os.path.join(directory, f"manifest_task{task}.json")) as f:
            self.manifest = json.load(f)
        with np.load(os.path.join(directory, f"arrays_task{task}.npz")) as z:
            self.arrays = {k: z[k] for k in z.files}

    def router(self, device) -> Dict[str, torch.Tensor]:
        """The Scene Router's weights: leaves 0-4 of router.npz are b, c0,
        c1, c2, w."""
        with np.load(os.path.join(self.directory, "router.npz")) as z:
            leaves = [z[f"router_leaf_{i}"] for i in range(5)]
        return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                for k, v in zip(("b", "c0", "c1", "c2", "w"), leaves)}

    def trainable_sites(self, task: int):
        """Task 0 trains every site of its path; a later task the units
        the manifest's model_to_train names."""
        arch = self.manifest["archis"][task]
        if task == 0:
            return frozenset(arch)
        mtt = self.manifest["model_to_train"]
        return frozenset(s for s, i in arch.items() if i in mtt.get(s, []))


class Path:
    """One task's path: per site its unit's gene, parameters and running
    statistics (float32 tensors on ``device``)."""

    def __init__(self, ckpt: Checkpoint, task: int, net_sizes: dict, device,
                 meta: bool = False):
        self.sizes = net_sizes
        self.task = task
        man = ckpt.manifest
        arch = man["archis"][task]
        self.genes: Dict[str, list] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.stats: Dict[str, torch.Tensor] = {}
        for site, idx in arch.items():
            if site in net_sizes["heads"]:
                prefix = f"heads/{site}/{idx}/"
            else:
                prefix = f"units/{site}/{idx}/"
                born = man["born"][site][idx]
                geno = man["genotypes"][born]
                self.genes[site] = sorted(
                    (int(e), int(o))
                    for e, o in geno["normal" if "2d" in site else "reduce"])
            for key, arr in ckpt.arrays.items():
                if not key.startswith(prefix):
                    continue
                kind, leaf = key[len(prefix):].split("/", 1)
                store = self.params if kind == "params" else self.stats
                t = (torch.empty(arr.shape, dtype=torch.float32, device="meta")
                     if meta else
                     torch.from_numpy(np.array(arr, np.float32)).to(device))
                store[f"{site}/{leaf}"] = t


# -- blocks -------------------------------------------------------------------

def _conv(x, w, stride: int = 1):
    """Zero-padded conv, NC(D)HW; w in the checkpoint's (*k, cin, cout)."""
    nd = w.dim() - 2
    wt = w.permute((nd + 1, nd) + tuple(range(nd)))
    pad = w.shape[0] // 2
    fn = F.conv2d if nd == 2 else F.conv3d
    return fn(x, wt, stride=stride, padding=pad)


def _batch_norm(x, p, s, key, train, new_stats):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        dims = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            old_m = new_stats.get(f"{key}/mean", s[f"{key}/mean"])
            old_v = new_stats.get(f"{key}/var", s[f"{key}/var"])
            new_stats[f"{key}/mean"] = ((1 - BN_MOMENTUM) * old_m
                                        + BN_MOMENTUM * mean.detach())
            new_stats[f"{key}/var"] = ((1 - BN_MOMENTUM) * old_v
                                       + BN_MOMENTUM * var.detach()
                                       * (n / max(n - 1, 1)))
    else:
        mean, var = s[f"{key}/mean"], s[f"{key}/var"]
    return ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + BN_EPS)
            * p[f"{key}/scale"].reshape(shape) + p[f"{key}/bias"].reshape(shape))


class Net:
    """The forward of one path. ``stats`` is read for frozen sites;
    ``new_stats`` collects the running statistics that training sites
    update (each key once per pass)."""

    def __init__(self, path: Path, params, stats, train_sites=frozenset(),
                 rec: Optional[Callable] = None):
        self.path = path
        self.sizes = path.sizes
        self.p = params
        self.s = stats
        self.train_sites = train_sites
        self.rec = rec
        self.new_stats: Dict[str, torch.Tensor] = {}

    def convbr(self, site, key, x, kernel, stride=1, bn=True, relu=True,
               stem=False):
        w = self.p[f"{key}/w"]
        if self.rec is not None and x.dim() == 5 and kernel == 3 and not stem:
            self.rec("conv3", site=site, x=x, w=w,
                     trains=site in self.train_sites)
        y = _conv(x, w, stride)
        if bn:
            y = _batch_norm(y, self.p, self.s, key, site in self.train_sites,
                            self.new_stats)
        return torch.relu(y) if relu else y

    def block(self, name, x, stem=False):
        cin, cout, k, stride, bn, relu = self._plan(name)
        return self.convbr(name, name, x, k, stride, bn, relu, stem)

    def _plan(self, name):
        sz = self.sizes
        for group in ("feature_stems", "matching_stems", "heads"):
            if name in sz[group]:
                return sz[group][name]
        raise KeyError(name)

    def cell(self, name, plan, s0, s1):
        c_pp, c_p, c_out, downup = plan
        mode = "bilinear" if s1.dim() == 4 else "trilinear"
        if downup != 0:
            scale = 0.5 if downup == -1 else 2.0
            size = [scale_dimension(n, scale) for n in s1.shape[2:]]
            s1 = F.interpolate(s1, size=size, mode=mode, align_corners=True)
        if s0.shape[2:] != s1.shape[2:]:
            s0 = F.interpolate(s0, size=list(s1.shape[2:]), mode=mode,
                               align_corners=True)
        if c_pp != c_out:
            s0 = self.convbr(name, f"{name}/pre", s0, 1)
        s1 = self.convbr(name, f"{name}/prep", s1, 1)
        states, offset = [s0, s1], 0
        for _ in range(self.sizes["steps"]):
            acc = None
            for edge, op in self.path.genes[name]:
                if not offset <= edge < offset + len(states):
                    continue
                x = states[edge - offset]
                h = (self.convbr(name, f"{name}/ops/{edge}", x, 3)
                     if op == OP_CONV else x)
                acc = h if acc is None else acc + h
            offset += len(states)
            states.append(acc)
        return torch.cat(states[-self.sizes["block_multiplier"]:], dim=1)

    def features(self, image):
        """(B, H, W, 3) -> (B, 12, H/3, W/3)."""
        x = image.permute(0, 3, 1, 2)
        s = self.block("stem_2d0", x)
        stem1 = self.block("stem_2d1", s)
        stem2 = self.block("stem_2d2", stem1)
        s_pp, s_p = stem1, stem2
        for i, plan in enumerate(self.sizes["cells_2d"]):
            s_pp, s_p = s_p, self.cell(f"cell_2d{i}", plan, s_pp, s_p)
        return self.block("last_3_2d", s_p)

    def cost_volume(self, x, y, nd):
        """(B, 2C, nd, h, w): plane d holds x[..., j] and y[..., j - d] at
        columns j >= d, zeros left of them."""
        w = x.shape[-1]
        planes = [torch.cat([F.pad(x[..., min(d, w):], (min(d, w), 0)),
                             F.pad(y[..., :max(w - d, 0)], (min(d, w), 0))],
                            dim=1)
                  for d in range(nd)]
        return torch.stack(planes, dim=2)

    def matching(self, x, y, nd):
        """Feature maps (B, C, h, w) -> matching cost (B, nd, h, w)."""
        vol = self.cost_volume(x, y, nd)
        if self.rec is not None:
            self.rec("stem", site="stem_3d0", x=x, y=y, nd=nd,
                     w=self.p["stem_3d0/w"],
                     trains="stem_3d0" in self.train_sites)
        stem0 = self.block("stem_3d0", vol, stem=True)
        stem1 = self.block("stem_3d1", stem0)
        s_pp, s_p = stem0, stem1
        for i, plan in enumerate(self.sizes["cells_3d"]):
            s_pp, s_p = s_p, self.cell(f"cell_3d{i}", plan, s_pp, s_p)
        d, h, w = stem0.shape[2:]
        v = self.block("last_12_3d", s_p)
        v = F.interpolate(v, size=[d // 2, h // 2, w // 2], mode="trilinear",
                          align_corners=True)
        v = self.block("last_6_3d", v)
        v = F.interpolate(v, size=[d, h, w], mode="trilinear",
                          align_corners=True)
        return self.block("last_3_3d", v)[:, 0]

    def head(self, cost, maxdisp, scale):
        """Soft argmin: (B, D, h, w) -> (B, scale h, scale w)."""
        if self.rec is not None:
            self.rec("head", x=cost, maxdisp=maxdisp, scale=scale)
        _, _, h, w = cost.shape
        y = F.interpolate(cost[:, None], size=[maxdisp, h * scale, w * scale],
                          mode="trilinear", align_corners=False)[:, 0]
        p = torch.softmax(-y, dim=1)
        d = torch.arange(maxdisp, dtype=p.dtype, device=p.device)
        return (p * d[None, :, None, None]).sum(dim=1)

    def forward(self, left, right):
        """Disparity (B, H, W) of NHWC views; running statistics of the
        training sites land in ``new_stats`` (left view's update first)."""
        maxdisp = self.sizes["maxdisp"]
        scale = self.sizes["feature_stride"]
        fl = self.features(left)
        fr = self.features(right)
        return self.head(self.matching(fl, fr, maxdisp // scale), maxdisp,
                         scale)


def router_ids(weights, image) -> torch.Tensor:
    """The Scene Router's task ids of NHWC frames: three stride-2 3x3
    convs with ReLU under XLA's SAME padding, then a linear layer over the
    features' global mean and standard deviation; argmax."""
    x = image.permute(0, 3, 1, 2)
    for name in ("c0", "c1", "c2"):
        pads = []
        for n in (x.shape[3], x.shape[2]):
            total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        x = torch.relu(F.conv2d(F.pad(x, pads),
                                weights[name].permute(3, 2, 0, 1), stride=2))
    mean = x.mean(dim=(2, 3))
    std = torch.sqrt(torch.clamp((x * x).mean(dim=(2, 3)) - mean * mean,
                                 min=0.0))
    logits = torch.cat([mean, std], dim=-1) @ weights["w"] + weights["b"]
    return torch.argmax(logits, dim=-1)
