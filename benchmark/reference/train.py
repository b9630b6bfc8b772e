"""Plain PyTorch reference of the RAG training steps: the supervised
masked smooth-L1 step and the self-supervised photometric step, each
followed by SGD with momentum after a global-norm gradient clip, with
weight decay added to the clipped gradient (optax's ``chain(
clip_by_global_norm, add_decayed_weights, trace)``, PyTorch's SGD with
``weight_decay``), updating only the sites the task trains.

Losses, as the configuration defines them:
  * supervised: smooth-L1 (beta 1) of the disparity over the pixels with
    0 < ground truth < maxdisp, their mean;
  * photometric: 0.85 SSIM dissimilarity (3x3 windows at stride 3,
    c1 = 0.01^2, c2 = 0.03^2, clipped to [0, 1]) + 0.15 L1 between the
    left view and the right view warped to it by the disparity (linear
    along W at x = j - d, zero where x falls outside [0, W - 1]), plus 0.1
    edge-aware smoothness (|disparity gradient| * exp(-|mean colour
    gradient|), along W and H).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.net import Net, Path


def supervised_loss(disp, gt, maxdisp):
    mask = (gt > 0) & (gt < maxdisp)
    if not bool(mask.any()):
        return disp.sum() * 0.0
    return F.smooth_l1_loss(disp[mask], gt[mask], beta=1.0)


def warp(image, disp):
    """The right view sampled at x = j - disp: (B, H, W, C) -> warped view
    and its validity (x inside [0, W - 1])."""
    b, h, w, c = image.shape
    x = torch.arange(w, dtype=disp.dtype, device=disp.device) - disp
    x0 = torch.floor(x)
    frac = (x - x0).unsqueeze(-1)
    i0 = x0.long()
    i1 = (i0 + 1).clamp(0, w - 1).unsqueeze(-1).expand(b, h, w, c)
    i0 = i0.clamp(0, w - 1).unsqueeze(-1).expand(b, h, w, c)
    out = (torch.gather(image, 2, i0) * (1 - frac)
           + torch.gather(image, 2, i1) * frac)
    valid = ((x >= 0) & (x <= w - 1)).to(image.dtype).unsqueeze(-1)
    return out * valid


def ssim_dissimilarity(x, y):
    def pool(t):
        return F.avg_pool2d(t.permute(0, 3, 1, 2), 3)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = pool(x), pool(y)
    sx = pool(x * x) - mx * mx
    sy = pool(y * y) - my * my
    sxy = pool(x * y) - mx * my
    num = (2 * mx * my + c1) * (2 * sxy + c2)
    den = (mx * mx + my * my + c1) * (sx + sy + c2)
    return torch.clamp((1 - num / den) / 2, 0.0, 1.0)


def photometric_loss(disp, left, right):
    est = warp(right, disp)
    recon = (0.85 * ssim_dissimilarity(left, est).mean()
             + 0.15 * (left - est).abs().mean())
    d = disp.unsqueeze(-1)
    dgx = (d[:, :, :-1] - d[:, :, 1:]).abs()
    dgy = (d[:, :-1] - d[:, 1:]).abs()
    igx = (left[:, :, :-1] - left[:, :, 1:]).mean(dim=-1, keepdim=True).abs()
    igy = (left[:, :-1] - left[:, 1:]).mean(dim=-1, keepdim=True).abs()
    smooth = (dgx * torch.exp(-igx)).mean() + (dgy * torch.exp(-igy)).mean()
    return recon + 0.1 * smooth


def loss_of(net: Net, kind: str, maxdisp: int, batch) -> torch.Tensor:
    disp = net.forward(batch["left"], batch["right"])
    if kind == "photometric":
        return photometric_loss(disp, batch["left"], batch["right"])
    return supervised_loss(disp, batch["disparity"], maxdisp)


def train_steps(path: Path, trainable, batches: List[Dict], hyper: dict,
                loss_kind: str) -> Dict:
    """SGD steps from the path's checkpoint state, one per batch. Returns
    the loss of each step, the clipped gradient of the first step (what
    the optimizer's trace holds after it, less the weight decay), and the
    parameters, running statistics and momentum after the last step, each
    as a flat dict ``site/block/leaf`` over the trained sites."""
    lr, wd = hyper["lr"], hyper["weight_decay"]
    clip, mom = hyper["grad_clip"], hyper["momentum"]
    maxdisp = path.sizes["maxdisp"]
    params = {k: v.clone() for k, v in path.params.items()}
    stats = {k: v.clone() for k, v in path.stats.items()}
    keys = sorted(k for k in params if k.split("/")[0] in trainable)
    trace = {k: torch.zeros_like(params[k]) for k in keys}
    out = {"loss": []}
    for i, batch in enumerate(batches):
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        net = Net(path, {**params, **leaves}, stats, trainable)
        loss = loss_of(net, loss_kind, maxdisp, batch)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                    allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(keys, grads)]
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            factor = torch.where(norm < clip, torch.ones_like(norm),
                                 clip / norm)
            clipped = {k: g * factor for k, g in zip(keys, grads)}
            if i == 0:
                out["grad"] = clipped
            for k in keys:
                trace[k] = clipped[k] + wd * params[k] + mom * trace[k]
                params[k] = params[k] - lr * trace[k]
            stats = {**stats, **net.new_stats}
        out["loss"].append(float(loss.detach()))
        del net, loss, grads, leaves
    out["params"] = {k: params[k] for k in keys}
    out["stats"] = {k: v for k, v in stats.items()
                    if k.split("/")[0] in trainable}
    out["momentum"] = trace
    return out
