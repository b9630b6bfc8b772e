"""Work a request or a step asks of the card, counted from the path's
sizes and shapes: the reference walks the path on the meta device (no
data, no time), recording each 3x3x3 conv, the stem and the head with
their shapes; ``rooflines`` prices each call site for the kernel that
serves it on the main path, and torch's FlopCounterMode counts the
model's conv FLOPs (forward, and in training dX where the input needs a
gradient and dW where the site trains) for ``mfu``.

Kernels: A every 3x3x3 conv after the stem (and its dX), B the stem on
the cost volume, C the head; in training D each training 3x3x3 conv's
dW, E the stem's dX, F the stem's dW, G the head's backward.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import rooflines as rl
from reference.net import Checkpoint, Net, Path
from reference.train import photometric_loss


def _kernel_work(records, training: bool) -> Dict[str, dict]:
    """Per kernel: the summed bound of its calls (each call priced on its
    own), and their operations and bytes."""
    out: Dict[str, dict] = {}

    def add(k, fb):
        acc = out.setdefault(k, {"bound_s": 0.0, "flops": 0.0, "bytes": 0.0})
        acc["bound_s"] += rl.bound_s(*fb)
        acc["flops"] += fb[0]
        acc["bytes"] += fb[1]

    for kind, kw in records:
        if kind == "conv3":
            b, cin, d, h, w = kw["x"].shape
            cout = kw["w"].shape[-1]
            shape = (b, d, cin, h, w)
            add("A", rl.conv_work(shape, cout))
            if training and kw["x"].requires_grad:
                add("A", rl.conv_work(shape, cout))
            if training and kw["trains"]:
                add("D", rl.dw_work(shape, cout))
        elif kind == "stem":
            b, c, h, w = kw["x"].shape
            nd, cout = kw["nd"], kw["w"].shape[-1]
            add("B", rl.cvstem_work((b, c, h, w), nd, cout))
            dz = (b, nd, cout, h, w)
            if training and kw["x"].requires_grad:
                add("E", rl.cvstem_dxy_work(dz, 2 * c, nd))
            if training and kw["trains"]:
                add("F", rl.cvstem_dw_work((b, c, h, w), dz, nd))
        elif kind == "head":
            shape = tuple(kw["x"].shape)
            add("C", rl.disp_work(shape, kw["maxdisp"], kw["scale"]))
            if training:
                add("G", rl.disp_bwd_work(shape, kw["maxdisp"], kw["scale"]))
    return out


def count(ckpt: Checkpoint, task: int, sizes: dict, batch: int, hw,
          train_sites=frozenset(), loss_kind=None) -> dict:
    """{"flops": model FLOPs, "kernels": {letter: work}} of one
    forward (``loss_kind`` None) or one train step of ``batch`` pairs of
    ``hw``."""
    path = Path(ckpt, task, sizes, "meta", meta=True)
    records = []
    h, w = hw

    def rec(kind, **kw):
        records.append((kind, kw))

    views = {k: torch.empty((batch, h, w, 3), device="meta")
             for k in ("left", "right")}
    views["disparity"] = torch.empty((batch, h, w), device="meta")
    training = loss_kind is not None
    keys = [k for k in path.params if k.split("/")[0] in train_sites]
    leaves = {k: path.params[k].detach().requires_grad_(training)
              for k in keys}
    with FlopCounterMode(display=False) as fc:
        net = Net(path, {**path.params, **leaves}, path.stats,
                  train_sites if training else frozenset(), rec)
        if training:
            loss = _meta_loss(net, loss_kind, sizes["maxdisp"], views)
            torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        else:
            net.forward(views["left"], views["right"])
    kernels = _kernel_work(records, training)
    head = kernels["C"]["flops"] + (kernels["G"]["flops"] if training else 0.0)
    return {"flops": float(fc.get_total_flops()) + head, "kernels": kernels}


def _meta_loss(net, kind, maxdisp, views):
    """The loss on the meta device: the supervised loss's boolean mask
    indexing needs data, so it is counted as the same elementwise work
    over every pixel (no conv, no FLOPs either way)."""
    disp = net.forward(views["left"], views["right"])
    if kind == "photometric":
        return photometric_loss(disp, views["left"], views["right"])
    return torch.nn.functional.smooth_l1_loss(disp, views["disparity"])


@functools.lru_cache(maxsize=None)
def _cached(ckpt_dir, ckpt_task, task, sizes_json, batch, hw, train_sites,
            loss_kind):
    import json

    return count(Checkpoint(ckpt_dir, ckpt_task), task, json.loads(sizes_json),
                 batch, hw, train_sites, loss_kind)


def cached(ckpt_dir: str, ckpt_task: int, task: int, sizes: dict, batch: int,
           hw, train_sites=frozenset(), loss_kind=None) -> dict:
    import json

    return _cached(ckpt_dir, ckpt_task, task, json.dumps(sizes, sort_keys=True),
                   batch, tuple(hw), frozenset(train_sites), loss_kind)
