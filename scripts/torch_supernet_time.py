#!/usr/bin/env python3
"""Time the search supernet's train step with the cost volume's two
backward passes.

    python3 scripts/torch_supernet_time.py [--reps N]

On one NVIDIA GPU, the first train step of task 0's cell search as
chip_smoke.py's learn phase builds it (batch 8 of 192x384 styled synthetic
pairs, maxdisp 192, D 64, default kernels), with the port's cost volume
(``ops/cost_volume.py``: the y half's backward sums the D planes' shifted
gradients in d order) and with the same gather differentiated by autograd
(one accumulating ``index_put_``, the port's cost volume before it got its
own backward), in turns (port, autograd, autograd, port). Per turn: the
step's mean time over --reps steps on CUDA events after two warm-up steps,
its device busy time from one profiled step (torch.profiler), whether two
steps from one state give bit-equal params, momentum and statistics, and
the volume alone at the step's shapes (forward + backward to x and y,
CUDA events; two backward passes bit-equal or not). Prints one JSON line with the
card's name and power limit. Builds the kernels into build/ at first use.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

from rag_tpu_torch.data.stereo_dataset import split_half  # noqa: E402
from rag_tpu_torch.data.synthetic import (  # noqa: E402
    WEATHER_STYLES,
    SyntheticStereoDataset,
)
from rag_tpu_torch.models import supernet  # noqa: E402
from rag_tpu_torch.models.supernet import NUM_EDGES  # noqa: E402
from rag_tpu_torch.ops.cost_volume import cost_volume_cf  # noqa: E402
from rag_tpu_torch.search.mdenas import CellSearch, CellSearchConfig  # noqa: E402
from rag_tpu_torch.train.trainer import clone_tree, cosine_lr  # noqa: E402

MAXDISP = 192


def gather_volume(x, y, num_disp):
    """cost_volume_cf's forward, its y gather differentiated by autograd."""
    b, h, w, c = x.shape
    x_cf, y_cf = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    src = (torch.arange(w, device=x.device)[None, :]
           - torch.arange(num_disp, device=x.device)[:, None])
    mask = (src >= 0).to(x.dtype)[None, :, None, None, :]
    y_shift = y_cf[..., src.clamp(0, w - 1)].movedim(3, 1)
    return torch.cat([x_cf[:, None] * mask, y_shift * mask], dim=2)


def first_step():
    cfg = CellSearchConfig(epochs=2, batch=8, lr=0.002, lr_a=0.01,
                           maxdisp=MAXDISP)
    cs = CellSearch(cfg, log=None, device="cuda")
    data = SyntheticStereoDataset(32, 192, 384, seed=10, max_disp=64.0,
                                  style=WEATHER_STYLES[0], device="cuda")
    rng = np.random.default_rng(cfg.seed)
    train_idx, _ = split_half(len(data), seed=cfg.seed)
    ops = [np.array([rng.choice(cfg.num_ops, p=cs.p[k][e])
                     for e in range(NUM_EDGES)], np.int32)
           for k in ("normal", "reduce")]
    b = next(data.batches(cfg.batch, True, seed=0, indices=train_idx))
    lr = cosine_lr(cfg.lr, cfg.epochs, 0, cfg.lr_min)
    return cs, lr, (b["left"], b["right"], b["disparity"], *ops)


def step_from(cs, lr, args):
    params = clone_tree(cs.params)
    mom = cs.optimizer.init(params)
    params, stats, mom, _ = cs._train_step(params, cs.stats, mom, lr, *args)
    return params, stats, mom


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def turn(volume, cs, lr, args, reps):
    supernet.cost_volume_cf = recorded(volume)
    for _ in range(2):
        step_from(cs, lr, args)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        step_from(cs, lr, args)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    a, b = step_from(cs, lr, args), step_from(cs, lr, args)
    same = all(torch.equal(x, y) for ta, tb in zip(a, b)
               for x, y in zip(leaves(ta), leaves(tb)))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step_from(cs, lr, args)
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side events only (kernels, copies): the CPU ops that launch
    # them carry the same device time again
    busy = sum(getattr(e, key) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"ms": ms, "device_busy_ms": busy, "two_steps_bit_equal": same,
            **volume_alone(volume, reps)}


SHAPES = []   # (x.shape, num_disp) of the step's volume, recorded once


def recorded(volume):
    def run(x, y, num_disp):
        if not SHAPES:
            SHAPES.append((tuple(x.shape), num_disp))
        return volume(x, y, num_disp)
    return run


def volume_alone(volume, reps):
    (shape, nd), = SHAPES
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y = (torch.randn(shape, device="cuda", generator=gen,
                        requires_grad=True) for _ in range(2))
    g = torch.randn((shape[0], nd, 2 * shape[3], *shape[1:3]), device="cuda",
                    generator=gen)

    def fwd_bwd():
        return torch.autograd.grad(volume(x, y, nd), (x, y), g)

    for _ in range(2):
        fwd_bwd()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps * 4):
        fwd_bwd()
    end.record()
    end.synchronize()
    a, b = fwd_bwd(), fwd_bwd()
    return {"volume_shape": [list(shape), nd],
            "volume_fwd_bwd_ms": start.elapsed_time(end) / (reps * 4),
            "volume_grads_bit_equal": all(torch.equal(p, q)
                                          for p, q in zip(a, b))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_supernet_time: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs, lr, args = first_step()
    out = {"device": smi, "reps": opts.reps, "turns": []}
    for name in ("port", "autograd", "autograd", "port"):
        vol = cost_volume_cf if name == "port" else gather_volume
        out["turns"].append({"volume": name,
                             **turn(vol, cs, lr, args, opts.reps)})
        print(json.dumps(out["turns"][-1]), flush=True)
    supernet.cost_volume_cf = cost_volume_cf
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
