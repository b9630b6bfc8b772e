#!/usr/bin/env python3
"""Where the Scene Router's device time goes on the card.

    python3 scripts/torch_router_time.py [--reps N] [--out FILE]

On one NVIDIA GPU, with the committed router (logs/canonical_learn_r4/
router.npz) and one frame of the canonical run's first test scene
(SyntheticStereoDataset, 1x480x960): ``router_logits`` as the port runs it,
each of its stages alone (the layout change and "SAME" pad before each
conv, the conv, the ReLU, the mean/std head), the same convs with
``torch.backends.cudnn.benchmark`` on and in channels-last layout, and one
router training step (batch 8 of 192x384, forward, backward and Adam).
Times are CUDA-event means over --reps calls after two warm-up calls; each
call's device time by kernel comes from torch.profiler. Every variant's
logits are held against the shipped ones (1e-5 of max |logit|). One JSON
line per measurement, with the card's name and power limit. TF32 stays
off throughout.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rag_tpu_torch.continual.state import load_router  # noqa: E402
from rag_tpu_torch.data.synthetic import (  # noqa: E402
    WEATHER_STYLES,
    SyntheticStereoDataset,
)
from rag_tpu_torch.models.router import (  # noqa: E402
    CONVS,
    _same_pad,
    make_router_train_step,
    router_logits,
)
from rag_tpu_torch.models.stereo import full_fp32  # noqa: E402


def cuda_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> dict:
    """Device time per call of each kernel fn launches, in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        name = re.sub(r"<.*", "", e.key.split("::")[-1].split("(")[0])[:60]
        out[name] = out.get(name, 0.0) + t / 1e3 / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def padded(x):
    """x (B,C,H,W) padded as XLA's "SAME" at stride 2."""
    (t, b), (l, r) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
    return F.pad(x, (l, r, t, b))


def logits_variant(params, image, channels_last=False):
    """router_logits with the convs' inputs and weights in channels-last
    layout when asked (the arithmetic is the same)."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = image.permute(0, 3, 1, 2)
    for name in CONVS:
        w = params[name].permute(3, 2, 0, 1).contiguous(memory_format=fmt)
        x = torch.relu(F.conv2d(padded(x).contiguous(memory_format=fmt), w,
                                stride=2))
    mean = x.mean(dim=(2, 3))
    std = torch.sqrt(torch.clamp((x * x).mean(dim=(2, 3)) - mean * mean,
                                 min=0.0))
    return torch.cat([mean, std], dim=-1) @ params["w"] + params["b"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path, default=None,
                    help="also append the JSON lines to this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_router_time: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    router = load_router(str(ROOT / "logs" / "canonical_learn_r4"), device=dev)
    p = router.params
    scene = SyntheticStereoDataset(1, 480, 960, seed=30, max_disp=64.0,
                                   style=WEATHER_STYLES[0], device=dev)
    frame = next(scene.batches(1, False))["left"]
    lines = []

    def emit(rec):
        rec["card"] = smi
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    def timed(what, fn, **extra):
        emit({"what": what, **extra, "ms": cuda_ms(fn, opts.reps),
              "device_ms": device_ms(fn, opts.reps)})

    with torch.inference_mode(), full_fp32():
        ref = router_logits(p, frame)
        scale = float(ref.abs().max())
        timed("router_logits", lambda: router_logits(p, frame))
        # stage by stage, each on the previous stage's output
        x = frame.permute(0, 3, 1, 2)
        for name in CONVS:
            w = p[name].permute(3, 2, 0, 1)
            timed(f"{name} layout + pad", lambda x=x: padded(x),
                  shape=list(x.shape))
            xp = padded(x)
            timed(f"{name} conv", lambda xp=xp, w=w: F.conv2d(xp, w, stride=2),
                  shape=list(xp.shape), cout=w.shape[0])
            z = F.conv2d(xp, w, stride=2)
            timed(f"{name} relu", lambda z=z: torch.relu(z))
            x = torch.relu(z)
        timed("mean/std head", lambda x=x: torch.cat(
            [x.mean(dim=(2, 3)), torch.sqrt(torch.clamp(
                (x * x).mean(dim=(2, 3)) - x.mean(dim=(2, 3)) ** 2, min=0.0))],
            dim=-1) @ p["w"] + p["b"], shape=list(x.shape))
        for cl in (False, True):
            err = float((logits_variant(p, frame, cl) - ref).abs().max())
            if err > 1e-5 * scale:
                raise SystemExit(f"channels_last={cl}: logits off by {err}")
            timed("router_logits, channels_last" if cl else
                  "router_logits, inline", lambda cl=cl: logits_variant(
                      p, frame, cl), max_abs_err=err)
        torch.backends.cudnn.benchmark = True
        for cl in (False, True):
            err = float((logits_variant(p, frame, cl) - ref).abs().max())
            if err > 1e-5 * scale:
                raise SystemExit(f"benchmark, channels_last={cl}: logits "
                                 f"off by {err}")
            timed("router_logits, cudnn.benchmark"
                  + (", channels_last" if cl else ""),
                  lambda cl=cl: logits_variant(p, frame, cl), max_abs_err=err)
        torch.backends.cudnn.benchmark = False

    train = SyntheticStereoDataset(8, 192, 384, seed=10, max_disp=64.0,
                                   style=WEATHER_STYLES[0], device=dev)
    images = next(train.batches(8, True, seed=0))["left"]
    labels = torch.zeros(8, dtype=torch.int64, device=dev)
    step = make_router_train_step(router.optimizer)
    state = [router.params, router.opt_state]

    def train_step():
        state[0], state[1], _ = step(state[0], state[1], images, labels)
    timed("train step, batch 8 of 192x384", train_step)
    if opts.out is not None:
        with opts.out.open("a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
