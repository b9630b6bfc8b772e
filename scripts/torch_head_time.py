#!/usr/bin/env python3
"""Time kernels C and G (csrc/disp_head.cu) at the main path's shapes.

    python3 scripts/torch_head_time.py [--reps N] [--out FILE]

On one NVIDIA GPU: kernel C at the eval geometry (1, 64, 160, 320) and the
train shape (4, 64, 64, 128), maxdisp 192, and kernel G at the train shape,
whole and with its two passes apart. Each call goes through the wrappers' launch functions on random
inputs (the work does not depend on the values); times are CUDA-event
means over --reps launches after two warm-up launches, and each kernel's
device time per call from torch.profiler (free of host launch time). Each result is
held against the plain version first (C within 1e-3 px, G within 1e-4 of
max |dx|), and printed as one JSON line with the card's name and power
limit. Needs nvcc and a CUDA build of torch; builds the kernels into
build/ at first use.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rag_tpu_torch.ops import disparity as disp  # noqa: E402

MAXDISP = 192


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
    """Device time per call of each kernel fn launches, in ms, from
    torch.profiler over reps calls (free of the host's launch time)."""
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
        name = re.sub(r"<.*", "", e.key.split("::")[-1].split("(")[0])
        out[name] = out.get(name, 0.0) + t / 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path, default=None,
                    help="also append the JSON lines to this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_head_time: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lines = []

    def emit(rec):
        rec["card"] = smi
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    for shape in [(1, 64, 160, 320), (4, 64, 64, 128)]:
        x = torch.from_numpy((rng.standard_normal(shape) * 3)
                             .astype(np.float32)).to(dev)
        out = disp.soft_argmin_fwd(x, MAXDISP)
        err = float((out - disp.soft_argmin_disparity(x, MAXDISP)).abs().max())
        if err > 1e-3:
            raise SystemExit(f"kernel C off by {err} at {shape}")
        emit({"kernel": "C", "shape": shape, "max_abs_err": err,
              "instance": disp.head_plan(*shape, MAXDISP).instance,
              "ms": cuda_ms(lambda: disp.soft_argmin_fwd(x, MAXDISP),
                            opts.reps),
              "device_ms": device_ms(lambda: disp.soft_argmin_fwd(x, MAXDISP),
                                     opts.reps)})

    shape = (4, 64, 64, 128)
    x = torch.from_numpy((rng.standard_normal(shape) * 3)
                         .astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((4, 192, 384))
                         .astype(np.float32)).to(dev)
    ref = disp.soft_argmin_bwd_plain(x, g, MAXDISP)
    plan = disp.head_bwd_plan(*shape, MAXDISP)
    dx = disp.launch_head_bwd(x, g, MAXDISP, plan)
    err = float((dx - ref).abs().max()) / float(ref.abs().max())
    if err > 1e-4:
        raise SystemExit(f"kernel G off by {err} (of max |dx|)")
    same = torch.equal(dx, disp.launch_head_bwd(x, g, MAXDISP, plan))
    emit({"kernel": "G", "shape": shape, "instance": plan.instance,
          "rel_err": err, "repeat_bit_identical": same,
          "ms": cuda_ms(lambda: disp.launch_head_bwd(x, g, MAXDISP, plan),
                        opts.reps),
          "fold_ms": cuda_ms(lambda: disp.launch_head_bwd(
              x, g, MAXDISP, plan, 1), opts.reps),
          "gather_ms": cuda_ms(lambda: disp.launch_head_bwd(
              x, g, MAXDISP, plan, 2), opts.reps),
          "device_ms": device_ms(lambda: disp.launch_head_bwd(
              x, g, MAXDISP, plan), opts.reps)})
    if opts.out is not None:
        with opts.out.open("a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
