#!/usr/bin/env python3
"""Time kernel D (rag_tpu_torch conv3d_dw_cf) at many blockings on one GPU.

    python3 scripts/torch_dw_sweep.py [--out FILE] [--reps N]

For each kernel D call of one training step of task 0's stage (batch 4,
192x384 crops, maxdisp 192: the five shapes below), every blocking
``dw_candidates`` yields (tile rows and columns, output planes per block,
output channels per block, kh taps per thread) within the limits
is launched on random inputs and timed with CUDA events, both passes,
through the C entry with the buffers allocated once, so that the time is
the card's and not the wrapper's host work. Each result is held against
the first blocking's (BWD_RTOL of chip_smoke.py, of the largest sum of
the products' magnitudes); the run fails at its end if any disagrees.
One JSON line per blocking goes to --out, and the fastest five per shape
and ``dw_plan``'s choice go to the standard output with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rag_tpu_torch.ops import conv3d as conv3d_mod  # noqa: E402
from rag_tpu_torch.ops import cuda_lib  # noqa: E402

# (x shape, cout): every kernel D call of a task-0 step, with its count
SHAPES = [((4, 64, 4, 64, 128), 4, 9), ((4, 64, 12, 64, 128), 12, 1),
          ((4, 64, 12, 64, 128), 1, 1), ((4, 32, 8, 32, 64), 8, 6),
          ((4, 16, 16, 16, 32), 16, 9)]
BWD_RTOL = 1e-4


def launch(x, dz, part, out, plan, stream):
    b, d, cin, h, w = x.shape
    rc = cuda_lib.lib().rag_conv3d_dw_cf(
        x.data_ptr(), dz.data_ptr(), part.data_ptr(), out.data_ptr(), b, d,
        cin, dz.shape[2], h, w, plan.ci, plan.co_t, plan.kh_t, plan.groups,
        plan.th, plan.tw, plan.db, 3, stream)
    cuda_lib.check(rc, "conv3d_dw_cf")


def time_plan(x, dz, plan, reps):
    part = torch.empty(plan.workspace, device=x.device)
    out = torch.empty((3, 3, 3, x.shape[2], dz.shape[2]), device=x.device)
    stream = cuda_lib.stream_ptr(x)
    for _ in range(2):
        launch(x, dz, part, out, plan, stream)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch(x, dz, part, out, plan, stream)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path("dw_sweep.jsonl"))
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dw_sweep: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    bad = []
    with opts.out.open("w") as f:
        for shape, cout, calls in SHAPES:
            b, d, cin, h, w = shape
            x = torch.randn(shape, device="cuda", generator=gen)
            dz = torch.randn((b, d, cout, h, w), device="cuda", generator=gen)
            mag = conv3d_mod.conv3d_dw_cf_plain(x.abs(), dz.abs())
            tol = BWD_RTOL * float(mag.max())
            chosen = conv3d_mod.dw_plan(*shape, cout)
            ref, rows = None, []
            for plan in conv3d_mod.dw_candidates(*shape, cout):
                ms, out = time_plan(x, dz, plan, opts.reps)
                if ref is None:
                    ref = out.clone()
                err = float((out - ref).abs().max())
                if not err <= tol:
                    bad.append(f"{shape}->{cout} {plan}: off by {err:.3g} "
                               f"> {tol:.3g}")
                row = {"shape": list(shape), "cout": cout, "calls": calls,
                       "ms": ms, "err": err, "ok": err <= tol,
                       "chosen": plan == chosen,
                       "est_us": conv3d_mod._dw_cost_us(plan),
                       **plan._asdict()}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
            rows.sort(key=lambda r: r["ms"])
            print(f"{shape} -> {cout} ({calls} calls a step), "
                  f"{len(rows)} blockings:", flush=True)
            for r in rows[:5] + [r for r in rows if r["chosen"]]:
                print(f"  {r['ms']:.4f} ms  th {r['th']} tw {r['tw']} db "
                      f"{r['db']} co_t {r['co_t']} kh_t {r['kh_t']} groups "
                      f"{r['groups']} "
                      f"blocks {r['blocks']} est {r['est_us']:.0f} us"
                      + ("  <- dw_plan" if r["chosen"] else ""), flush=True)
            del x, dz, mag
            torch.cuda.empty_cache()
    if bad:
        raise SystemExit("torch_dw_sweep: blockings disagree:\n  "
                         + "\n  ".join(bad))
    return 0


if __name__ == "__main__":
    sys.exit(main())
