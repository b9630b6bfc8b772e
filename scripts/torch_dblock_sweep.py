#!/usr/bin/env python3
"""Time kernel H (rag_tpu_torch conv3d_dblock_cf: kernel A's engine with
four output planes a block) at every db = 4 blocking on one GPU, beside
kernel A's own plan.

    python3 scripts/torch_dblock_sweep.py [--out FILE] [--reps N]

For each 3x3x3 conv call of a 1x480x960 request and of a training step of
task 0's stage (forward and dx; chip_smoke.py's main-path shapes of kernel
A), every plan ``conv_candidates(dblock=True)`` yields (tile, n-tiles a
block and Cout splits, at db = 4) and kernel A's ``conv_plan`` are
launched on random inputs through ``launch_conv`` and timed with CUDA
events. Each result is held against kernel A's (CONV_RTOL of
chip_smoke.py, of max(1, max |A|)); the run fails at its end if any
disagrees. One JSON line per plan goes to --out; the fastest three db = 4
plans per shape, ``conv_plan_dblock``'s and A's go to the standard output,
with the card's name and power limit.
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

# ((x shape), cout, relu): every conv of kernel A's and H's on the main
# path (forward and dx); chip_smoke.py records the same set
SHAPES = [((1, 64, 12, 160, 320), 12), ((1, 64, 12, 160, 320), 1),
          ((1, 64, 4, 160, 320), 4), ((1, 64, 4, 160, 320), 8),
          ((1, 64, 4, 160, 320), 12), ((1, 32, 8, 80, 160), 8),
          ((1, 32, 8, 80, 160), 16), ((1, 32, 8, 80, 160), 24),
          ((1, 16, 16, 40, 80), 16), ((1, 16, 16, 40, 80), 32),
          ((1, 16, 16, 40, 80), 48),
          ((4, 64, 12, 64, 128), 12), ((4, 64, 12, 64, 128), 1),
          ((4, 64, 12, 64, 128), 4), ((4, 64, 4, 64, 128), 4),
          ((4, 64, 4, 64, 128), 8), ((4, 64, 4, 64, 128), 12),
          ((4, 32, 8, 32, 64), 8), ((4, 32, 8, 32, 64), 16),
          ((4, 32, 8, 32, 64), 24), ((4, 16, 16, 16, 32), 16),
          ((4, 16, 16, 16, 32), 32), ((4, 16, 16, 16, 32), 48),
          ((4, 64, 1, 64, 128), 12), ((4, 64, 8, 64, 128), 4),
          ((4, 32, 16, 32, 64), 8), ((4, 32, 24, 32, 64), 8),
          ((4, 16, 32, 16, 32), 16), ((4, 16, 48, 16, 32), 16)]
CONV_RTOL = 1e-5


def time_plan(args, plan, reps):
    def run():
        return conv3d_mod.launch_conv(*args, plan)
    out = run()
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path("dblock_sweep.jsonl"))
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dblock_sweep: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    bad = []
    with opts.out.open("w") as f:
        for shape, cout in SHAPES:
            cin = shape[2]
            args = (torch.randn(shape, device="cuda", generator=gen),
                    0.2 * torch.randn((3, 3, 3, cin, cout), device="cuda",
                                      generator=gen),
                    torch.ones(cout, device="cuda"),
                    torch.zeros(cout, device="cuda"), True)
            a_plan = conv3d_mod.conv_plan(*shape, cout)
            a_ms, ref = time_plan(args, a_plan, opts.reps)
            tol = CONV_RTOL * max(1.0, float(ref.abs().max()))
            chosen = conv3d_mod.conv_plan_dblock(*shape, cout)
            rows = []
            for not_ok, key, plan in conv3d_mod.conv_candidates(
                    *shape, cout, dblock=True):
                ms, out = time_plan(args, plan, opts.reps)
                err = float((out - ref).abs().max())
                if not err <= tol:
                    bad.append(f"{shape}->{cout} {plan}: off by {err:.3g}")
                row = {"shape": list(shape), "cout": cout, "ms": ms,
                       "kernel_a_ms": a_ms, "err": err,
                       "chosen": plan == chosen, "few_blocks": not_ok,
                       "est": key[0], **plan._asdict()}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
            rows.sort(key=lambda r: r["ms"])
            print(f"{shape} -> {cout}: kernel A {a_ms:.4f} ms (mt "
                  f"{a_plan.mt} nt {a_plan.nt} tile {a_plan.th}x{a_plan.tw} "
                  f"split {a_plan.n_split} db {a_plan.db})", flush=True)
            for r in rows[:3] + [r for r in rows if r["chosen"]]:
                print(f"  {r['ms']:.4f} ms  mt {r['mt']} nt {r['nt']} tile "
                      f"{r['th']}x{r['tw']} split {r['n_split']} blocks "
                      f"{r['blocks']} est {r['est']:.3g}"
                      + ("  <- conv_plan_dblock" if r["chosen"] else ""),
                      flush=True)
            del args, ref
            torch.cuda.empty_cache()
    if bad:
        raise SystemExit("torch_dblock_sweep: plans disagree:\n  "
                         + "\n  ".join(bad))
    return 0


if __name__ == "__main__":
    sys.exit(main())
