#!/usr/bin/env python3
"""Time kernel I (rag_tpu_torch resize_taps_cf) at many blockings on one GPU.

    python3 scripts/torch_resize_sweep.py [--out FILE] [--reps N]

For each kernel I call of a 1x480x960 request and of a training step of
task 0's stage (batch 4, 192x384 crops, maxdisp 192), forward and, for
training, adjoint, every blocking of kernel I (each tile of RESIZE_TILES
within RESIZE_MAX_SMEM, with every run of output planes that cuts D2 into
equal runs) is launched on random inputs and timed with CUDA
events through the C entry, with its tables and output made once, so that
the time is the card's and not the wrapper's host work. Each result is
held against the plain version (CONV_RTOL of chip_smoke.py, of max(1,
max |plain|)); the run fails at its end if any disagrees. One JSON line
per blocking goes to --out; the fastest five per shape and
``resize_plan``'s choice go to the standard output, with the card's name
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

from rag_tpu_torch.ops import resize as resize_mod  # noqa: E402

# (x shape, target, transposed, calls): every kernel I call of a request
# (per request) and of a task-0 step (per step)
SERVE = [((1, 64, 12, 160, 320), (32, 80, 160), 2),
         ((1, 32, 24, 80, 160), (16, 40, 80), 3),
         ((1, 64, 12, 160, 320), (16, 40, 80), 1),
         ((1, 16, 48, 40, 80), (32, 80, 160), 1),
         ((1, 16, 24, 40, 80), (32, 80, 160), 1),
         ((1, 32, 12, 80, 160), (64, 160, 320), 1)]
TRAIN = [((4, 64, 12, 64, 128), (32, 32, 64), 2),
         ((4, 32, 24, 32, 64), (16, 16, 32), 3),
         ((4, 64, 12, 64, 128), (16, 16, 32), 1),
         ((4, 16, 48, 16, 32), (32, 32, 64), 1),
         ((4, 16, 24, 16, 32), (32, 32, 64), 1),
         ((4, 32, 12, 32, 64), (64, 64, 128), 1)]
CONV_RTOL = 1e-5


def calls():
    for x, t, n in SERVE:
        yield "serve", x, t, False, n
    for x, t, n in TRAIN:
        yield "train", x, t, False, n
        b, d, c, h, w = x
        yield "train", (b, t[0], c, t[1], t[2]), (d, h, w), True, n


def blockings(shape, target, transposed):
    """Every (tile, run) within RESIZE_MAX_SMEM, with the work resize_plan
    weighs."""
    b, d, c, h, w = shape
    d2 = target[0]
    for qc, rpw in resize_mod.RESIZE_TILES:
        for run in sorted({-(-d2 // n) for n in range(1, d2 + 1)}):
            plan = resize_mod.resize_blocking(
                b, d, c, h, w, *target, True, transposed, qc, rpw, run)
            if plan.smem <= resize_mod.RESIZE_MAX_SMEM:
                yield plan, resize_mod.resize_work(
                    plan, d, h, w, *target, True, transposed)[1]


def time_plan(x, target, transposed, plan, reps):
    b, d, c, h, w = x.shape
    itab, ftab = (torch.from_numpy(t).to(x.device) for t in
                  resize_mod.resize_tables(plan, d, h, w, *target, True,
                                           transposed))
    out = torch.empty((b, target[0], c, *target[1:]), device=x.device)
    for _ in range(2):
        resize_mod.launch_resize(x, itab, ftab, out, plan)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        resize_mod.launch_resize(x, itab, ftab, out, plan)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path("resize_sweep.jsonl"))
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_resize_sweep: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    bad, best_sum, chosen_sum = [], {}, {}
    with opts.out.open("w") as f:
        for where, shape, target, tr, n in calls():
            x = torch.randn(shape, device="cuda", generator=gen)
            ref = resize_mod.resize_taps_plain(x, *target, True, tr)
            tol = CONV_RTOL * max(1.0, float(ref.abs().max()))
            chosen = resize_mod.resize_plan(*shape, *target, True, tr)
            rows = []
            for plan, work in blockings(shape, target, tr):
                ms, out = time_plan(x, target, tr, plan, opts.reps)
                err = float((out - ref).abs().max())
                if not err <= tol:
                    bad.append(f"{shape}->{target} {tr} {plan}: off by "
                               f"{err:.3g} > {tol:.3g}")
                row = {"where": where, "shape": list(shape),
                       "target": list(target), "transposed": tr,
                       "calls": n, "ms": ms, "err": err, "ok": err <= tol,
                       "chosen": plan == chosen, "work": work,
                       **plan._asdict()}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
            rows.sort(key=lambda r: r["ms"])
            best_sum[where] = best_sum.get(where, 0.0) + n * rows[0]["ms"]
            mine = [r for r in rows if r["chosen"]]
            chosen_sum[where] = chosen_sum.get(where, 0.0) + n * (
                mine[0]["ms"] if mine else float("nan"))
            print(f"{where} {shape} -> {target} transposed {tr} ({n} calls), "
                  f"{len(rows)} blockings:", flush=True)
            for r in rows[:5] + mine:
                print(f"  {r['ms']:.4f} ms  tile {r['th']}x{r['tw']} run "
                      f"{r['run']} blocks {r['blocks']} smem {r['smem']} work "
                      f"{r['work']:.0f}"
                      + ("  <- resize_plan" if r["chosen"] else ""),
                      flush=True)
            del x, ref
            torch.cuda.empty_cache()
    for where in best_sum:
        print(f"{where}: sum over calls, fastest blockings "
              f"{best_sum[where]:.4f} ms, resize_plan's {chosen_sum[where]:.4f}"
              " ms", flush=True)
    if bad:
        raise SystemExit("torch_resize_sweep: blockings disagree:\n  "
                         + "\n  ".join(bad))
    return 0


if __name__ == "__main__":
    sys.exit(main())
