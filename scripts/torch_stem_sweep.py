#!/usr/bin/env python3
"""Time kernels F (cvstem_dw) and B (cvstem_affine) of rag_tpu_torch at
every blocking their plans weigh, on one GPU.

    python3 scripts/torch_stem_sweep.py [--out FILE] [--reps N]

Kernel F, at its shape in a training step of task 0's stage (features
4x12x64x128, 64 planes, Cout 12): every blocking ``dw_candidates`` yields
for the (4, 64, 24, 64, 128) volume (tile rows and columns, output planes
per block, output channels per block, kh taps per thread), through
``launch_cvstem_dw``, beside kernel D at its own plan on the materialized
volume. Kernel B, at the eval geometry (1x12x160x320, 64 planes) and the
train one: every plan ``cvstem_candidates`` yields (tile, n-tiles and
Cout splits, planes per block, among the compiled instances), through
``launch_cvstem``, beside kernel A at its own plan on the materialized
volume. Random inputs; CUDA events around ``--reps`` launches after two
warm-ups. Each result is held against the first blocking's (chip_smoke.py's
BWD_RTOL of the largest sum of the products' magnitudes for F, CONV_RTOL
of max(1, max |out|) for B); the run fails at its end if any disagrees.
One JSON line per blocking goes to --out; the fastest five per shape and
the plan's choice go to the standard output with the card's name and
power limit.
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
from rag_tpu_torch.ops import cvstem as cvstem_mod  # noqa: E402

C, COUT, ND = 12, 12, 64
F_SHAPE = (4, C, 64, 128)                          # (b, c, h, w)
B_SHAPES = [(1, C, 160, 320), (4, C, 64, 128)]     # eval, train
BWD_RTOL, CONV_RTOL = 1e-4, 1e-5


def cuda_ms(fn, reps):
    out = fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def sweep(f, name, shape, plans, chosen, run, tol, reps, bad, beside):
    """Time run(plan) for every plan; one JSON line each to f; print the
    fastest five and the chosen plan."""
    ref, rows = None, []
    for plan in plans:
        ms, out = cuda_ms(lambda: run(plan), reps)
        if ref is None:
            ref = out.clone()
        err = float((out - ref).abs().max())
        if not err <= tol:
            bad.append(f"{name} {shape} {plan}: off by {err:.3g} > {tol:.3g}")
        row = {"kernel": name, "shape": list(shape), "ms": ms, "err": err,
               "ok": err <= tol, "chosen": plan == chosen, **plan._asdict()}
        rows.append(row)
        f.write(json.dumps(row) + "\n")
    rows.sort(key=lambda r: r["ms"])
    best = rows[0]["ms"]
    mine = next(r["ms"] for r in rows if r["chosen"])
    print(f"{name} {shape}: {len(rows)} blockings, fastest {best:.4f} ms, "
          f"the plan's {mine:.4f} ms ({100 * (mine / best - 1):.1f} % "
          f"slower); {beside}", flush=True)
    for r in rows[:5] + [r for r in rows if r["chosen"]]:
        keys = ("th", "tw", "db", "co_t", "kh_t", "groups", "blocks") \
            if name == "cvstem_dw" else ("mt", "nt", "db", "th", "tw",
                                         "n_split", "blocks")
        print(f"  {r['ms']:.4f} ms  " + " ".join(f"{k} {r[k]}" for k in keys)
              + ("  <- plan" if r["chosen"] else ""), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path("stem_sweep.jsonl"))
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_stem_sweep: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    opts.out.parent.mkdir(parents=True, exist_ok=True)
    bad = []
    with opts.out.open("w") as f:
        b, c, h, w = F_SHAPE
        x, y, dz = randn(b, c, h, w), randn(b, c, h, w), randn(b, ND, COUT,
                                                              h, w)
        mag = cvstem_mod.cvstem_dw_plain(x.abs(), y.abs(), dz.abs(), ND)
        vol = cvstem_mod._volume(x, y, ND).contiguous()
        d_ms, _ = cuda_ms(lambda: conv3d_mod.conv3d_dw_cf(vol, dz), opts.reps)
        sweep(f, "cvstem_dw", (b, ND, 2 * c, h, w),
              list(conv3d_mod.dw_candidates(b, ND, 2 * c, h, w, COUT)),
              cvstem_mod.cvstem_dw_plan(b, ND, c, h, w, COUT),
              lambda p: cvstem_mod.launch_cvstem_dw(x, y, dz, p),
              BWD_RTOL * float(mag.max()), opts.reps, bad,
              f"kernel D on the volume {d_ms:.4f} ms")
        del x, y, dz, mag, vol
        for b, c, h, w in B_SHAPES:
            x, y = randn(b, c, h, w), randn(b, c, h, w)
            w3 = randn(3, 3, 3, 2 * c, COUT) * 0.2
            scale, bias = randn(COUT) * 0.3 + 1.0, randn(COUT) * 0.1
            vol = cvstem_mod._volume(x, y, ND).contiguous()
            a_ms, ref = cuda_ms(lambda: conv3d_mod.conv3d_affine_cf(
                vol, w3, scale, bias, True), opts.reps)
            sweep(f, "cvstem_brc", (b, ND, 2 * c, h, w),
                  [p for _, _, p in cvstem_mod.cvstem_candidates(
                      b, ND, c, h, w, COUT)],
                  cvstem_mod.cvstem_plan(b, ND, c, h, w, COUT),
                  lambda p: cvstem_mod.launch_cvstem(x, y, w3, scale, bias,
                                                     ND, True, p),
                  CONV_RTOL * max(1.0, float(ref.abs().max())), opts.reps,
                  bad, f"kernel A on the volume {a_ms:.4f} ms")
            del x, y, vol, ref
            torch.cuda.empty_cache()
    if bad:
        raise SystemExit("torch_stem_sweep: blockings disagree:\n  "
                         + "\n  ".join(bad))
    return 0


if __name__ == "__main__":
    sys.exit(main())
