#!/usr/bin/env python3
"""The readings that set a cell's correctness limits, on the card, in one
process:

    python3 benchmark/calibrate.py --workload NAME --seeds S1,S2,... \\
        [--control-seeds S1,S2,S3] [--seconds 2] [--out FILE]

For every seed, a short run of the cell through its timed path and the
numbers its check compares (the program against the plain reference).
For each control seed also the control, the reference computed in TF32
put in the program's place; for a training cell also the fault of half
the batch left out, planted in the reference (a step that leaves its state
unchanged reads 1 by the delta measure and needs no run). Prints, per
number, the largest sound reading (the lower one) and the smallest
control or fault reading (the upper one); writes every reading to
``--out``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT))


def _half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import compare, serve, train
    from harness.spec import load

    if not torch.cuda.is_available():
        print("[calibrate] no CUDA device", file=sys.stderr)
        return 3
    cell = load(args.workload)
    scratch = os.environ.get("TMPDIR") or str(ROOT / "build")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    readings = {"program": {}, "control": {}, "half_batch": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run_cell = serve.run if cell.kind == "serve" else train.run
        out = run_cell(cell, seed, args.seconds, False, "cuda", t0, scratch)
        readings["program"][seed] = out["numbers"]
        line = {"seed": seed, "program": out["numbers"]}
        if cell.kind == "train":
            line["worst_leaves"] = compare.worst_leaves(
                out["prog"], out["ref"], out["p0"],
                cell.config["hyper"]["weight_decay"])
        if seed in controls and cell.kind == "serve":
            ref = serve.reference_outputs(cell.config, out["pool"],
                                          out["samples"], "cuda")
            tf32 = serve.reference_outputs(cell.config, out["pool"],
                                           out["samples"], "cuda", tf32=True)
            readings["control"][seed] = line["control"] = serve.numbers(tf32, ref)
        elif seed in controls:
            cfg, task = cell.config, cell.traffic["task"]
            wd = cfg["hyper"]["weight_decay"]
            ref, s0 = out["ref"], out["s0_ref"]
            for name, batches, tf32 in (
                    ("control", out["batches"], True),
                    ("half_batch", [_half(b) for b in out["batches"]], False)):
                other, _ = train.reference_steps(cfg, task, batches, "cuda",
                                                 tf32)
                readings[name][seed] = line[name] = compare.train_numbers(
                    train.as_program(other, out["p0"], wd), ref, out["p0"],
                    s0, s0, wd)
        line["seconds"] = time.perf_counter() - t0
        print("[calibrate] " + json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()

    names = sorted(next(iter(readings["program"].values())))
    summary = {}
    for name in names:
        lower = max(r[name] for r in readings["program"].values())
        uppers = [r[name] for kind in ("control", "half_batch")
                  for r in readings[kind].values()]
        summary[name] = {"lower": lower,
                         "upper": min(uppers) if uppers else None}
    print("[calibrate] summary " + json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "readings": readings,
             "summary": summary}, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
