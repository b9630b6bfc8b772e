#!/usr/bin/env python3
"""The benchmark of rag_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout. The cell's configuration, traffic mix,
limits and per-layer readers are found by the names in BENCHMARK.json
(``harness.spec``). With ``--trace 0`` the last line of standard output
is the cell's end-to-end metrics; with ``--trace 1`` a traced segment
after the window gives its per-layer metrics and a breakdown. Either way
the window's output is checked against the plain reference
(``reference/``) and the numbers compared are printed beside their
limits, on standard error and as the result line's last key.

Exits non-zero with no result where CUDA or the cards the cell asks for
are missing, where the program (``rag_tpu_torch``) is not beside this
directory, or where JAX, flax or the JAX package got imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "rag_tpu"}


def _setup_environment() -> None:
    """Caches at fixed paths inside the checkout; no library may pull in
    flax or JAX by itself."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton-cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch-extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell, seed, seconds, trace, device, scratch, t0):
    """One run of ``cell`` on ``device``: the loop's output and the
    result line (without the device)."""
    from harness import compare, serve, train
    from harness.spec import per_layer_values
    from harness.trace import top

    loop = {"serve": serve.run, "train": train.run}[cell.kind]
    out = loop(cell, seed, seconds, trace, device, t0, scratch)
    correct, checks = compare.verdict(out["numbers"], cell.limits["limits"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        ctx = out["per_layer_ctx"]
        result["metrics"] = per_layer_values(cell, ctx)
        result["breakdown"] = {"device_ops": top(ctx.trace.class_s()),
                               "idle_gaps": top(ctx.trace.idle_gaps())}
    else:
        e2e = out["end_to_end"]
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    return out, result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_environment()
    sys.path.insert(0, str(HERE))

    from harness.spec import load

    cell = load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if not (ROOT / "rag_tpu_torch").is_dir():
        print("[bench] the program, rag_tpu_torch, is not in this checkout",
              file=sys.stderr)
        return 4
    sys.path.insert(0, str(ROOT))
    scratch = os.environ.get("TMPDIR") or str(ROOT / "build")
    os.makedirs(scratch, exist_ok=True)

    out, result, checks = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda", scratch, T_START)
    found = forbidden_modules()
    if found:
        print(f"[bench] forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(out["memory_peak"]),
              "power_limit": power_limit()}
    if args.trace:
        tr = out["per_layer_ctx"].trace
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
    result["device"] = device
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(f"[bench] {args.workload} seed {args.seed} on {device['power_limit']}: "
          f"setup_s {out['end_to_end']['setup_s']:.3f}, window "
          f"{out['window_s']:.3f} s, {out['attempted']} "
          f"{'requests' if cell.kind == 'serve' else 'steps'}, peak "
          f"{device['memory_peak_bytes']} B, check {out['check_s']:.3f} s: "
          f"correct {result['correct']}", file=sys.stderr)
    print(f"[bench] items by sixth of the window: {out['sixths']}",
          file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"[bench] {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
